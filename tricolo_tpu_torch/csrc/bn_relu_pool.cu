// BatchNorm -> ReLU [-> zero] -> MaxPool(2^3), channels-last: masked eval
// and the unmasked (all-site) form.
//
// Replaces: tricolo_tpu/ops/fused_bn_pool.py::_fwd_kernel (the Pallas TPU
// kernel: folded per-channel BN, ReLU, 2^3 window max and first-argmax
// index). The unmasked entry (zero_mask == nullptr) is that kernel's own
// function, which the JAX package runs through Pallas at masked_bn=false,
// fused_bn_pool=true (fused_bn_relu_pool, with idx) and in XLA otherwise
// (hybrid_bn_relu_pool, inference_bn_relu_pool). The masked entry extends it
// to the masked eval forms the masked voxel encoder runs in all five blocks:
// masked_inference_bn_relu_pool2 (two masks, block 1) and
// masked_inference_bn_relu_pool (one mask, blocks 2-5).
//
//   a       = relu(y * mul + add) [* zero_mask]       (per site, per channel)
//   pooled  = max over each 2x2x2 window of a
//   pmask   = max over each 2x2x2 window of stats_mask (masked entry only)
//   idx     = first r = dd*4 + hh*2 + ww reaching the max (strict >)
//
// Bound: memory. Per pooled element it reads 8 activations and writes one;
// there are ~4 flops per activation, far below the ~295 flop/byte where the
// H100 stops being bandwidth-bound. The least time is
// (bytes of y [+ masks] + pooled [+ pooled mask] [+ idx]) / 3.35 TB/s (H100
// SXM data sheet): at the unmasked flagship block 1, (128, 64^3, 32) bf16,
// 2.416 GB without idx (0.721 ms) and 2.550 GB with it (0.761 ms).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// 128 threads a block: in a trial of 32 to 512 on an H100 80GB HBM3 at
// 700 W, 64 and 128 were the fastest at every flagship shape (PERF.md).
constexpr int kThreads = 128;

template <int BYTES>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = uint32_t; };
template <>
struct Raw<2> { using type = uint16_t; };
template <>
struct Raw<1> { using type = uint8_t; };

struct F32 {
  using Bits = uint32_t;
  __device__ static float load(Bits v) { return __uint_as_float(v); }
  __device__ static float round(float v) { return v; }
  __device__ static Bits store(float v) { return __float_as_uint(v); }
};

struct BF16 {
  using Bits = uint16_t;
  __device__ static float load(Bits v) { return __uint_as_float((uint32_t)v << 16); }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static Bits store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// VE consecutive elements at p, as one vector load.
template <typename Bits, int VE>
__device__ inline void load_vec(const Bits* __restrict__ p, Bits (&out)[VE]) {
  using Vec = typename Raw<sizeof(Bits) * VE>::type;
  const Vec raw = *reinterpret_cast<const Vec*>(p);
  memcpy(out, &raw, sizeof(raw));
}

template <typename Bits, int VE>
__device__ inline void store_vec(Bits* __restrict__ p, const Bits (&in)[VE]) {
  using Vec = typename Raw<sizeof(Bits) * VE>::type;
  Vec raw;
  memcpy(&raw, in, sizeof(raw));
  *reinterpret_cast<Vec*>(p) = raw;
}

template <typename Num, int VE, bool kMasked>
__global__ void __launch_bounds__(kThreads)
    bn_relu_pool_kernel(const typename Num::Bits* __restrict__ y,
                        const typename Num::Bits* __restrict__ mul,
                        const typename Num::Bits* __restrict__ add,
                        const typename Num::Bits* zero_mask,
                        const typename Num::Bits* stats_mask,
                        typename Num::Bits* __restrict__ pooled,
                        typename Num::Bits* __restrict__ pooled_mask,
                        uint8_t* __restrict__ idx, int items, int groups,
                        int H2, int W2, int C) {
  using Bits = typename Num::Bits;
  const int W = 2 * W2, HW = 4 * H2 * W2;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x) {
    const int p = i / groups;  // pooled site
    const int c0 = (i - p * groups) * VE;
    const int w2 = p % W2;
    const int q = p / W2;
    const int h2 = q % H2;
    const int nd = q / H2;  // n*D2 + d2: the window's first plane is 2*nd
    const int site0 = 2 * nd * HW + 2 * h2 * W + 2 * w2;
    Bits raw_m[VE], raw_b[VE];
    load_vec<Bits, VE>(mul + c0, raw_m);
    load_vec<Bits, VE>(add + c0, raw_b);
    float m[VE], b[VE], best[VE];
    uint8_t arg[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      m[e] = Num::load(raw_m[e]);
      b[e] = Num::load(raw_b[e]);
      best[e] = 0.f;
      arg[e] = 0;
    }
    float zm[8] = {};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int site = site0 + (r >> 2) * HW + ((r >> 1) & 1) * W + (r & 1);
      if constexpr (kMasked) zm[r] = Num::load(zero_mask[site]);
      Bits v[VE];
      load_vec<Bits, VE>(y + (int64_t)site * C + c0, v);
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        float t = Num::round(__fmul_rn(Num::load(v[e]), m[e]));
        t = Num::round(__fadd_rn(t, b[e]));
        t = t > 0.f ? t : 0.f;
        if constexpr (kMasked) t = Num::round(__fmul_rn(t, zm[r]));
        if (r == 0 || t > best[e]) {  // strict >: the first max wins
          best[e] = t;
          arg[e] = (uint8_t)r;
        }
      }
    }
    Bits out[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) out[e] = Num::store(best[e]);
    const int64_t o = (int64_t)p * C + c0;
    store_vec<Bits, VE>(pooled + o, out);
    if (idx != nullptr) {
      using IdxVec = typename Raw<VE>::type;
      IdxVec packed;
      memcpy(&packed, arg, sizeof(packed));
      *reinterpret_cast<IdxVec*>(idx + o) = packed;
    }
    if (kMasked && c0 == 0) {  // one thread a site: the pooled mask
      float mbest = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float s = zm[r];
        if (stats_mask != zero_mask) {
          s = Num::load(stats_mask[site0 + (r >> 2) * HW + ((r >> 1) & 1) * W +
                                   (r & 1)]);
        }
        mbest = (r == 0 || s > mbest) ? s : mbest;
      }
      pooled_mask[p] = Num::store(mbest);
    }
  }
}

template <typename Num, int VE>
int launch_ve(const void* y, const void* mul, const void* add,
              const void* zero_mask, const void* stats_mask, void* pooled,
              void* pooled_mask, void* idx, int items, int H2, int W2, int C,
              cudaStream_t stream) {
  using Bits = typename Num::Bits;
  const int want = (items + kThreads - 1) / kThreads;
  const int blocks = want < (1 << 30) ? want : (1 << 30);
  if (zero_mask != nullptr) {
    bn_relu_pool_kernel<Num, VE, true><<<blocks, kThreads, 0, stream>>>(
        (const Bits*)y, (const Bits*)mul, (const Bits*)add,
        (const Bits*)zero_mask, (const Bits*)stats_mask, (Bits*)pooled,
        (Bits*)pooled_mask, (uint8_t*)idx, items, C / VE, H2, W2, C);
  } else {
    bn_relu_pool_kernel<Num, VE, false><<<blocks, kThreads, 0, stream>>>(
        (const Bits*)y, (const Bits*)mul, (const Bits*)add, nullptr, nullptr,
        (Bits*)pooled, nullptr, (uint8_t*)idx, items, C / VE, H2, W2, C);
  }
  return (int)cudaGetLastError();
}

// vec_elems: channels a thread handles (VE): 8, 4, 2 or 1 in bf16, 4, 2 or
// 1 in f32, a divisor of C whose VE * elem bytes divide the alignment of y,
// mul, add, pooled and idx. zero_mask == nullptr selects the unmasked entry:
// stats_mask and pooled_mask are then nullptr too.
template <typename Num>
int launch(const void* y, const void* mul, const void* add,
           const void* zero_mask, const void* stats_mask, void* pooled,
           void* pooled_mask, void* idx, long long N, int D2, int H2, int W2,
           int C, int vec_elems, void* stream) {
  if (vec_elems <= 0 || C % vec_elems != 0) return (int)cudaErrorInvalidValue;
  if ((zero_mask == nullptr) != (stats_mask == nullptr) ||
      (zero_mask == nullptr) != (pooled_mask == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t pooled_sites = (int64_t)N * D2 * H2 * W2;
  const int64_t items = pooled_sites * (C / vec_elems);
  if (8 * pooled_sites >= (1LL << 31) || items >= (1LL << 31))
    return (int)cudaErrorInvalidValue;  // the 32-bit site math would wrap
  if (items == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = (int)items;
  constexpr bool kF32 = sizeof(typename Num::Bits) == 4;
  switch (vec_elems) {
    case 8:
      if constexpr (!kF32)
        return launch_ve<Num, 8>(y, mul, add, zero_mask, stats_mask, pooled,
                                 pooled_mask, idx, n, H2, W2, C, st);
      break;
    case 4:
      return launch_ve<Num, 4>(y, mul, add, zero_mask, stats_mask, pooled,
                               pooled_mask, idx, n, H2, W2, C, st);
    case 2:
      return launch_ve<Num, 2>(y, mul, add, zero_mask, stats_mask, pooled,
                               pooled_mask, idx, n, H2, W2, C, st);
    case 1:
      return launch_ve<Num, 1>(y, mul, add, zero_mask, stats_mask, pooled,
                               pooled_mask, idx, n, H2, W2, C, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int bn_relu_pool_f32(const void* y, const void* mul,
                                const void* add, const void* zero_mask,
                                const void* stats_mask, void* pooled,
                                void* pooled_mask, void* idx, long long N,
                                int D2, int H2, int W2, int C, int vec_elems,
                                void* stream) {
  return launch<F32>(y, mul, add, zero_mask, stats_mask, pooled, pooled_mask,
                     idx, N, D2, H2, W2, C, vec_elems, stream);
}

extern "C" int bn_relu_pool_bf16(const void* y, const void* mul,
                                 const void* add, const void* zero_mask,
                                 const void* stats_mask, void* pooled,
                                 void* pooled_mask, void* idx, long long N,
                                 int D2, int H2, int W2, int C, int vec_elems,
                                 void* stream) {
  return launch<BF16>(y, mul, add, zero_mask, stats_mask, pooled, pooled_mask,
                      idx, N, D2, H2, W2, C, vec_elems, stream);
}
