// Train BatchNorm -> ReLU [-> zero] -> MaxPool(2^3) backward, the
// full-resolution pass, channels-last: masked and unmasked (all-site).
//
// Replaces: tricolo_tpu/ops/fused_bn_pool.py::_dy_kernel (the Pallas TPU
// kernel: dy = select(idx == r, ga', B) + C * zhat per window member r).
// The unmasked entry (stats_mask == nullptr) is that kernel's function, the
// backward of fused_bn_relu_pool and of hybrid_bn_relu_pool (masked_bn=false).
// The masked entry is the form the masked voxel encoder trains with: the dy
// line of _masked_hybrid2_bwd (two masks, block 1) and _masked_hybrid_bwd
// (one mask, blocks 2-5), which the JAX package leaves to XLA.
//
//   zhat = y * invstd - mean * invstd                         (f32)
//   dy   = route(ga by idx) + (B + C * zhat) [* stats_mask]   (f32, one cast)
//
// where route puts each pooled cell's ga at its window's first argmax
// r = dd*4 + hh*2 + ww (the uint8 idx that K1 writes with want_idx) and 0
// at the other seven members. One formula covers both masked JAX forms: in
// the single-mask blocks stats_mask is the mask, and a routed site is always
// live under the zero mask, because its activation is > 0 there. The
// unmasked entry is the same kernel compiled without the mask (kMasked =
// false): no mask load and no mask product (a product by 1 changes no f32
// value, so it equals the masked formula at an all-ones mask bit for bit).
// Rounding follows the JAX hybrid path (_hybrid_bwd: f32, one cast), not the
// Pallas kernel, which rounds ga' and zhat to the input dtype: in bf16 the
// two JAX paths differ by up to one bf16 ulp of dy, and so does this kernel
// from the Pallas one. The products and sums are written with __fmul_rn,
// __fsub_rn and __fadd_rn so that nvcc contracts none of them into an FMA.
//
// Bound: memory. Per element it reads y, 1/8 of ga and idx, 1/C of the mask,
// and writes dy; ~8 flops per element, far below the ~295 flop/byte where
// the H100 stops being bandwidth-bound. The least time is
// (bytes of y + ga + idx [+ stats_mask] + dy) / 3.35 TB/s: at the unmasked
// flagship block 1, (128, 64^3, 32) bf16, 4.697 GB (1.402 ms).
//
// Design, K1's (bn_relu_pool.cu) turned around: one thread per pooled cell
// and vector of VE channels (8 bf16 or 4 f32 = 16 bytes where C and the
// addresses allow; the wrapper's launch plan picks VE), writing all eight
// window members. The earlier design ran a thread per full-resolution site
// and 4 channels. Its SASS (kernel_timing.py --sass, bf16, 32-bit form) held
// four integer-division sequences to decode the site, 17 scalar loads (the
// four per-channel vectors and the mask) and 8-byte loads of y, ga and
// stores of dy, ~400 instructions for 8 bytes of dy: it issued
// instructions rather than moved bytes, at ~55-58% of the bound. Here a thread decodes its
// pooled cell once, by multiply-high with divisors prepared on the host (no
// division on the device in the 32-bit form), loads ga and idx once, the
// four f32 vectors once as 16-byte vectors, then all eight members' y (and
// mask) before it computes and stores, so eight 16-byte loads are in flight
// a thread: 800 instructions, 96 registers, for 128 bytes of dy. The member
// loop is unrolled, so idx == r compares with a constant. Neighbouring
// threads cover neighbouring channel vectors of one pooled cell, then the
// next cell: a warp's loads and stores of one member cover whole 32-byte
// sectors (C*elem >= 32 bytes, every flagship block), and the lanes of one
// cell read ga, idx and the mask as broadcasts. VE = 8 was the fastest
// plan at every bf16 block 3-5 shape of a trial of 8, 4 and 2 (more threads
// do not help the small grids). Index math is 32-bit when the sites and
// threads stay below 2^31 (every flagship shape), 64-bit with a
// grid-stride loop otherwise (the wrapper decides).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

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
  __device__ static Bits store(float v) { return __float_as_uint(v); }
};

struct BF16 {
  using Bits = uint16_t;
  __device__ static float load(Bits v) { return __uint_as_float((uint32_t)v << 16); }
  __device__ static Bits store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// N consecutive values at p, as vectors of at most 16 bytes.
template <typename Bits, int N>
__device__ inline void load_vec(const Bits* __restrict__ p, Bits (&out)[N]) {
  constexpr int kBytes = sizeof(Bits) * N;
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  using Vec = typename Raw<kChunk>::type;
#pragma unroll
  for (int k = 0; k < kBytes / kChunk; ++k) {
    const Vec raw = reinterpret_cast<const Vec*>(p)[k];
    memcpy(reinterpret_cast<char*>(out) + k * kChunk, &raw, kChunk);
  }
}

template <typename Bits, int N>
__device__ inline void store_vec(Bits* __restrict__ p, const Bits (&in)[N]) {
  using Vec = typename Raw<sizeof(Bits) * N>::type;
  Vec raw;
  memcpy(&raw, in, sizeof(raw));
  *reinterpret_cast<Vec*>(p) = raw;
}

// n / d by multiply-high (Granlund-Montgomery): exact for 0 <= n < 2^31
// and 1 <= d < 2^31. The 64-bit form divides.
struct Div {
  uint32_t d, mul, shift;
};

Div make_div(uint32_t d) {
  uint32_t shift = 0;
  while ((1ull << shift) < d) ++shift;
  const uint32_t mul = (uint32_t)(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  return {d, mul, shift};
}

__device__ inline int divide(int n, Div v) {
  return (int)((__umulhi((uint32_t)n, v.mul) + (uint32_t)n) >> v.shift);
}

__device__ inline long long divide(long long n, Div v) { return n / (long long)v.d; }

template <typename Num, int VE, typename I, bool kMasked>
__global__ void __launch_bounds__(kThreads)
    bn_relu_pool_bwd_kernel(const typename Num::Bits* __restrict__ y,
                            const typename Num::Bits* __restrict__ ga,
                            const uint8_t* __restrict__ idx,
                            const typename Num::Bits* __restrict__ stats_mask,
                            const float* __restrict__ bcoef,
                            const float* __restrict__ ccoef,
                            const float* __restrict__ inv,
                            const float* __restrict__ sub,
                            typename Num::Bits* __restrict__ dy, I items,
                            Div groups, Div W2, Div H2, int C) {
  using Bits = typename Num::Bits;
  const I W = 2 * (I)W2.d, HW = 4 * (I)H2.d * (I)W2.d;
  for (I i = blockIdx.x * (I)blockDim.x + threadIdx.x; i < items;
       i += (I)gridDim.x * blockDim.x) {
    const I p = divide(i, groups);  // pooled cell
    const int c0 = (int)(i - p * (I)groups.d) * VE;
    const I q = divide(p, W2);
    const I nd = divide(q, H2);  // n*D2 + d2: the window's first plane is 2*nd
    const I w2 = p - q * (I)W2.d, h2 = q - nd * (I)H2.d;
    const I site0 = 2 * nd * HW + 2 * h2 * W + 2 * w2;

    Bits raw_g[VE];
    uint8_t arg[VE];
    load_vec<Bits, VE>(ga + (int64_t)p * C + c0, raw_g);
    load_vec<uint8_t, VE>(idx + (int64_t)p * C + c0, arg);
    float bc[VE], cc[VE], iv[VE], sb[VE];
    load_vec<float, VE>(bcoef + c0, bc);
    load_vec<float, VE>(ccoef + c0, cc);
    load_vec<float, VE>(inv + c0, iv);
    load_vec<float, VE>(sub + c0, sb);

    Bits v[8][VE];
    float m[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const I site = site0 + (r >> 2) * HW + ((r >> 1) & 1) * W + (r & 1);
      load_vec<Bits, VE>(y + (int64_t)site * C + c0, v[r]);
      m[r] = 1.f;
      if constexpr (kMasked) m[r] = Num::load(stats_mask[site]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const I site = site0 + (r >> 2) * HW + ((r >> 1) & 1) * W + (r & 1);
      Bits out[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float routed = arg[e] == r ? Num::load(raw_g[e]) : 0.f;
        const float z = __fsub_rn(__fmul_rn(Num::load(v[r][e]), iv[e]), sb[e]);
        float t = __fadd_rn(bc[e], __fmul_rn(cc[e], z));
        if constexpr (kMasked) t = __fmul_rn(t, m[r]);
        out[e] = Num::store(__fadd_rn(routed, t));
      }
      store_vec<Bits, VE>(dy + (int64_t)site * C + c0, out);
    }
  }
}

template <typename Num, int VE, typename I>
int launch_typed(const void* y, const void* ga, const void* idx,
                 const void* stats_mask, const void* bcoef, const void* ccoef,
                 const void* inv, const void* sub, void* dy, long long items,
                 int H2, int W2, int C, cudaStream_t stream) {
  using Bits = typename Num::Bits;
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (1 << 30) ? want : (1 << 30));
  const Div groups = make_div(C / VE), w2 = make_div(W2), h2 = make_div(H2);
  if (stats_mask != nullptr) {
    bn_relu_pool_bwd_kernel<Num, VE, I, true><<<blocks, kThreads, 0, stream>>>(
        (const Bits*)y, (const Bits*)ga, (const uint8_t*)idx,
        (const Bits*)stats_mask, (const float*)bcoef, (const float*)ccoef,
        (const float*)inv, (const float*)sub, (Bits*)dy, (I)items, groups, w2,
        h2, C);
  } else {
    bn_relu_pool_bwd_kernel<Num, VE, I, false><<<blocks, kThreads, 0, stream>>>(
        (const Bits*)y, (const Bits*)ga, (const uint8_t*)idx, nullptr,
        (const float*)bcoef, (const float*)ccoef, (const float*)inv,
        (const float*)sub, (Bits*)dy, (I)items, groups, w2, h2, C);
  }
  return (int)cudaGetLastError();
}

template <typename Num, int VE>
int launch_ve(const void* y, const void* ga, const void* idx,
              const void* stats_mask, const void* bcoef, const void* ccoef,
              const void* inv, const void* sub, void* dy, long long items,
              int H2, int W2, int C, int wide, cudaStream_t stream) {
  if (wide)
    return launch_typed<Num, VE, long long>(y, ga, idx, stats_mask, bcoef,
                                            ccoef, inv, sub, dy, items, H2, W2,
                                            C, stream);
  return launch_typed<Num, VE, int>(y, ga, idx, stats_mask, bcoef, ccoef, inv,
                                    sub, dy, items, H2, W2, C, stream);
}

// vec_elems: channels a thread (VE): 8, 4, 2 or 1 in bf16, 4, 2 or 1 in
// f32, a divisor of C whose VE * elem bytes divide the alignment of y, ga
// and dy, VE bytes that of idx, and min(16, 4 * VE) bytes that of the four
// f32 vectors. wide != 0 selects 64-bit index math; without it the pooled
// sites times 8 and the threads must stay below 2^31. stats_mask ==
// nullptr selects the unmasked entry.
template <typename Num>
int launch(const void* y, const void* ga, const void* idx,
           const void* stats_mask, const void* bcoef, const void* ccoef,
           const void* inv, const void* sub, void* dy, long long N, int D2,
           int H2, int W2, int C, int vec_elems, int wide, void* stream) {
  if (vec_elems <= 0 || C <= 0 || C % vec_elems != 0)
    return (int)cudaErrorInvalidValue;
  const long long pooled_sites = N * D2 * H2 * W2;
  const long long items = pooled_sites * (C / vec_elems);
  if (!wide && (8 * pooled_sites >= (1LL << 31) || items >= (1LL << 31)))
    return (int)cudaErrorInvalidValue;  // the 32-bit index math would wrap
  if (items == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  constexpr bool kF32 = sizeof(typename Num::Bits) == 4;
  switch (vec_elems) {
    case 8:
      if constexpr (!kF32)
        return launch_ve<Num, 8>(y, ga, idx, stats_mask, bcoef, ccoef, inv,
                                 sub, dy, items, H2, W2, C, wide, st);
      break;
    case 4:
      return launch_ve<Num, 4>(y, ga, idx, stats_mask, bcoef, ccoef, inv, sub,
                               dy, items, H2, W2, C, wide, st);
    case 2:
      return launch_ve<Num, 2>(y, ga, idx, stats_mask, bcoef, ccoef, inv, sub,
                               dy, items, H2, W2, C, wide, st);
    case 1:
      return launch_ve<Num, 1>(y, ga, idx, stats_mask, bcoef, ccoef, inv, sub,
                               dy, items, H2, W2, C, wide, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int bn_relu_pool_bwd_f32(const void* y, const void* ga,
                                    const void* idx, const void* stats_mask,
                                    const void* bcoef, const void* ccoef,
                                    const void* inv, const void* sub, void* dy,
                                    long long N, int D2, int H2, int W2, int C,
                                    int vec_elems, int wide, void* stream) {
  return launch<F32>(y, ga, idx, stats_mask, bcoef, ccoef, inv, sub, dy, N,
                     D2, H2, W2, C, vec_elems, wide, stream);
}

extern "C" int bn_relu_pool_bwd_bf16(const void* y, const void* ga,
                                     const void* idx, const void* stats_mask,
                                     const void* bcoef, const void* ccoef,
                                     const void* inv, const void* sub, void* dy,
                                     long long N, int D2, int H2, int W2,
                                     int C, int vec_elems, int wide,
                                     void* stream) {
  return launch<BF16>(y, ga, idx, stats_mask, bcoef, ccoef, inv, sub, dy, N,
                      D2, H2, W2, C, vec_elems, wide, stream);
}
