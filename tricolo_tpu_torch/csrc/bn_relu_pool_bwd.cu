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
// from the Pallas one.
//
// Bound: memory. Per element it reads y, 1/8 of ga and idx, 1/C of the mask,
// and writes dy; ~8 flops per element, far below the ~295 flop/byte where
// the H100 stops being bandwidth-bound. The least time is
// (bytes of y + ga + idx [+ stats_mask] + dy) / 3.35 TB/s: at the unmasked
// flagship block 1, (128, 64^3, 32) bf16, 4.697 GB (1.402 ms).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <int VEC>
struct alignas(VEC) Bytes {
  uint8_t v[VEC];
};

template <typename T, int VEC, typename I, bool kMasked>
__global__ void bn_relu_pool_bwd_kernel(
    const T* __restrict__ y, const T* __restrict__ ga,
    const uint8_t* __restrict__ idx, const T* __restrict__ stats_mask,
    const float* __restrict__ bcoef, const float* __restrict__ ccoef,
    const float* __restrict__ inv, const float* __restrict__ sub,
    T* __restrict__ dy, I groups, int D, int H, int W, int C) {
  const int CV = C / VEC;
  const int D2 = D >> 1, H2 = H >> 1, W2 = W >> 1;
  for (I g = blockIdx.x * (I)blockDim.x + threadIdx.x; g < groups;
       g += (I)gridDim.x * blockDim.x) {
    const int c0 = (int)(g % CV) * VEC;
    const I site = g / CV;
    const int w = (int)(site % W);
    I q = site / W;
    const int h = (int)(q % H);
    q /= H;
    const int d = (int)(q % D);
    const I n = q / D;
    const int r = ((d & 1) << 2) | ((h & 1) << 1) | (w & 1);
    const I psite = ((n * D2 + (d >> 1)) * H2 + (h >> 1)) * W2 + (w >> 1);
    float m = 1.f;
    if constexpr (kMasked) m = Num<T>::load(stats_mask[site]);
    const Pack<T, VEC> yv = *reinterpret_cast<const Pack<T, VEC>*>(y + site * C + c0);
    const Pack<T, VEC> gv = *reinterpret_cast<const Pack<T, VEC>*>(ga + psite * C + c0);
    const Bytes<VEC> iv = *reinterpret_cast<const Bytes<VEC>*>(idx + psite * C + c0);
    Pack<T, VEC> out;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int c = c0 + v;
      const float routed = iv.v[v] == r ? Num<T>::load(gv.v[v]) : 0.f;
      const float z = __fsub_rn(__fmul_rn(Num<T>::load(yv.v[v]), inv[c]), sub[c]);
      float t = __fadd_rn(bcoef[c], __fmul_rn(ccoef[c], z));
      if constexpr (kMasked) t = __fmul_rn(t, m);
      out.v[v] = Num<T>::store(__fadd_rn(routed, t));
    }
    *reinterpret_cast<Pack<T, VEC>*>(dy + site * C + c0) = out;
  }
}

template <typename T, int VEC, typename I>
int launch_typed(const void* y, const void* ga, const void* idx,
                 const void* stats_mask, const void* bcoef, const void* ccoef,
                 const void* inv, const void* sub, void* dy, long long N, int D,
                 int H, int W, int C, void* stream) {
  const I groups = (I)(N * D * H * W * (long long)(C / VEC));
  const int threads = 256;
  const long long want = ((long long)groups + threads - 1) / threads;
  const int blocks = (int)(want < (1 << 30) ? want : (1 << 30));
  cudaStream_t st = (cudaStream_t)stream;
  if (stats_mask != nullptr) {
    bn_relu_pool_bwd_kernel<T, VEC, I, true><<<blocks, threads, 0, st>>>(
        (const T*)y, (const T*)ga, (const uint8_t*)idx, (const T*)stats_mask,
        (const float*)bcoef, (const float*)ccoef, (const float*)inv,
        (const float*)sub, (T*)dy, groups, D, H, W, C);
  } else {
    bn_relu_pool_bwd_kernel<T, VEC, I, false><<<blocks, threads, 0, st>>>(
        (const T*)y, (const T*)ga, (const uint8_t*)idx, nullptr,
        (const float*)bcoef, (const float*)ccoef, (const float*)inv,
        (const float*)sub, (T*)dy, groups, D, H, W, C);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* y, const void* ga, const void* idx,
           const void* stats_mask, const void* bcoef, const void* ccoef,
           const void* inv, const void* sub, void* dy, long long N, int D,
           int H, int W, int C, int vec4, void* stream) {
  const long long total = N * D * H * W * (long long)C;
  if (total == 0) return 0;
  // 32-bit indices when every element offset fits and the grid-stride step
  // (<= the pack count) cannot overflow them.
  const long long groups = total / (vec4 ? 4 : 1);
  const bool small = total < (1LL << 31) && groups < (1LL << 30);
  if (vec4) {
    return small ? launch_typed<T, 4, int>(y, ga, idx, stats_mask, bcoef, ccoef,
                                          inv, sub, dy, N, D, H, W, C, stream)
                 : launch_typed<T, 4, long long>(y, ga, idx, stats_mask, bcoef,
                                                ccoef, inv, sub, dy, N, D, H,
                                                W, C, stream);
  }
  return small ? launch_typed<T, 1, int>(y, ga, idx, stats_mask, bcoef, ccoef,
                                        inv, sub, dy, N, D, H, W, C, stream)
               : launch_typed<T, 1, long long>(y, ga, idx, stats_mask, bcoef,
                                              ccoef, inv, sub, dy, N, D, H, W,
                                              C, stream);
}

}  // namespace

// vec4 != 0 asks for 4-channel packs: the caller guarantees C % 4 == 0 and
// 16-byte-aligned y, ga, dy and 4-byte-aligned idx. stats_mask == nullptr
// selects the unmasked entry.
extern "C" int bn_relu_pool_bwd_f32(const void* y, const void* ga,
                                    const void* idx, const void* stats_mask,
                                    const void* bcoef, const void* ccoef,
                                    const void* inv, const void* sub, void* dy,
                                    long long N, int D, int H, int W, int C,
                                    int vec4, void* stream) {
  return launch<float>(y, ga, idx, stats_mask, bcoef, ccoef, inv, sub, dy, N,
                       D, H, W, C, vec4, stream);
}

extern "C" int bn_relu_pool_bwd_bf16(const void* y, const void* ga,
                                     const void* idx, const void* stats_mask,
                                     const void* bcoef, const void* ccoef,
                                     const void* inv, const void* sub, void* dy,
                                     long long N, int D, int H, int W, int C,
                                     int vec4, void* stream) {
  return launch<__nv_bfloat16>(y, ga, idx, stats_mask, bcoef, ccoef, inv, sub,
                               dy, N, D, H, W, C, vec4, stream);
}
