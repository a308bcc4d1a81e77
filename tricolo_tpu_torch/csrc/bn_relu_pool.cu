// Masked eval BatchNorm -> ReLU -> zero -> MaxPool(2^3), channels-last.
//
// Replaces: tricolo_tpu/ops/fused_bn_pool.py::_fwd_kernel (the Pallas TPU
// kernel: folded per-channel BN, ReLU, 2^3 window max and first-argmax
// index), extended to the masked eval forms the voxel encoder runs in all
// five blocks: masked_inference_bn_relu_pool2 (two masks, block 1) and
// masked_inference_bn_relu_pool (one mask, blocks 2-5).
//
//   a       = relu(y * mul + add) * zero_mask        (per site, per channel)
//   pooled  = max over each 2x2x2 window of a
//   pmask   = max over each 2x2x2 window of stats_mask
//   idx     = first r = dd*4 + hh*2 + ww reaching the max (strict >)
//
// Bound: memory. Per pooled element it reads 8 activations and writes one;
// there are ~4 flops per activation, far below the ~295 flop/byte where the
// H100 stops being bandwidth-bound. The least time is
// (bytes of y + masks + pooled + pooled mask [+ idx]) / 3.35 TB/s.
//
// Design: one thread per pooled (n, d2, h2, w2, c), neighbouring threads on
// neighbouring channels, so each of the 8 window reads of a warp is one
// contiguous segment (C >= 32 on every voxel block) and each y byte is read
// once. The mask of a site is the same for all channels: a warp's mask reads
// are broadcasts, and only the c == 0 lane writes the pooled mask. A
// grid-stride loop covers any size. No shared memory, no atomics: every
// output is written exactly once, so the result is deterministic.
//
// Rounding mirrors the plain PyTorch version op for op: in bf16 the product
// and the sum are each rounded to bf16 (__fmul_rn / __fadd_rn keep nvcc from
// contracting them into one FMA), so the kernel is bit-exact against
// tricolo_tpu_torch.ops.bn_relu_pool.bn_relu_pool_plain in f32 and bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float load(float v) { return v; }
  __device__ static float round(float v) { return v; }
  __device__ static float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

template <typename T>
__global__ void bn_relu_pool_kernel(const T* __restrict__ y,
                                    const T* __restrict__ mul,
                                    const T* __restrict__ add,
                                    const T* __restrict__ zero_mask,
                                    const T* __restrict__ stats_mask,
                                    T* __restrict__ pooled,
                                    T* __restrict__ pooled_mask,
                                    uint8_t* __restrict__ idx,
                                    int64_t total, int D2, int H2, int W2,
                                    int C) {
  const int64_t H = 2 * (int64_t)H2, W = 2 * (int64_t)W2, D = 2 * (int64_t)D2;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const int64_t p = i / C;  // pooled site
    const int64_t w2 = p % W2;
    int64_t q = p / W2;
    const int64_t h2 = q % H2;
    q /= H2;
    const int64_t d2 = q % D2;
    const int64_t n = q / D2;
    const float m = Num<T>::load(mul[c]);
    const float b = Num<T>::load(add[c]);
    float best = 0.f, mbest = 0.f;
    int arg = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int64_t site =
          ((n * D + 2 * d2 + (r >> 2)) * H + 2 * h2 + ((r >> 1) & 1)) * W +
          2 * w2 + (r & 1);
      float t = Num<T>::round(__fmul_rn(Num<T>::load(y[site * C + c]), m));
      t = Num<T>::round(__fadd_rn(t, b));
      t = t > 0.f ? t : 0.f;
      t = Num<T>::round(__fmul_rn(t, Num<T>::load(zero_mask[site])));
      if (r == 0 || t > best) {  // strict >: the first max wins
        best = t;
        arg = r;
      }
      if (c == 0) {
        const float s = Num<T>::load(stats_mask[site]);
        mbest = (r == 0 || s > mbest) ? s : mbest;
      }
    }
    pooled[i] = Num<T>::store(best);
    if (idx != nullptr) idx[i] = (uint8_t)arg;
    if (c == 0) pooled_mask[p] = Num<T>::store(mbest);
  }
}

template <typename T>
int launch(const void* y, const void* mul, const void* add,
           const void* zero_mask, const void* stats_mask, void* pooled,
           void* pooled_mask, void* idx, long long N, int D2, int H2, int W2,
           int C, void* stream) {
  const int64_t total = (int64_t)N * D2 * H2 * W2 * C;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < (1 << 30) ? want : (1 << 30));
  bn_relu_pool_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)y, (const T*)mul, (const T*)add, (const T*)zero_mask,
      (const T*)stats_mask, (T*)pooled, (T*)pooled_mask, (uint8_t*)idx, total,
      D2, H2, W2, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bn_relu_pool_f32(const void* y, const void* mul,
                                const void* add, const void* zero_mask,
                                const void* stats_mask, void* pooled,
                                void* pooled_mask, void* idx, long long N,
                                int D2, int H2, int W2, int C, void* stream) {
  return launch<float>(y, mul, add, zero_mask, stats_mask, pooled, pooled_mask,
                       idx, N, D2, H2, W2, C, stream);
}

extern "C" int bn_relu_pool_bf16(const void* y, const void* mul,
                                 const void* add, const void* zero_mask,
                                 const void* stats_mask, void* pooled,
                                 void* pooled_mask, void* idx, long long N,
                                 int D2, int H2, int W2, int C, void* stream) {
  return launch<__nv_bfloat16>(y, mul, add, zero_mask, stats_mask, pooled,
                               pooled_mask, idx, N, D2, H2, W2, C, stream);
}
