// Blocked online-softmax NT-Xent: forward and the two backward products,
// f32 on the CUDA cores.
//
// Replaces the three Pallas TPU kernels of tricolo_tpu/ops/nt_xent_pallas.py:
//
//   nt_xent_fwd       <- _fwd_kernel:       per row i of zi, the diagonal logit
//                        l_ii and logsumexp_j l_ij, l = zi zj^T / tau -> (B, 2)
//   nt_xent_bwd_rows  <- _bwd_kernel:       dzi = (P - I) zj * s
//   nt_xent_bwd_cols  <- _bwd_cols_kernel:  dzj = (P - I)^T zi * s
//
// with P_ij = exp(l_ij - lse_i) recomputed from the saved logsumexps and
// s = ct * alpha-or-(1-alpha) / (tau * B) read from device memory (no host
// sync). Nothing O(B^2) reaches device memory: that is the kernels' purpose.
//
// Bound: operations. The forward does 2*B^2*D flops, each backward about
// twice that, at 67 TFLOP/s (H100 SXM f32 outside the tensor cores); the
// bytes (the two (B, D) operands, read once) are small beside that. At the
// flagship B = 128 all three are launch-bound.
//
// Design: one block (8 warps) per 32-row tile of its own operand, kept in
// shared memory; the other operand streams through shared memory in 32-row
// tiles. Rows are padded to D + 4 floats, so the float4 reads of 8 lanes
// at a time hit distinct banks. Warp w computes the logits of its own rows
// w, w+8, w+16, w+24 against column `lane`, so a row's 32 logits of a tile
// live in one warp:
//   * forward: warp shuffles give the tile's row max and sum, and each row
//     keeps its running max and sum in registers (online logsumexp);
//   * backward: the (P - I) tile goes to shared memory, and each thread
//     accumulates an 8-row x (D/64)-column slice of the (32, D) output in
//     registers from it and the streamed tile.
// Ragged edges (B not a multiple of 32) are masked: rows past B are zero,
// columns past B take no part. D must be a multiple of 64 and at most 512
// (the accumulator slice is a compile-time size). f32 FMA throughout, as
// the JAX kernels compute in f32; the sums run in another order than the
// plain version's matrix products, so the two agree to rounding, not bit
// for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;     // rows of the own tile and of each streamed tile
constexpr int THREADS = 256;  // 8 warps
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Rows [row0, row0 + TILE) of a (B, D) f32 matrix into shared memory with
// row stride D + 4; zeros past B.
__device__ void load_tile(const float* __restrict__ src, float* dst, int row0, int B,
                          int D) {
  const int d4 = D >> 2;
  for (int i = threadIdx.x; i < TILE * d4; i += THREADS) {
    const int r = i / d4, k = i - r * d4;
    const int g = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < B) v = reinterpret_cast<const float4*>(src + (size_t)g * D)[k];
    *reinterpret_cast<float4*>(dst + r * (D + 4) + 4 * k) = v;
  }
}

// s[i] = own row (warp + 8 i) . other row lane, over the full D.
__device__ __forceinline__ void tile_dots(const float* own_s, const float* oth_s, int D,
                                          float s[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* b = oth_s + lane * (D + 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = 0.f;
  for (int k = 0; k < D; k += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(own_s + (warp + 8 * i) * (D + 4) + k);
      s[i] = fmaf(av.x, bv.x, s[i]);
      s[i] = fmaf(av.y, bv.y, s[i]);
      s[i] = fmaf(av.z, bv.z, s[i]);
      s[i] = fmaf(av.w, bv.w, s[i]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    nt_xent_fwd_kernel(const float* __restrict__ zi, const float* __restrict__ zj,
                       float* __restrict__ out, int B, int D, float inv_tau) {
  extern __shared__ float4 smem4[];
  float* zi_s = reinterpret_cast<float*>(smem4);
  float* zj_s = zi_s + TILE * (D + 4);
  const int row0 = blockIdx.x * TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  load_tile(zi, zi_s, row0, B, D);
  float run_max[4], run_sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run_max[i] = -1e30f;  // the JAX kernel's _NEG_INF
    run_sum[i] = 0.f;
  }
  for (int col0 = 0; col0 < B; col0 += TILE) {
    __syncthreads();  // the previous tile is no longer read
    load_tile(zj, zj_s, col0, B, D);
    __syncthreads();
    float s[4];
    tile_dots(zi_s, zj_s, D, s);
    const int gj = col0 + lane;
    const bool valid = gj < B;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float l = s[i] * inv_tau;
      const float new_max = fmaxf(run_max[i], warp_max(valid ? l : -INFINITY));
      const float e = warp_sum(valid ? expf(l - new_max) : 0.f);
      run_sum[i] = run_sum[i] * expf(run_max[i] - new_max) + e;
      run_max[i] = new_max;
      if (valid && row0 + warp + 8 * i == gj) out[2 * gj] = l;  // diagonal logit
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = row0 + warp + 8 * i;
      if (gi < B) out[2 * gi + 1] = run_max[i] + logf(run_sum[i]);
    }
  }
}

// out[r] = s * sum_c (exp(own_r . oth_c / tau - lse) - [r == c]) oth_c, with
// lse = lse[r] (rows: dzi) or lse[c] (cols: dzj, the other operand's rows
// are the logits' rows).
template <bool LSE_BY_COL, int KC>
__global__ void __launch_bounds__(THREADS)
    nt_xent_bwd_kernel(const float* __restrict__ own, const float* __restrict__ oth,
                       const float* __restrict__ lse, const float* __restrict__ scale,
                       float* __restrict__ out, int B, int D, float inv_tau) {
  extern __shared__ float4 smem4[];
  float* own_s = reinterpret_cast<float*>(smem4);
  float* oth_s = own_s + TILE * (D + 4);
  float* p_s = oth_s + TILE * (D + 4);  // TILE x (TILE + 1)
  const int row0 = blockIdx.x * TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = threadIdx.x >> 6, cl = threadIdx.x & 63;  // output slice
  float lse_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = row0 + warp + 8 * i;
    lse_row[i] = (!LSE_BY_COL && gi < B) ? lse[gi] : 0.f;
  }
  float acc[8][KC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[i][k] = 0.f;
  load_tile(own, own_s, row0, B, D);
  for (int col0 = 0; col0 < B; col0 += TILE) {
    __syncthreads();  // the previous tile and its (P - I) are no longer read
    load_tile(oth, oth_s, col0, B, D);
    __syncthreads();
    float s[4];
    tile_dots(own_s, oth_s, D, s);
    const int gj = col0 + lane;
    const float lse_col = (LSE_BY_COL && gj < B) ? lse[gj] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = row0 + warp + 8 * i;
      float p = 0.f;
      if (gi < B && gj < B) {
        p = expf(s[i] * inv_tau - (LSE_BY_COL ? lse_col : lse_row[i]));
        if (gi == gj) p -= 1.f;
      }
      p_s[(warp + 8 * i) * (TILE + 1) + lane] = p;
    }
    __syncthreads();
    for (int j = 0; j < TILE; ++j) {
      float o[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) o[k] = oth_s[j * (D + 4) + cl + 64 * k];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pv = p_s[(rg * 8 + i) * (TILE + 1) + j];
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[i][k] = fmaf(pv, o[k], acc[i][k]);
      }
    }
  }
  const float sc = *scale;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = row0 + rg * 8 + i;
    if (gi < B) {
#pragma unroll
      for (int k = 0; k < KC; ++k) out[(size_t)gi * D + cl + 64 * k] = acc[i][k] * sc;
    }
  }
}

size_t fwd_smem(int D) { return (size_t)2 * TILE * (D + 4) * sizeof(float); }

size_t bwd_smem(int D) {
  return fwd_smem(D) + (size_t)TILE * (TILE + 1) * sizeof(float);
}

template <bool LSE_BY_COL, int KC>
int launch_bwd_kc(const void* own, const void* oth, const void* lse, const void* scale,
                  void* out, int B, int D, float inv_tau, cudaStream_t stream) {
  auto kernel = nt_xent_bwd_kernel<LSE_BY_COL, KC>;
  const size_t smem = bwd_smem(D);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + TILE - 1) / TILE, THREADS, smem, stream>>>(
      (const float*)own, (const float*)oth, (const float*)lse, (const float*)scale,
      (float*)out, B, D, inv_tau);
  return (int)cudaGetLastError();
}

template <bool LSE_BY_COL>
int launch_bwd(const void* own, const void* oth, const void* lse, const void* scale,
               void* out, int B, int D, float inv_tau, void* stream) {
  if (B == 0) return 0;
  if (D % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D / 64) {
    case 1: return launch_bwd_kc<LSE_BY_COL, 1>(own, oth, lse, scale, out, B, D, inv_tau, s);
    case 2: return launch_bwd_kc<LSE_BY_COL, 2>(own, oth, lse, scale, out, B, D, inv_tau, s);
    case 3: return launch_bwd_kc<LSE_BY_COL, 3>(own, oth, lse, scale, out, B, D, inv_tau, s);
    case 4: return launch_bwd_kc<LSE_BY_COL, 4>(own, oth, lse, scale, out, B, D, inv_tau, s);
    case 5: return launch_bwd_kc<LSE_BY_COL, 5>(own, oth, lse, scale, out, B, D, inv_tau, s);
    case 6: return launch_bwd_kc<LSE_BY_COL, 6>(own, oth, lse, scale, out, B, D, inv_tau, s);
    case 7: return launch_bwd_kc<LSE_BY_COL, 7>(own, oth, lse, scale, out, B, D, inv_tau, s);
    case 8: return launch_bwd_kc<LSE_BY_COL, 8>(own, oth, lse, scale, out, B, D, inv_tau, s);
    default: return (int)cudaErrorInvalidValue;  // D > 512
  }
}

}  // namespace

// All pointers are contiguous f32 on one device: zi, zj (B, D); out (B, 2)
// for the forward and (B, D) for the backwards; lse (B,); scale one float.
// D is a multiple of 64, at most 512.
extern "C" int nt_xent_fwd(const void* zi, const void* zj, void* out, int B, int D,
                           float inv_tau, void* stream) {
  if (B == 0) return 0;
  if (D % 64 != 0 || D > 512) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      nt_xent_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nt_xent_fwd_kernel<<<(B + TILE - 1) / TILE, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)zi, (const float*)zj, (float*)out, B, D, inv_tau);
  return (int)cudaGetLastError();
}

extern "C" int nt_xent_bwd_rows(const void* zi, const void* zj, const void* lse,
                                const void* scale, void* out, int B, int D,
                                float inv_tau, void* stream) {
  return launch_bwd<false>(zi, zj, lse, scale, out, B, D, inv_tau, stream);
}

extern "C" int nt_xent_bwd_cols(const void* zj, const void* zi, const void* lse,
                                const void* scale, void* out, int B, int D,
                                float inv_tau, void* stream) {
  return launch_bwd<true>(zj, zi, lse, scale, out, B, D, inv_tau, stream);
}
