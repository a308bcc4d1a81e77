// Blocked online-softmax NT-Xent: one forward and one two-term backward
// kernel behind five entries, f32 on the CUDA cores.
//
// Replaces the three Pallas TPU kernels of tricolo_tpu/ops/nt_xent_pallas.py:
//
//   nt_xent_fwd       <- _fwd_kernel (l.43):       per row i of zi, the
//                        diagonal logit l_ii and logsumexp_j l_ij,
//                        l = zi zj^T / tau -> (B, 2)
//   nt_xent_fwd_pair  <- _fwd_kernel twice, as the JAX _fwd (l.178) calls it
//                        on (zi, zj) and (zj, zi): from one pass over l, the
//                        diagonal, the row logsumexps and the column ones
//                        (the row logsumexps of zj zi^T / tau) -> (B, 3)
//   nt_xent_bwd_rows  <- _bwd_kernel (l.92):       dzi = (P - I) zj * s
//   nt_xent_bwd_cols  <- _bwd_cols_kernel (l.208): dzj = (P - I)^T zi * s
//   nt_xent_bwd       <- both at once, as the JAX _bwd (l.186) adds them for
//                        one operand: out_r = sum_c coeff_rc oth_c with
//                          coeff_rc = s_row (exp(l_rc - lse_row[r]) - d_rc)
//                                   + s_col (exp(l_rc - lse_col[c]) - d_rc)
//                        and l = own oth^T / tau computed once for both.
//
// P is recomputed from the saved logsumexps and the scales (the loss
// cotangent times a direction's weight over tau B) are read from device
// memory (no host sync). Nothing O(B^2) reaches device memory: that is the
// kernels' purpose. The loss's forward is one nt_xent_fwd_pair; dzi is
// nt_xent_bwd(zi, zj, lse_a, lse_b, [s_a, s_b]) and dzj is nt_xent_bwd(zj,
// zi, lse_b, lse_a, [s_b, s_a]). nt_xent_fwd is the pair kernel with the
// column statistics compiled out, and the single-term backward entries the
// two-term kernel with one term compiled out (rows: own = zi, lse by row;
// cols: own = zj, oth = zi, lse by column).
//
// Bound: operations. Each forward does 2 B^2 D flops (the pair's column
// statistics reuse the same logits), each backward 4 B^2 D (one logits
// product, one coefficient product) at 67 TFLOP/s (H100 SXM f32 outside the
// tensor cores): 1.03 and 2.05 ms at (8192, 512), 0.3 and 0.5 us at (128,
// 512), where the launch floor of a few us is the practical limit. The
// operands are read once from device memory, small beside that.
//
// The forward's design, against the one-block-a-32-row-tile kernel it
// replaces (4 blocks at B = 128, one logit a thread a row, no register
// blocking or prefetch, the transposed logits recomputed by a second call):
//
// * One pass for both directions. A block owns one BM x BN tile of l over
//   the full D and reduces it twice: per row (max, sum exp(l - max)) over
//   its columns and per column over its rows. A row's lse needs every column
//   tile and a column's every row tile, which lie in other blocks: each
//   block writes its per-row and per-column partials to a scratch buffer
//   (the wrapper's torch.empty, 8 MB at (8192, 512)), and a small combine
//   kernel merges them per row and per column in tile order, as online
//   logsumexp. No float atomics: the result does not depend on scheduling.
//   The combine is a programmatic dependent launch, so its launch overlaps
//   the tile kernel's end.
// * Parallelism at B = 128: a 2-D grid of tiles (column tiles x row tiles),
//   not the backward's D-splitting cluster: the forward has no second product to
//   spread over D slices, and a tile over the full D needs no exchange
//   barrier on its critical path. Small tiles of 16 x 32 give 8 x 4 = 32
//   blocks; four groups of 64 threads each sum a quarter of D, added in
//   group order, and the whole of D (at most 512) is in flight at once (16
//   cp.async stages), since such a block is bound by latency.
// * Throughput at B = 8192: 128 x 128 tiles (4096 blocks of 256 threads,
//   about 16 waves of two blocks an SM). Each thread owns an 8 x 8 block of
//   logits, its warp a 4 x 8 grid of threads: 16 float4 reads of shared
//   memory feed 256 FMAs, and a warp's read is 4 broadcast rows or 8 rows
//   padded to KC + 4 floats (conflict-free). That is a quarter of a float
//   a thread per FMA, about all that shared memory delivers at the FMA
//   rate, so latency is hidden by occupancy rather than by deep prefetch:
//   two 32-column cp.async stages (74 KB) and registers capped at 128 a
//   thread (a few spill) let two blocks share an SM. That measured faster
//   than one block an SM with three stages (216 registers) or with 16 x 8
//   logits a thread (a quarter fewer reads per FMA, 254 registers).
//   64 x 64 tiles with 4 x 4 blocks cover the batches between (B ~ 1000).
//   The wrapper's launch plan picks the largest tile whose grid fills the
//   132 SMs.
//
// The backward's design, against the three limits of the one-block-a-32-row
// tile kernel it replaces (4 blocks at B = 128; one logit a thread a row and
// no register blocking; the smem attribute set on every launch):
//
// * Parallelism at B = 128. A cluster of D/DS blocks (DS = 128, or 64 when
//   128 does not divide D) shares a row tile; each block owns a DS-wide slice
//   of D. Each computes the partial logits of the tile over its slice, the
//   blocks exchange the partial tiles through distributed shared memory and
//   sum them in rank order (every block holds the same full-D logits, and
//   no block recomputes another's slice), then each multiplies the
//   coefficient tile by its own slice of oth. With 16-row tiles (64 threads)
//   B = 128, D = 512 runs 8 row tiles x 4 = 32 blocks instead of 4.
// * Throughput at B = 8192. 64-row tiles (256 threads) once the row tiles
//   fill the card. Both products are register-blocked: in the logits each
//   thread owns a 4 x 4 block (its warp a 16 x 32 block), so each float4
//   read of shared memory (rows padded to DS + 4 floats: conflict-free)
//   feeds 16 FMAs; in the coefficient product each thread owns an 8 x 8 (or
//   8 x 4) block of the output over half of the tile's columns, the two
//   halves added once at the end. The streamed oth tile (64 rows) is
//   prefetched with cp.async a tile ahead into one of three buffers, and
//   the loop is software-pipelined: tile t - 1's coefficient product runs
//   between the arrive and the wait of the cluster barrier that guards tile
//   t's exchange, so the blocks' wait for each other is spent on arithmetic.
//   198 KB of shared memory a block at DS = 128 (227 KB allowed), one block
//   an SM. What bounds it still: the logits product's shared-memory reads
//   and the exchange on the critical path of every tile (PERF.md).
// * Host. cudaFuncSetAttribute runs once per instantiation and device, not
//   on every launch; the launch plan (DS, row tile) comes from the wrapper.
//
// Ragged edges (B not a multiple of the tiles) are masked: rows past B load
// as zeros and are not stored; columns past B get a zero coefficient, and
// rows and columns past B are left out of the forward's statistics. D is
// a multiple of 64, at most 512. f32 fmaf and expf throughout, no atomics:
// the result does not depend on scheduling. The sums run in another order
// than the plain version's matrix products, so the two agree to rounding,
// not bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

// Sets a kernel's dynamic shared memory limit once per device (`done` holds
// one bit per device ordinal).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<unsigned long long>& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// ------------------------------------------------------------- forward (K4)

constexpr int KC = 32;          // D columns of one pipeline stage
constexpr int LDK = KC + 4;     // a stage's padded row stride (floats)
constexpr float NEG = -1e30f;   // the JAX kernel's _NEG_INF
constexpr unsigned FULL = 0xffffffffu;

// A BM x BN logits tile a block: each thread owns TM x TN logits, rows
// tr + RT i and columns tc + CT j, its warp a 4 x 8 grid of threads. KG
// groups of threads each sum a quarter (KG = 4) or all (KG = 1) of every
// stage's D columns; STAGES stages of cp.async are in flight; MINB blocks
// share an SM (the registers a thread get capped to fit).
template <int BM_, int BN_, int TM_, int TN_, int KG_, int STAGES_, int MINB_>
struct FwdPlan {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, KG = KG_, STAGES = STAGES_;
  static constexpr int MINB = MINB_;
  static constexpr int RT = BM / TM, CT = BN / TN;  // threads along rows, columns
  static constexpr int WR = RT / 4, WC = CT / 8;    // warps of a group along rows, columns
  static constexpr int GROUP = 32 * WR * WC;        // threads of a group
  static constexpr int THREADS = GROUP * KG;
  static constexpr int KQ = KC / 4 / KG;            // float4 columns a group a stage
  static constexpr int STAGE = (BM + BN) * LDK;     // floats
  static constexpr int RED = (KG - 1) * TM * TN * GROUP;   // the groups' partial logits
  static constexpr int EPI = 2 * (WC * BM + WR * BN);      // the statistics exchange
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;
  static_assert(RT % 4 == 0 && CT % 8 == 0 && (KC / 4) % KG == 0, "thread layout");
  static_assert(RED + EPI <= STAGES * STAGE, "the epilogue reuses the stages");
};

using FwdLarge = FwdPlan<128, 128, 8, 8, 1, 2, 2>;  // B = 8192: 4096 blocks, 256 threads
using FwdMid = FwdPlan<64, 64, 4, 4, 1, 4, 1>;      // B ~ 1000: 256 blocks
using FwdSmall = FwdPlan<16, 32, 2, 4, 4, 16, 1>;   // B = 128: 32 blocks, all D in flight

template <typename P, bool COL>
__global__ void __launch_bounds__(P::THREADS, P::MINB)
    nt_xent_fwd_tile_kernel(const float* __restrict__ zi, const float* __restrict__ zj,
                            float* __restrict__ out, float2* __restrict__ row_part,
                            float2* __restrict__ col_part, int B, int D, float inv_tau) {
  constexpr int BM = P::BM, BN = P::BN, TM = P::TM, TN = P::TN, RT = P::RT, CT = P::CT;
  constexpr int WR = P::WR, WC = P::WC, STAGES = P::STAGES, KQ = P::KQ, STAGE = P::STAGE;
  constexpr int W = COL ? 3 : 2;  // out's row: diagonal, row lse[, column lse]
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ct = blockIdx.x, rt = blockIdx.y;
  const int row0 = rt * BM, col0 = ct * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = warp / (WR * WC), wg = warp % (WR * WC);
  const int wr = wg / WC, wc = wg % WC;
  const int tr = wr * 4 + (lane >> 3), tc = wc * 8 + (lane & 7);

  // Stage s holds D columns [KC c, KC c + KC) of the tile's BM zi rows, then
  // of its BN zj rows (zeros past B), rows padded to LDK floats.
  auto load_stage = [&](int c) {
    float* dst = smem + (c % STAGES) * STAGE;
    const int k0 = c * KC;
    for (int q = tid; q < (BM + BN) * (KC / 4); q += P::THREADS) {
      const int r = q / (KC / 4), k = q % (KC / 4);
      const int grow = r < BM ? row0 + r : col0 + r - BM;
      const bool valid = grow < B;
      const float* src = (r < BM ? zi : zj) + (size_t)(valid ? grow : 0) * D + k0 + 4 * k;
      cp_async16(dst + r * LDK + 4 * k, src, valid);
    }
  };

  const int n_chunks = D / KC;
#pragma unroll 1
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) load_stage(c);
    cp_async_commit();
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c has landed; chunk c - 1's stage is no longer read
    if (c + STAGES - 1 < n_chunks) load_stage(c + STAGES - 1);
    cp_async_commit();
    const float* a = smem + (c % STAGES) * STAGE + tr * LDK + 4 * KQ * g;
    const float* b = smem + (c % STAGES) * STAGE + (BM + tc) * LDK + 4 * KQ * g;
    // One float4 of D a row: TN zj reads, then TM zi reads each feeding 4 TN FMAs.
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      float4 bv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        bv[j] = *reinterpret_cast<const float4*>(b + j * CT * LDK + 4 * kk);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(a + i * RT * LDK + 4 * kk);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // every stage has been read: the epilogue reuses them

  // Groups 1.. hand their partial dot products to group 0, which adds them
  // in group order.
  if constexpr (P::KG > 1) {
    float* red = smem + wg * 32 + lane;
    if (g > 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) red[((g - 1) * TM * TN + i * TN + j) * P::GROUP] = acc[i][j];
    }
    __syncthreads();
    if (g == 0) {
      for (int h = 1; h < P::KG; ++h)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] += red[((h - 1) * TM * TN + i * TN + j) * P::GROUP];
    }
  }

  // The tile's logits (group 0 holds them), the diagonal, and per row and
  // per column of the tile the max and the sum of exp(l - max).
  const bool mine = g == 0;
  bool rv[TM], cv[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) rv[i] = row0 + tr + RT * i < B;
#pragma unroll
  for (int j = 0; j < TN; ++j) cv[j] = col0 + tc + CT * j < B;
  float rmax[TM], cmax[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) rmax[i] = NEG;
#pragma unroll
  for (int j = 0; j < TN; ++j) cmax[j] = NEG;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float l = acc[i][j] * inv_tau;
      acc[i][j] = l;
      if (mine && rv[i] && row0 + tr + RT * i == col0 + tc + CT * j)
        out[(size_t)W * (row0 + tr + RT * i)] = l;
      if (cv[j]) rmax[i] = fmaxf(rmax[i], l);
      if (COL && rv[i]) cmax[j] = fmaxf(cmax[j], l);
    }
  // Row statistics across the 8 lanes of a thread row and the WC warps of a
  // block row; column statistics across the 4 lanes and WR warps.
  float* epi = smem + P::RED;
  float* xr = epi;                  // [WC][BM] row maxima
  float* yr = xr + WC * BM;         // [WC][BM] row sums
  float* xc = yr + WC * BM;         // [WR][BN] column maxima
  float* yc = xc + WR * BN;         // [WR][BN] column sums
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(FULL, rmax[i], off));
  if (COL) {
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int off = 8; off < 32; off <<= 1)
        cmax[j] = fmaxf(cmax[j], __shfl_xor_sync(FULL, cmax[j], off));
  }
  if (mine && (lane & 7) == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) xr[wc * BM + tr + RT * i] = rmax[i];
  }
  if (COL && mine && (lane >> 3) == 0) {
#pragma unroll
    for (int j = 0; j < TN; ++j) xc[wr * BN + tc + CT * j] = cmax[j];
  }
  __syncthreads();
  float rsum[TM], csum[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float m = xr[tr + RT * i];
#pragma unroll
    for (int w = 1; w < WC; ++w) m = fmaxf(m, xr[w * BM + tr + RT * i]);
    rmax[i] = m;
    rsum[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float m = NEG;
    if (COL) {
      m = xc[tc + CT * j];
#pragma unroll
      for (int w = 1; w < WR; ++w) m = fmaxf(m, xc[w * BN + tc + CT * j]);
    }
    cmax[j] = m;
    csum[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (cv[j]) rsum[i] += expf(acc[i][j] - rmax[i]);
      if (COL && rv[i]) csum[j] += expf(acc[i][j] - cmax[j]);
    }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) rsum[i] += __shfl_xor_sync(FULL, rsum[i], off);
  if (COL) {
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int off = 8; off < 32; off <<= 1) csum[j] += __shfl_xor_sync(FULL, csum[j], off);
  }
  if (mine && (lane & 7) == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) yr[wc * BM + tr + RT * i] = rsum[i];
  }
  if (COL && mine && (lane >> 3) == 0) {
#pragma unroll
    for (int j = 0; j < TN; ++j) yc[wr * BN + tc + CT * j] = csum[j];
  }
  __syncthreads();
  // A thread a row, then a column, writes the tile's (max, sum), the warps'
  // sums added in warp order.
  for (int q = tid; q < BM + (COL ? BN : 0); q += P::THREADS) {
    if (q < BM) {
      if (row0 + q >= B) continue;
      float m = xr[q], s = yr[q];
#pragma unroll
      for (int w = 1; w < WC; ++w) {
        m = fmaxf(m, xr[w * BM + q]);
        s += yr[w * BM + q];
      }
      row_part[(size_t)ct * B + row0 + q] = make_float2(m, s);
    } else {
      const int c = q - BM;
      if (col0 + c >= B) continue;
      float m = xc[c], s = yc[c];
#pragma unroll
      for (int w = 1; w < WR; ++w) {
        m = fmaxf(m, xc[w * BN + c]);
        s += yc[w * BN + c];
      }
      col_part[(size_t)rt * B + col0 + c] = make_float2(m, s);
    }
  }
}

// One thread a row (then a column) merges the tiles' (max, sum) partials in
// tile order, as online logsumexp: lse = max + log(sum).
template <bool COL>
__global__ void __launch_bounds__(256)
    nt_xent_fwd_combine_kernel(const float2* __restrict__ row_part,
                               const float2* __restrict__ col_part, float* __restrict__ out,
                               int B, int n_col_tiles, int n_row_tiles) {
  // A programmatic dependent launch: its launch overlaps the tile kernel's
  // end; wait until that kernel has finished and its partials are visible.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool col = COL && q >= B;
  const int r = col ? q - B : q;
  if (r >= B) return;
  const float2* part = (col ? col_part : row_part) + r;
  const int n = col ? n_row_tiles : n_col_tiles;
  float m = NEG, s = 0.f;
  for (int t = 0; t < n; ++t) {
    const float2 v = part[(size_t)t * B];
    const float mx = fmaxf(m, v.x);
    s = s * expf(m - mx) + v.y * expf(v.x - mx);
    m = mx;
  }
  out[(size_t)(COL ? 3 : 2) * r + (col ? 2 : 1)] = m + logf(s);
}

template <typename P, bool COL>
int launch_fwd(const float* zi, const float* zj, float* out, float* scratch, int B, int D,
               float inv_tau, cudaStream_t stream) {
  auto kernel = nt_xent_fwd_tile_kernel<P, COL>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem(kernel, P::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int n_ct = (B + P::BN - 1) / P::BN, n_rt = (B + P::BM - 1) / P::BM;
  float2* row_part = reinterpret_cast<float2*>(scratch);  // [n_ct][B]
  float2* col_part = row_part + (size_t)n_ct * B;         // [n_rt][B]
  kernel<<<dim3((unsigned)n_ct, (unsigned)n_rt, 1), P::THREADS, P::SMEM, stream>>>(
      zi, zj, out, row_part, col_part, B, D, inv_tau);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(((COL ? 2 : 1) * (size_t)B + 255) / 256), 1, 1);
  config.blockDim = dim3(256, 1, 1);
  config.stream = stream;
  config.attrs = &pdl;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, nt_xent_fwd_combine_kernel<COL>,
                           static_cast<const float2*>(row_part),
                           static_cast<const float2*>(col_part), out, B, n_ct, n_rt);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// bm: the logits tile's rows (128, 64 or 16; the wrapper's launch plan
// picks it, with 128, 64 or 32 columns).
template <bool COL>
int launch_fwd_plan(const void* zi, const void* zj, void* out, void* scratch, int B, int D,
                    float inv_tau, int bm, void* stream) {
  if (B == 0) return 0;
  if (D % 64 != 0 || D > 512) return (int)cudaErrorInvalidValue;
  const float *a = (const float*)zi, *b = (const float*)zj;
  float *y = (float*)out, *p = (float*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  if (bm == FwdLarge::BM) return launch_fwd<FwdLarge, COL>(a, b, y, p, B, D, inv_tau, st);
  if (bm == FwdMid::BM) return launch_fwd<FwdMid, COL>(a, b, y, p, B, D, inv_tau, st);
  if (bm == FwdSmall::BM) return launch_fwd<FwdSmall, COL>(a, b, y, p, B, D, inv_tau, st);
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------------------------- backward (K5, K6, both)

constexpr int BN = 64;  // oth rows a streamed tile (logits columns)

// A block of WM x 2 warps: BM = 16 WM own rows, a DS-wide slice of D.
template <int WM, int DS>
struct Plan {
  static constexpr int BM = 16 * WM;
  static constexpr int THREADS = 64 * WM;
  static constexpr int LD = DS + 4;   // operand row stride (floats)
  static constexpr int LDC = BM + 4;  // transposed coefficient row stride
  static constexpr int NV = DS / 64;  // output float4s a thread a row
  static constexpr size_t SMEM =
      sizeof(float) * (BM * LD + 3 * BN * LD + 2 * 16 * THREADS + 2 * BN * LDC);
};

// The cluster barrier in two halves: arrive publishes this block's shared
// memory writes, wait returns once every block of the cluster has arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Columns [d0, d0 + DS) of rows [row0, row0 + ROWS) of a (B, D) matrix into
// shared memory with row stride DS + 4, by cp.async; zeros past B.
template <int ROWS, int DS, int THREADS_>
__device__ __forceinline__ void load_slice(const float* __restrict__ src, float* dst, int row0,
                                           int B, int D, int d0) {
  constexpr int C4 = DS / 4;
  for (int q = threadIdx.x; q < ROWS * C4; q += THREADS_) {
    const int r = q / C4, k = q % C4;
    const int g = row0 + r;
    const bool valid = g < B;
    cp_async16(dst + r * (DS + 4) + 4 * k, src + (size_t)(valid ? g : 0) * D + d0 + 4 * k,
               valid);
  }
}

// s[i][j] = own row (ar + 4 i) . tile row (ac + 8 j) over the DS-wide slice.
template <int DS>
__device__ __forceinline__ void slice_logits(const float* own_s, const float* tile, int ar,
                                             int ac, float s[4][4]) {
  constexpr int LD = DS + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  const float* a = own_s + ar * LD;
  const float* b = tile + ac * LD;
#pragma unroll 8
  for (int k = 0; k < DS; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + 4 * i * LD + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + 8 * j * LD + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][v][e] += sum_c coeff[8 rg + i][c] tile[c][4 dg + 64 v + e] over
// the half c in [32 h, 32 h + 32) of the tile, coeff stored transposed (row
// stride LDC).
template <int LDC, int DS>
__device__ __forceinline__ void coef_product(const float* coef, const float* tile, int h,
                                             int rg, int dg, float acc[8][DS / 64][4]) {
  constexpr int LD = DS + 4;
  const float* cb = coef + 32 * h * LDC + 8 * rg;
  const float* ob = tile + 32 * h * LD + 4 * dg;
#pragma unroll 4
  for (int c = 0; c < BN / 2; ++c) {
    const float4 c0 = *reinterpret_cast<const float4*>(cb + c * LDC);
    const float4 c1 = *reinterpret_cast<const float4*>(cb + c * LDC + 4);
    const float cr[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int v = 0; v < DS / 64; ++v) {
      const float4 o = *reinterpret_cast<const float4*>(ob + c * LD + 64 * v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][v][0] = fmaf(cr[i], o.x, acc[i][v][0]);
        acc[i][v][1] = fmaf(cr[i], o.y, acc[i][v][1]);
        acc[i][v][2] = fmaf(cr[i], o.z, acc[i][v][2]);
        acc[i][v][3] = fmaf(cr[i], o.w, acc[i][v][3]);
      }
    }
  }
}

template <int WM, int DS, bool ROW, bool COL>
__global__ void __launch_bounds__(64 * WM)
    nt_xent_bwd_cluster_kernel(const float* __restrict__ own, const float* __restrict__ oth,
                               const float* __restrict__ lse_row,
                               const float* __restrict__ lse_col,
                               const float* __restrict__ scales, float* __restrict__ out,
                               int B, int D, float inv_tau) {
  using P = Plan<WM, DS>;
  constexpr int BM = P::BM, T = P::THREADS, LD = P::LD, LDC = P::LDC, NV = P::NV;
  extern __shared__ float4 smem4[];
  float* own_s = reinterpret_cast<float*>(smem4);  // BM x LD
  float* oth_s = own_s + BM * LD;                  // 3 x BN x LD: tiles t - 1, t, t + 1
  float* part_s = oth_s + 3 * BN * LD;             // 2 x 16 T, read by the cluster
  float* coef_s = part_s + 2 * 16 * T;             // 2 x BN x LDC, coeff transposed

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = gridDim.x;  // the cluster spans the grid's x extent
  const int d0 = blockIdx.x * DS, row0 = blockIdx.y * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Logits: warp (warp / 2, warp % 2) owns a 16 x 32 block, lane (lane / 8,
  // lane % 8) its rows ar + 4 i and columns ac + 8 j.
  const int ar = (warp >> 1) * 16 + (lane >> 3), ac = (warp & 1) * 32 + (lane & 7);
  // Output: thread half h sums the tile's columns [32 h, 32 h + 32) into
  // rows 8 rg + i, columns d0 + 4 dg + 64 v; the halves add up at the end.
  const int h = tid / (T / 2), rg = (tid % (T / 2)) >> 4, dg = tid & 15;

  const float s_row = ROW ? scales[0] : 0.f;
  const float s_col = COL ? scales[ROW ? 1 : 0] : 0.f;
  float lr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ar + 4 * i;
    lr[i] = (ROW && r < B) ? lse_row[r] : 0.f;
  }

  load_slice<BM, DS, T>(own, own_s, row0, B, D, d0);
  load_slice<BN, DS, T>(oth, oth_s, 0, B, D, d0);
  cp_async_commit();

  float acc[8][NV][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][v][e] = 0.f;

  // Iteration t computes tile t's logits and coefficients and adds tile
  // t - 1's product to the output. That product runs between the two halves
  // of the cluster barrier which separates writing this block's partial
  // logits from reading the other blocks' ones, so it hides the barrier.
  const int n_tiles = (B + BN - 1) / BN;
  for (int t = 0; t <= n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; tile t - 2's buffers are no longer read
    if (t + 1 < n_tiles)
      load_slice<BN, DS, T>(oth, oth_s + (t + 1) % 3 * BN * LD, (t + 1) * BN, B, D, d0);
    cp_async_commit();

    // 1. This block's partial logits of tile t over its D slice.
    float s[4][4];
    // A warp's 16 partials e = 4 i + j at [warp][e][lane]: every block maps
    // threads to logits alike, so a thread finds its logits at the same
    // place in every block, and a warp reads 128 contiguous bytes at a time.
    float* part = part_s + (t & 1) * 16 * T + warp * 16 * 32 + lane;
    if (t < n_tiles) {
      slice_logits<DS>(own_s, oth_s + t % 3 * BN * LD, ar, ac, s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[(4 * i + j) * 32] = s[i][j];
    }
    cluster_arrive();

    // 2. out[rows, slice] += coeff . oth[tile t - 1, slice].
    if (t > 0)
      coef_product<LDC, DS>(coef_s + ((t - 1) & 1) * BN * LDC, oth_s + (t - 1) % 3 * BN * LD,
                            h, rg, dg, acc);
    // Every block's partials of tile t are written; the last iteration's
    // wait also keeps each block alive while the others read its partials.
    cluster_wait();
    if (t == n_tiles) break;

    // 3. The full-D logits of tile t: the partials summed in rank order,
    // the same sum in every block of the cluster.
    for (int q = 0; q < ranks; ++q) {
      const float* p = cluster.map_shared_rank(part, q);
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = p[(4 * i + j) * 32];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = q ? s[i][j] + v[i][j] : v[i][j];
    }

    // 4. Tile t's coefficients, transposed into shared memory.
    const int col0 = t * BN;
    float lc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + ac + 8 * j;
      lc[j] = (COL && c < B) ? lse_col[c] : 0.f;
    }
    float* coef = coef_s + (t & 1) * BN * LDC;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = row0 + ar + 4 * i, c = col0 + ac + 8 * j;
        float v = 0.f;
        if (r < B && c < B) {
          const float l = s[i][j] * inv_tau, eye = r == c ? 1.f : 0.f;
          if (ROW) v = s_row * (expf(l - lr[i]) - eye);
          if (COL) v = fmaf(s_col, expf(l - lc[j]) - eye, v);
        }
        coef[(ac + 8 * j) * LDC + ar + 4 * i] = v;
      }
  }

  // The second half's sums through shared memory (the operand tiles' room),
  // added to the first half's: out = first + second.
  float4* red = reinterpret_cast<float4*>(oth_s) + (8 * rg) * (DS / 4) + dg;
  __syncthreads();  // the last tile's product has read the operand tiles
  if (h == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        red[i * (DS / 4) + 16 * v] =
            make_float4(acc[i][v][0], acc[i][v][1], acc[i][v][2], acc[i][v][3]);
  }
  __syncthreads();
  if (h == 1) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + 8 * rg + i;
    if (r >= B) continue;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float4 o = red[i * (DS / 4) + 16 * v];
      *reinterpret_cast<float4*>(out + (size_t)r * D + d0 + 4 * dg + 64 * v) =
          make_float4(acc[i][v][0] + o.x, acc[i][v][1] + o.y, acc[i][v][2] + o.z,
                      acc[i][v][3] + o.w);
    }
  }
}

template <int WM, int DS, bool ROW, bool COL>
int launch_bwd(const float* own, const float* oth, const float* lse_row, const float* lse_col,
               const float* scales, float* out, int B, int D, float inv_tau,
               cudaStream_t stream) {
  using P = Plan<WM, DS>;
  auto kernel = nt_xent_bwd_cluster_kernel<WM, DS, ROW, COL>;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem(kernel, P::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const unsigned ranks = (unsigned)(D / DS);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ranks, (unsigned)((B + P::BM - 1) / P::BM), 1);
  config.blockDim = dim3(P::THREADS, 1, 1);
  config.dynamicSmemBytes = P::SMEM;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, own, oth, lse_row, lse_col, scales, out, B, D,
                           inv_tau);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ds: the D slice of a block (128 or 64, dividing D; D / ds blocks a
// cluster); wm: warps along the rows (4: 64-row tiles, 256 threads; 1:
// 16-row tiles, 64 threads). The wrapper's launch plan picks both.
template <bool ROW, bool COL>
int launch_bwd_plan(const void* own, const void* oth, const void* lse_row, const void* lse_col,
                    const void* scales, void* out, int B, int D, float inv_tau, int ds, int wm,
                    void* stream) {
  if (B == 0) return 0;
  if (D % 64 != 0 || D > 512 || (ds != 64 && ds != 128) || D % ds != 0)
    return (int)cudaErrorInvalidValue;
  const float *o = (const float*)own, *t = (const float*)oth;
  const float *lr = (const float*)lse_row, *lc = (const float*)lse_col;
  const float* s = (const float*)scales;
  float* y = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (wm == 4 && ds == 128)
    return launch_bwd<4, 128, ROW, COL>(o, t, lr, lc, s, y, B, D, inv_tau, st);
  if (wm == 4 && ds == 64)
    return launch_bwd<4, 64, ROW, COL>(o, t, lr, lc, s, y, B, D, inv_tau, st);
  if (wm == 1 && ds == 128)
    return launch_bwd<1, 128, ROW, COL>(o, t, lr, lc, s, y, B, D, inv_tau, st);
  if (wm == 1 && ds == 64)
    return launch_bwd<1, 64, ROW, COL>(o, t, lr, lc, s, y, B, D, inv_tau, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// All pointers are contiguous, 16-byte-aligned f32 on one device: zi, zj,
// own, oth (B, D); out (B, 2) for the single-direction forward, (B, 3) for
// the pair and (B, D) for the backwards; scratch (the tiles' partials, from
// the wrapper's launch plan) 2 B (column tiles [+ row tiles for the pair])
// floats; lse* (B,); scale one float, scales two (s_row, s_col). D is a
// multiple of 64, at most 512.
extern "C" int nt_xent_fwd(const void* zi, const void* zj, void* out, void* scratch, int B,
                           int D, float inv_tau, int bm, void* stream) {
  return launch_fwd_plan<false>(zi, zj, out, scratch, B, D, inv_tau, bm, stream);
}

extern "C" int nt_xent_fwd_pair(const void* zi, const void* zj, void* out, void* scratch, int B,
                                int D, float inv_tau, int bm, void* stream) {
  return launch_fwd_plan<true>(zi, zj, out, scratch, B, D, inv_tau, bm, stream);
}

extern "C" int nt_xent_bwd(const void* own, const void* oth, const void* lse_row,
                           const void* lse_col, const void* scales, void* out, int B, int D,
                           float inv_tau, int ds, int wm, void* stream) {
  return launch_bwd_plan<true, true>(own, oth, lse_row, lse_col, scales, out, B, D, inv_tau,
                                     ds, wm, stream);
}

extern "C" int nt_xent_bwd_rows(const void* zi, const void* zj, const void* lse,
                                const void* scale, void* out, int B, int D, float inv_tau,
                                int ds, int wm, void* stream) {
  return launch_bwd_plan<true, false>(zi, zj, lse, nullptr, scale, out, B, D, inv_tau, ds, wm,
                                      stream);
}

extern "C" int nt_xent_bwd_cols(const void* zj, const void* zi, const void* lse,
                                const void* scale, void* out, int B, int D, float inv_tau,
                                int ds, int wm, void* stream) {
  return launch_bwd_plan<false, true>(zj, zi, nullptr, lse, scale, out, B, D, inv_tau, ds, wm,
                                      stream);
}
