// Blocked online-softmax NT-Xent: the forward and one two-term backward
// kernel behind three entries, f32 on the CUDA cores.
//
// Replaces the three Pallas TPU kernels of tricolo_tpu/ops/nt_xent_pallas.py:
//
//   nt_xent_fwd       <- _fwd_kernel (l.43):       per row i of zi, the
//                        diagonal logit l_ii and logsumexp_j l_ij,
//                        l = zi zj^T / tau -> (B, 2)
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
// kernels' purpose. dzi of the loss is nt_xent_bwd(zi, zj, lse_a, lse_b,
// [s_a, s_b]) and dzj is nt_xent_bwd(zj, zi, lse_b, lse_a, [s_b, s_a]); the
// single-term entries are the two-term kernel with one term compiled out
// (rows: own = zi, lse by row; cols: own = zj, oth = zi, lse by column).
//
// Bound: operations. The forward does 2 B^2 D flops, each backward 4 B^2 D
// (one logits product, one coefficient product) at 67 TFLOP/s (H100 SXM f32
// outside the tensor cores): 2.05 ms at (8192, 512), 0.5 us at (128, 512),
// where the launch floor of a few us is the practical limit. The operands
// are read once from device memory, small beside that.
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
// as zeros and are not stored, columns past B get a zero coefficient. D is
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

// ------------------------------------------------------------- forward (K4)

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

size_t fwd_smem(int D) { return (size_t)2 * TILE * (D + 4) * sizeof(float); }

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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
// own, oth (B, D); out (B, 2) for the forward and (B, D) for the
// backwards; lse* (B,); scale one float, scales two (s_row, s_col). D is a
// multiple of 64, at most 512.
extern "C" int nt_xent_fwd(const void* zi, const void* zj, void* out, int B, int D,
                           float inv_tau, void* stream) {
  if (B == 0) return 0;
  if (D % 64 != 0 || D > 512) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = allow_smem(nt_xent_fwd_kernel, fwd_smem(512), smem_set);
  if (err != cudaSuccess) return (int)err;
  nt_xent_fwd_kernel<<<(B + TILE - 1) / TILE, THREADS, fwd_smem(D), (cudaStream_t)stream>>>(
      (const float*)zi, (const float*)zj, (float*)out, B, D, inv_tau);
  return (int)cudaGetLastError();
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
