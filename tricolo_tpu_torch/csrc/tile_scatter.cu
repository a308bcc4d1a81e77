// Tile -> grid scatter, channels-last, zero background: two entries.
//
// Replaces: tricolo_tpu/ops/_graveyard/dma_tiles.py::_scatter_kernel (the
// Pallas TPU kernel: one strided DMA write per tile, by global tile id, into
// a zeroed grid), in both forms the voxel encoder runs:
//
//   tile_scatter (per-sample, windowed_compact after block 2;
//   tricolo_tpu/ops/tile_sparse.py::scatter_tiles_ps):
//     tiles (B, k, t, t, t, C) + local ids (B, k), id = (tz*tg + ty)*tg + tx
//     -> out (B, G, G, G, C), G = t*tg; ids outside [0, tg^3) are padding;
//   tile_scatter_global (global, the dense-input plan after each sparse block
//   and the full windowed transfer; tile_sparse.py::scatter_tiles):
//     tiles (T, t, t, t, C) + global ids (T,), id = b*tg^3 + local id
//     -> out (B, G, G, G, C); ids outside [0, B*tg^3) are padding.
//   Padding tiles are dropped; every site no tile covers is zero.
//
// Bound: memory. It is a pure copy: the least time is (bytes of the tiles
// that land + ids + out) / 3.35 TB/s (H100 SXM data sheet).
//
// Design: a gather, not a scatter. Pass 1 writes the inverse map
// inv[b*tg^3 + tile] = the tile's row in `tiles` (b*k + j per sample, the row
// itself for global ids), or -1 where no row lands; the two entries differ
// only here. Pass 2 (scatter_pass_kernel) gives each output tile a row of
// threads (threadIdx.y picks the tile, a block holds 256 / units-per-tile
// tiles, at least one) that loads the tile's inv entry once, then walks the
// tile's (sz, sy, x-run) units in order, copying V bytes each from the row
// or writing V zero bytes. A tile's x-run (t sites of C channels) is
// contiguous in both the row and the grid, so V (16, 8, 4 or 2 bytes) is the
// widest that divides the run's t*C*elem bytes and both pointers' alignment;
// the wrapper picks it. The handoffs' x runs (256 bytes) take 16-byte
// copies, the masks' 8 or 4 bytes one copy a run. Index math is 32-bit
// (the wrapper keeps tile, row and z-plane counts below 2^31); only the two
// final unit offsets are 64-bit products, with no division in them. Every
// output byte is written exactly once: no memset of the grid, no atomics,
// deterministic, bit-exact. The copy moves raw bits, so one kernel serves
// bf16, f16 and f32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void inverse_kernel(const int32_t* __restrict__ ids,
                               int32_t* __restrict__ inv, int k, int tg3) {
  const int b = blockIdx.x;
  int32_t* row_inv = inv + (int64_t)b * tg3;
  for (int t = threadIdx.x; t < tg3; t += blockDim.x) row_inv[t] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int32_t id = ids[(int64_t)b * k + j];
    if (id >= 0 && id < tg3) row_inv[id] = b * k + j;
  }
}

__global__ void inverse_global_kernel(const int32_t* __restrict__ ids,
                                      int32_t* __restrict__ inv, int T,
                                      int n) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < T;
       r += gridDim.x * blockDim.x) {
    const int32_t id = ids[r];
    if (id >= 0 && id < n) inv[id] = r;
  }
}

// Output tile n = ((b*tg + tz)*tg + ty)*tg + tx of n_tiles = B*tg^3. In units
// of V: a tile's x-run is R units, a grid row Y = tg*R units, a z-plane
// P = G*Y units; the tile's unit j = (sz*t + sy)*R + r.
template <typename V>
__global__ void scatter_pass_kernel(const V* __restrict__ tiles,
                                    const int32_t* __restrict__ inv,
                                    V* __restrict__ out, int n_tiles, int tg,
                                    int t, int R) {
  const int Y = tg * R;
  const int P = t * tg * Y;
  const int U = t * t * R;  // units a tile
  for (int n = blockIdx.x * blockDim.y + threadIdx.y; n < n_tiles;
       n += gridDim.x * blockDim.y) {
    const int row = inv[n];
    const int tx = n % tg;
    int m = n / tg;
    const int ty = m % tg;
    m /= tg;  // b*tg + tz: the tile's first z-plane is m*t
    const int64_t origin = (int64_t)(m * t) * P + ty * t * Y + tx * R;
    const V* src = tiles + (int64_t)(row < 0 ? 0 : row) * U;
    for (int j = threadIdx.x; j < U; j += blockDim.x) {
      const int line = j / R;  // sz*t + sy
      const int r = j - line * R;
      const int sz = line / t;
      const int sy = line - sz * t;
      V v{};
      if (row >= 0) v = src[j];
      out[origin + sz * P + sy * Y + r] = v;
    }
  }
}

template <typename V>
int launch_pass(const void* tiles, const void* inv, void* out, int B, int t,
                int tg, int C, int elem_bytes, cudaStream_t stream) {
  const int R = t * C * elem_bytes / (int)sizeof(V);
  const int U = t * t * R;
  const int n_tiles = B * tg * tg * tg;
  if (U == 0 || n_tiles == 0) return 0;  // an empty grid
  const int bx = U < kThreads ? U : kThreads;
  const int by = kThreads / bx;
  const int want = (n_tiles + by - 1) / by;
  const int blocks = want < (1 << 30) ? want : (1 << 30);
  scatter_pass_kernel<V><<<blocks, dim3(bx, by), 0, stream>>>(
      (const V*)tiles, (const int32_t*)inv, (V*)out, n_tiles, tg, t, R);
  return (int)cudaGetLastError();
}

int scatter_pass(const void* tiles, const void* inv, void* out, int B, int t,
                 int tg, int C, int elem_bytes, int vec_bytes,
                 cudaStream_t stream) {
  switch (vec_bytes) {
    case 16:
      return launch_pass<uint4>(tiles, inv, out, B, t, tg, C, elem_bytes,
                                stream);
    case 8:
      return launch_pass<uint2>(tiles, inv, out, B, t, tg, C, elem_bytes,
                                stream);
    case 4:
      return launch_pass<uint32_t>(tiles, inv, out, B, t, tg, C, elem_bytes,
                                   stream);
    case 2:
      return launch_pass<uint16_t>(tiles, inv, out, B, t, tg, C, elem_bytes,
                                   stream);
  }
  return (int)cudaErrorInvalidValue;
}

bool bad_sizes(int t, int C, int elem_bytes, int vec_bytes) {
  return (elem_bytes != 2 && elem_bytes != 4) || vec_bytes <= 0 ||
         (t * C * elem_bytes) % vec_bytes != 0;
}

}  // namespace

// elem_bytes: 2 (bf16 / f16) or 4 (f32); vec_bytes: 16, 8, 4 or 2, dividing
// t * C * elem_bytes and the alignment of tiles and out. inv: B*tg^3 int32
// scratch.
extern "C" int tile_scatter(const void* tiles, const void* ids, void* inv,
                            void* out, int B, int k, int t, int tg, int C,
                            int elem_bytes, int vec_bytes, void* stream) {
  if (B == 0) return 0;
  if (bad_sizes(t, C, elem_bytes, vec_bytes)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  inverse_kernel<<<B, kThreads, 0, st>>>((const int32_t*)ids, (int32_t*)inv,
                                         k, tg * tg * tg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return scatter_pass(tiles, inv, out, B, t, tg, C, elem_bytes, vec_bytes, st);
}

// Global ids: tiles (T, t, t, t, C), ids (T,). inv: B*tg^3 int32 scratch.
extern "C" int tile_scatter_global(const void* tiles, const void* ids,
                                   void* inv, void* out, int B, int T, int t,
                                   int tg, int C, int elem_bytes,
                                   int vec_bytes, void* stream) {
  if (B == 0) return 0;
  if (bad_sizes(t, C, elem_bytes, vec_bytes)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = B * tg * tg * tg;
  cudaError_t err = cudaMemsetAsync(inv, 0xFF, (size_t)n * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  if (T > 0) {
    const int want = (T + kThreads - 1) / kThreads;
    inverse_global_kernel<<<want < 65536 ? want : 65536, kThreads, 0, st>>>(
        (const int32_t*)ids, (int32_t*)inv, T, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return scatter_pass(tiles, inv, out, B, t, tg, C, elem_bytes, vec_bytes, st);
}
