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
// Bound: memory. It is a pure copy: the least time is (bytes of tiles + ids
// + out) / 3.35 TB/s.
//
// Design: a gather, not a scatter. Pass 1 writes the inverse map
// inv[b*tg^3 + tile] = the tile's row in `tiles` (b*k + j per sample, the row
// itself for global ids), or -1 where no row lands; the two entries differ
// only here. Pass 2 runs one thread per output element, neighbouring threads
// on neighbouring channels: it looks up the element's tile in inv and copies
// the row's value or writes zero. Every output element is written exactly
// once, so there is no memset of the grid, no atomics, and the result is
// deterministic and bit-exact. The copy moves raw bits (2- or 4-byte words),
// so one kernel serves bf16, f16 and f32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void inverse_kernel(const int32_t* __restrict__ ids,
                               int32_t* __restrict__ inv, int k, int tg3) {
  const int64_t b = blockIdx.x;
  for (int t = threadIdx.x; t < tg3; t += blockDim.x) inv[b * tg3 + t] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int32_t id = ids[b * k + j];
    if (id >= 0 && id < tg3) inv[b * tg3 + id] = (int32_t)(b * k + j);
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

template <typename S>
__global__ void gather_kernel(const S* __restrict__ tiles,
                              const int32_t* __restrict__ inv,
                              S* __restrict__ out, int64_t total, int t,
                              int tg, int C) {
  const int64_t G = (int64_t)t * tg;
  const int64_t tg3 = (int64_t)tg * tg * tg;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t c = i % C;
    int64_t p = i / C;
    const int64_t x = p % G;
    p /= G;
    const int64_t y = p % G;
    p /= G;
    const int64_t z = p % G;
    const int64_t b = p / G;
    const int64_t tile = ((z / t) * tg + y / t) * tg + x / t;
    const int64_t row = inv[b * tg3 + tile];
    S v = 0;
    if (row >= 0) {
      v = tiles[(((row * t + z % t) * t + y % t) * t + x % t) * C + c];
    }
    out[i] = v;
  }
}

// Pass 2 over the filled inverse map.
template <typename S>
int launch_gather(const void* tiles, const void* inv, void* out, int B, int t,
                  int tg, int C, cudaStream_t stream) {
  const int64_t total = (int64_t)B * tg * tg * tg * t * t * t * C;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < (1 << 30) ? want : (1 << 30));
  gather_kernel<S><<<blocks, threads, 0, stream>>>(
      (const S*)tiles, (const int32_t*)inv, (S*)out, total, t, tg, C);
  return (int)cudaGetLastError();
}

int gather_by_size(const void* tiles, const void* inv, void* out, int B, int t,
                   int tg, int C, int elem_bytes, cudaStream_t stream) {
  if (elem_bytes == 2)
    return launch_gather<uint16_t>(tiles, inv, out, B, t, tg, C, stream);
  if (elem_bytes == 4)
    return launch_gather<uint32_t>(tiles, inv, out, B, t, tg, C, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// elem_bytes: 2 (bf16 / f16) or 4 (f32). inv: B*tg^3 int32 scratch.
extern "C" int tile_scatter(const void* tiles, const void* ids, void* inv,
                            void* out, int B, int k, int t, int tg, int C,
                            int elem_bytes, void* stream) {
  if (B == 0) return 0;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  inverse_kernel<<<B, 256, 0, st>>>((const int32_t*)ids, (int32_t*)inv, k,
                                    tg * tg * tg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return gather_by_size(tiles, inv, out, B, t, tg, C, elem_bytes, st);
}

// Global ids: tiles (T, t, t, t, C), ids (T,). inv: B*tg^3 int32 scratch.
extern "C" int tile_scatter_global(const void* tiles, const void* ids,
                                   void* inv, void* out, int B, int T, int t,
                                   int tg, int C, int elem_bytes,
                                   void* stream) {
  if (B == 0) return 0;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = B * tg * tg * tg;
  cudaError_t err = cudaMemsetAsync(inv, 0xFF, (size_t)n * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  if (T > 0) {
    const int threads = 256;
    const int want = (T + threads - 1) / threads;
    inverse_global_kernel<<<want < 65536 ? want : 65536, threads, 0, st>>>(
        (const int32_t*)ids, (int32_t*)inv, T, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return gather_by_size(tiles, inv, out, B, t, tg, C, elem_bytes, st);
}
