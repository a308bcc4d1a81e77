// Per-sample tile -> grid scatter, channels-last, zero background.
//
// Replaces: tricolo_tpu/ops/_graveyard/dma_tiles.py::_scatter_kernel (the
// Pallas TPU kernel: one strided DMA write per tile into a zeroed grid), in
// the per-sample form the voxel encoder runs after block 2
// (tricolo_tpu/ops/tile_sparse.py::scatter_tiles_ps):
//
//   tiles (B, k, t, t, t, C) + local ids (B, k), id = (tz*tg + ty)*tg + tx
//   -> out (B, G, G, G, C), G = t*tg; ids outside [0, tg^3) are padding and
//      are dropped; every site no tile covers is zero.
//
// Bound: memory. It is a pure copy: the least time is (bytes of tiles + ids
// + out) / 3.35 TB/s.
//
// Design: a gather, not a scatter. Pass 1 (one block per sample) writes the
// inverse map inv[b, tile] = j, or -1 where sample b has no tile. Pass 2 runs
// one thread per output element, neighbouring threads on neighbouring
// channels: it looks up the element's tile in inv and copies the tile's value
// or writes zero. Every output element is written exactly once, so there is
// no memset of the grid, no atomics, and the result is deterministic and
// bit-exact. The copy moves raw bits (2- or 4-byte words), so one kernel
// serves bf16, f16 and f32.
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
    if (id >= 0 && id < tg3) inv[b * tg3 + id] = j;
  }
}

template <typename S>
__global__ void gather_kernel(const S* __restrict__ tiles,
                              const int32_t* __restrict__ inv,
                              S* __restrict__ out, int64_t total, int k, int t,
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
    const int32_t j = inv[b * tg3 + tile];
    S v = 0;
    if (j >= 0) {
      v = tiles[((((b * k + j) * t + z % t) * t + y % t) * t + x % t) * C + c];
    }
    out[i] = v;
  }
}

template <typename S>
int launch(const void* tiles, const void* ids, void* inv, void* out, int B,
           int k, int t, int tg, int C, cudaStream_t stream) {
  const int tg3 = tg * tg * tg;
  inverse_kernel<<<B, 256, 0, stream>>>((const int32_t*)ids, (int32_t*)inv, k,
                                        tg3);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)B * tg3 * t * t * t * C;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < (1 << 30) ? want : (1 << 30));
  gather_kernel<S><<<blocks, threads, 0, stream>>>(
      (const S*)tiles, (const int32_t*)inv, (S*)out, total, k, t, tg, C);
  return (int)cudaGetLastError();
}

}  // namespace

// elem_bytes: 2 (bf16 / f16) or 4 (f32). inv: B*tg^3 int32 scratch.
extern "C" int tile_scatter(const void* tiles, const void* ids, void* inv,
                            void* out, int B, int k, int t, int tg, int C,
                            int elem_bytes, void* stream) {
  if (B == 0) return 0;
  if (elem_bytes == 2)
    return launch<uint16_t>(tiles, ids, inv, out, B, k, t, tg, C,
                            (cudaStream_t)stream);
  if (elem_bytes == 4)
    return launch<uint32_t>(tiles, ids, inv, out, B, k, t, tg, C,
                            (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
