// Halo'd tile gather from a dense channels-last grid, by global tile id.
//
// Replaces: tricolo_tpu/ops/_graveyard/dma_tiles.py::_gather_kernel (the
// Pallas TPU kernel: one strided DMA per tile out of a zero-padded grid),
// the data movement of tricolo_tpu/ops/tile_sparse.py::gather_tiles that the
// dense-input tile-sparse plan runs before each sparse block:
//
//   x (B, D, D, D, C) + ids (T,), id = b*tg^3 + (tz*tg + ty)*tg + tx
//   -> out (T, s, s, s, C), s = tile + 2*halo, tg = D / tile;
//   window t covers grid positions [tz*tile - halo, tz*tile + tile + halo) on
//   each axis; sites outside the grid read zero; ids outside [0, B*tg^3) are
//   padding and give all-zero tiles.
//
// Bound: memory. A pure copy: the least time is (bytes written + bytes of the
// active tiles' interiors read once + ids) / 3.35 TB/s; the halo re-reads of
// neighbouring interiors are not counted.
//
// Design: one block per output tile (grid-stride over tiles). Each block
// loads its tile id and decodes it once; its threads walk the output tile in
// its contiguous (sz, sy, sx, c) order, so the writes are coalesced, and each
// thread copies one vector of V bytes: the site's source position is decoded,
// bounds-checked against the grid, and the vector copied or zero written.
// V (16, 8, 4 or 2 bytes) is the widest that divides a site's C * elem bytes
// and both pointers' alignment (the wrapper picks it): a block-1 site of
// 4 bf16 channels is one 8-byte copy, a block-2 site of 32 bf16 channels four
// 16-byte copies. Index math is 32-bit when every element offset fits below
// 2^31 (the flagship shapes), 64-bit otherwise. Every output element is
// written exactly once: no memset, deterministic, bit-exact. The copy moves
// raw bits, so one kernel serves bf16, f16 and f32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V, typename I>
__global__ void tile_gather_kernel(const V* __restrict__ x,
                                   const int32_t* __restrict__ ids,
                                   V* __restrict__ out, int T, int B, int D,
                                   int tile, int halo, int units) {
  const int tg = D / tile;
  const int tg3 = tg * tg * tg;
  const int s = tile + 2 * halo;
  const int per_tile = s * s * s * units;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const int32_t id = ids[t];
    const bool valid = id >= 0 && id < B * tg3;
    int b = 0, z0 = 0, y0 = 0, x0 = 0;
    if (valid) {
      b = id / tg3;
      int r = id - b * tg3;
      const int tz = r / (tg * tg);
      r -= tz * tg * tg;
      const int ty = r / tg;
      const int tx = r - ty * tg;
      z0 = tz * tile - halo;
      y0 = ty * tile - halo;
      x0 = tx * tile - halo;
    }
    const V* src = x + (I)b * D * D * D * units;
    V* dst = out + (I)t * per_tile;
    for (int u = threadIdx.x; u < per_tile; u += blockDim.x) {
      V v{};
      if (valid) {
        const int site = u / units;
        const int part = u - site * units;
        const int sz = site / (s * s);
        const int rem = site - sz * s * s;
        const int sy = rem / s;
        const int sx = rem - sy * s;
        const int z = z0 + sz, y = y0 + sy, xx = x0 + sx;
        if ((unsigned)z < (unsigned)D && (unsigned)y < (unsigned)D &&
            (unsigned)xx < (unsigned)D) {
          v = src[(((I)z * D + y) * D + xx) * units + part];
        }
      }
      dst[u] = v;
    }
  }
}

template <typename V>
int launch(const void* x, const void* ids, void* out, int T, int B, int D,
           int C, int tile, int halo, int elem_bytes, cudaStream_t stream) {
  const int units = C * elem_bytes / (int)sizeof(V);
  const int s = tile + 2 * halo;
  const int per_tile = s * s * s * units;
  int threads = 256;
  if (per_tile < threads) threads = ((per_tile + 31) / 32) * 32;
  const int blocks = T < (1 << 30) ? T : (1 << 30);
  const int64_t in_units = (int64_t)B * D * D * D * units;
  const int64_t out_units = (int64_t)T * per_tile;
  if (in_units < (1LL << 31) && out_units < (1LL << 31)) {
    tile_gather_kernel<V, int32_t><<<blocks, threads, 0, stream>>>(
        (const V*)x, (const int32_t*)ids, (V*)out, T, B, D, tile, halo, units);
  } else {
    tile_gather_kernel<V, int64_t><<<blocks, threads, 0, stream>>>(
        (const V*)x, (const int32_t*)ids, (V*)out, T, B, D, tile, halo, units);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// elem_bytes: 2 (bf16 / f16) or 4 (f32); vec_bytes: 16, 8, 4 or 2, dividing
// C * elem_bytes and the alignment of x and out.
extern "C" int tile_gather(const void* x, const void* ids, void* out, int T,
                           int B, int D, int C, int tile, int halo,
                           int elem_bytes, int vec_bytes, void* stream) {
  if (T == 0) return 0;
  if ((elem_bytes != 2 && elem_bytes != 4) || (C * elem_bytes) % vec_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec_bytes) {
    case 16:
      return launch<uint4>(x, ids, out, T, B, D, C, tile, halo, elem_bytes, st);
    case 8:
      return launch<uint2>(x, ids, out, T, B, D, C, tile, halo, elem_bytes, st);
    case 4:
      return launch<uint32_t>(x, ids, out, T, B, D, C, tile, halo, elem_bytes,
                              st);
    case 2:
      return launch<uint16_t>(x, ids, out, T, B, D, C, tile, halo, elem_bytes,
                              st);
  }
  return (int)cudaErrorInvalidValue;
}
