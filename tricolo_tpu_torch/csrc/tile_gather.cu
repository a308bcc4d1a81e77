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
// neighbouring interiors are not counted. So a halo form moves more than
// its bound counts: a block-1 window (tile 8, halo 1, 4 bf16 channels)
// reads 10^3 sites for 8^3, in 80-byte rows at an 8-byte offset that touch
// four 32-byte sectors each.
//
// Design. The copy unit is a window's x-row: s sites, s*C*elem bytes,
// contiguous in the grid and in the output. It moves as vectors of V bytes
// (16, 8, 4 or 2), the widest that divides gcd(tile, halo)*C*elem bytes (so
// every row start, in the grid and in the output, and every halo edge falls
// on a vector boundary) and both pointers' alignment: the wrapper's launch
// plan picks V. A halo-0 mask row of 8 bf16 sites is one 16-byte copy, a
// halo-1 row of 4-channel bf16 sites ten 8-byte copies. A block of 256
// threads takes `tpb` consecutive output tiles (the plan: enough for about
// four vectors a thread, so a 4^3 mask tile of 16 vectors does not hold a
// block alone; in a trial of 1 to 64 tiles a block this was within a few % of
// the fastest at each of the dense plan's four gathers). Its first threads
// decode one tile id each into shared memory (the tile's first source vector,
// its window corner and the vectors of its rows that lie inside the grid on
// x); then the block walks its tiles' rows in output order, four vectors a
// thread at a time with their loads issued before their stores, so the writes
// are one contiguous run and each thread keeps four loads in flight. A
// vector's row comes from one multiply-high division by the row length and
// divisions by the window edge s, which is a template constant in the dense
// plan's four forms, (tile, halo) = (8, 1), (8, 0), (4, 1) and (4, 0); one
// generic instantiation takes any other (tile, halo) at run time. Only halo
// forms check bounds: rows outside the grid on z or y and the halo's first or
// last vectors outside it on x are written as zeros. The earlier design
// copied one site (a 2-byte copy for a bf16 mask) per thread, after three
// run-time divisions, in one block per tile. Every output element is written
// exactly once: no memset, deterministic, bit-exact. The copy moves raw bits,
// so one kernel serves bf16, f16 and f32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// n / d by multiply-high (Granlund-Montgomery): exact for 0 <= n < 2^31
// and 1 <= d < 2^31.
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

// Per tile of the block: its first source vector (row sz = sy = 0, first
// vector of the row; may lie outside the grid), its window corner on z and
// y, the vectors [lo, hi) of each row inside the grid on x; valid = 0 for
// a padding id.
struct TileInfo {
  long long base;
  int z0, y0, lo, hi, valid;
};

// Geometry in vectors of V: R a window row, RT tile*C*elem/V, RH
// halo*C*elem/V, GR a grid row (D*C*elem/V).
template <typename V, int kTile, int kHalo>
__global__ void __launch_bounds__(kThreads)
    tile_gather_kernel(const V* __restrict__ x, const int32_t* __restrict__ ids,
                       V* __restrict__ out, int T, int n_tiles, int tg, int D,
                       int tile_rt, int halo_rt, Div R, int RT, int RH,
                       long long GR, int tpb) {
  constexpr bool kFixed = kTile > 0;
  const int tile = kFixed ? kTile : tile_rt;
  const int halo = kFixed ? kHalo : halo_rt;
  const int s = tile + 2 * halo;
  const int units = s * s * (int)R.d;  // vectors a tile
  const int t0 = blockIdx.x * tpb;
  const int here = T - t0 < tpb ? T - t0 : tpb;

  __shared__ TileInfo info[kThreads];
  if (threadIdx.x < here) {
    const int32_t id = ids[t0 + threadIdx.x];
    TileInfo ti{0, 0, 0, 0, 0, 0};
    if (id >= 0 && id < n_tiles) {
      const int tg2 = tg * tg;
      const int b = id / (tg2 * tg);
      int r = id - b * tg2 * tg;
      const int tz = r / tg2;
      r -= tz * tg2;
      const int ty = r / tg;
      const int tx = r - ty * tg;
      ti.z0 = tz * tile - halo;
      ti.y0 = ty * tile - halo;
      ti.base = ((long long)b * D + ti.z0) * D * GR + ti.y0 * GR +
                (long long)tx * RT - RH;
      // x positions [tx*tile - halo, tx*tile + tile + halo) against [0, D):
      // in vectors, [tx*RT - RH, (tx + 1)*RT + RH) against [0, tg*RT).
      const int left = RH - tx * RT, right = (tx + 1) * RT + RH - tg * RT;
      ti.lo = left > 0 ? left : 0;
      ti.hi = (int)R.d - (right > 0 ? right : 0);
      ti.valid = 1;
    }
    info[threadIdx.x] = ti;
  }
  __syncthreads();

  // kUnroll vectors a thread at a time, their loads issued before their
  // stores, so that each thread keeps several loads in flight.
  V* dst = out + (long long)t0 * units;
  const int rows = s * s, total = here * units;
  for (int u0 = threadIdx.x; u0 < total; u0 += kThreads * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int u = u0 + k * kThreads;
      const int line = divide(u, R);  // the block's row: tile*s^2 + sz*s + sy
      const int r = u - line * (int)R.d;
      const int tl = line / rows;
      const int row = line - tl * rows;
      const int sz = row / s;
      const int sy = row - sz * s;
      const TileInfo& ti = info[tl < here ? tl : 0];
      bool in = u < total && ti.valid;
      if (halo > 0) {
        in = in && (unsigned)(ti.z0 + sz) < (unsigned)D &&
             (unsigned)(ti.y0 + sy) < (unsigned)D && r >= ti.lo && r < ti.hi;
      }
      v[k] = in ? x[ti.base + ((long long)sz * D + sy) * GR + r] : V{};
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (u0 + k * kThreads < total) dst[u0 + k * kThreads] = v[k];
    }
  }
}

template <typename V, int kTile, int kHalo>
int launch_form(const void* x, const void* ids, void* out, int T, int B, int D,
                int C, int tile, int halo, int elem_bytes, int tpb,
                cudaStream_t stream) {
  const int tg = D / tile;
  const int site = C * elem_bytes;
  const int s = tile + 2 * halo;
  const Div R = make_div(s * site / (int)sizeof(V));
  const int RT = tile * site / (int)sizeof(V);
  const int RH = halo * site / (int)sizeof(V);
  const long long GR = (long long)D * site / (long long)sizeof(V);
  const int blocks = (T + tpb - 1) / tpb;
  tile_gather_kernel<V, kTile, kHalo><<<blocks, kThreads, 0, stream>>>(
      (const V*)x, (const int32_t*)ids, (V*)out, T, B * tg * tg * tg, tg, D,
      tile, halo, R, RT, RH, GR, tpb);
  return (int)cudaGetLastError();
}

template <typename V>
int launch(const void* x, const void* ids, void* out, int T, int B, int D,
           int C, int tile, int halo, int elem_bytes, int tpb, int fixed,
           cudaStream_t stream) {
  if (!fixed)
    return launch_form<V, 0, 0>(x, ids, out, T, B, D, C, tile, halo,
                                elem_bytes, tpb, stream);
  if (tile == 8 && halo == 1)
    return launch_form<V, 8, 1>(x, ids, out, T, B, D, C, tile, halo,
                                elem_bytes, tpb, stream);
  if (tile == 8 && halo == 0)
    return launch_form<V, 8, 0>(x, ids, out, T, B, D, C, tile, halo,
                                elem_bytes, tpb, stream);
  if (tile == 4 && halo == 1)
    return launch_form<V, 4, 1>(x, ids, out, T, B, D, C, tile, halo,
                                elem_bytes, tpb, stream);
  if (tile == 4 && halo == 0)
    return launch_form<V, 4, 0>(x, ids, out, T, B, D, C, tile, halo,
                                elem_bytes, tpb, stream);
  return (int)cudaErrorInvalidValue;  // no fixed form for this (tile, halo)
}

}  // namespace

// elem_bytes: 2 (bf16 / f16) or 4 (f32); vec_bytes: 16, 8, 4 or 2, dividing
// gcd(tile, halo) * C * elem_bytes and the alignment of x and out;
// tiles_per_block: 1 to 256 output tiles a block, with tiles_per_block * a
// tile's bytes / vec_bytes below 2^31; fixed != 0 runs the template form of
// (tile, halo), which must be (8, 1), (8, 0), (4, 1) or (4, 0).
extern "C" int tile_gather(const void* x, const void* ids, void* out, int T,
                           int B, int D, int C, int tile, int halo,
                           int elem_bytes, int vec_bytes, int tiles_per_block,
                           int fixed, void* stream) {
  if (T == 0) return 0;
  int a = tile, b = halo;  // gcd(tile, halo); gcd(tile, 0) = tile
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  if ((elem_bytes != 2 && elem_bytes != 4) || vec_bytes <= 0 ||
      (a * C * elem_bytes) % vec_bytes != 0 || tiles_per_block < 1 ||
      tiles_per_block > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tpb = tiles_per_block;
  switch (vec_bytes) {
    case 16:
      return launch<uint4>(x, ids, out, T, B, D, C, tile, halo, elem_bytes,
                           tpb, fixed, st);
    case 8:
      return launch<uint2>(x, ids, out, T, B, D, C, tile, halo, elem_bytes,
                           tpb, fixed, st);
    case 4:
      return launch<uint32_t>(x, ids, out, T, B, D, C, tile, halo, elem_bytes,
                              tpb, fixed, st);
    case 2:
      return launch<uint16_t>(x, ids, out, T, B, D, C, tile, halo, elem_bytes,
                              tpb, fixed, st);
  }
  return (int)cudaErrorInvalidValue;
}
