// Weight gradient of the VALID 3^3 stride-1 tile convolution at block 1's
// form, bf16, channels last: kernel K9.
//
// Replaces: no TPU kernel. The JAX package leaves this convolution and its
// backward to XLA (tricolo_tpu/models/voxel_cnn.py: block 1 on the window
// rows and the dense plan's first tile-sparse block). K9 was added because
// cuDNN's pick for it on the card, sm90_xmma_wgrad_indexed_implicit_gemm,
// ran at about 2% of its memory bound and took a third of every 64^3
// training step of the port's benchmark (42% of the busy time at 128^3).
//
//   dy (R, D, D, D, 32) bf16, NDHWC, D = S - 2; x (R, S, S, S, 4) bf16, NDHWC
//   -> dw (32, 4, 3, 3, 3) bf16,
//   dw[o, c, t] = sum over rows r and positions p in D^3 of
//                 dy[r, p, o] * x[r, p + t, c]      (f32 sums, one cast)
//
// Forms (template instances): S = 14, block 1 on the halo-3 window rows;
// S = 10, block 1 on halo-1 rows and the dense plan's first tile-sparse
// block. Any other form is refused (cudaErrorInvalidValue). The fourth
// input channel (the zero pad of RGB) is computed like the others.
//
// Bound: device memory. An S = 14 row reads 110,592 bytes of dy and 21,952
// of x for 27 x 4 x 32 x 2 = 6,912 FLOPs a position (~90 FLOP/byte, under
// the card's ~295): at R = 17,536 rows, 2.32 GB (0.694 ms at 3.35 TB/s)
// against 0.21 ms of tensor-core time; the same FLOPs on the CUDA cores in
// f32 would take ~3.1 ms, so the products run on the tensor cores.
//
// Design: a GEMM with a huge K. M = 32 output channels (two m16 tiles), N =
// 27 taps x 4 channels, K = the R x D^3 positions, split over a persistent
// grid of one block an SM; each block takes a contiguous range of
// (row, Z-plane chunk) units and streams them.
//
// * A unit is Z of a row's D dy planes (a contiguous 36,864 bytes at S = 14)
//   and the Z + 2 x planes they touch. All 256 threads copy it by cp.async
//   into a ring of three slots: dy in 16-byte pieces, each position's four
//   pieces XOR-swizzled by bits 1-2 of the position so that ldmatrix reads
//   eight positions without a bank conflict; x twice, as it is (E) and
//   shifted by one 8-byte site (O), so that the pair of sites (s, s + 1)
//   starts on a 16-byte boundary in E for even s and in O for odd s. O sits
//   48 bytes (mod 128) past E, which puts four E rows and four O rows on
//   the 32 banks. The im2col is never written: an n8 tile of B is two
//   neighbouring taps (tx, tx + 1) x 4 channels, one 16-byte row a
//   position, read by ldmatrix.trans at the position's pair of sites plus
//   the tap's constant offset. Nine (tz, ty) x {tx 0-1, tx 2 and a junk
//   tap 3} make 18 n8 tiles (144 columns, 108 of them used).
// * mma.sync m16n8k16 (bf16 in, f32 sums): each warp owns a share of a
//   unit's k16 steps (warps w and w + 4 share a scheduler and together take
//   9 of a unit's 36 steps at S = 14), loads dy's two A fragments once a
//   step (ldmatrix.trans: dy is K x M with M contiguous) and runs them
//   against the 18 B tiles: 36 products a step into 144 f32 registers, the
//   warp's whole 32 x 144 tile, held over every unit of the block.
// * The reduction is deterministic: the warps' tiles are added in shared
//   memory in warp order and written as the block's f32 partial into a
//   scratch buffer the wrapper allocates; a second kernel adds the partials
//   in block order and casts once to bf16. No atomics: two calls on the
//   same input on the same card give the same bits.
// * Offsets are 64-bit: at 128^3 dy holds 5.07e9 elements, and one launch
//   covers what cuDNN ran in three batch chunks. The kernel allocates
//   nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int S_, int Z_>
struct Form {
  static constexpr int S = S_, Z = Z_;
  static constexpr int CIN = 4, COUT = 32;
  static constexpr int D = S - 2;                   // dy's edge
  static constexpr int PLANE = D * D;               // dy positions a plane
  static constexpr int CHUNKS = D / Z;              // units a row
  static constexpr int KSTEPS = Z * PLANE / 16;     // k16 steps a unit
  static constexpr int XSITES = (Z + 2) * S * S;    // x sites a unit
  static constexpr int DYB = Z * PLANE * COUT * 2;  // dy bytes a unit
  static constexpr int XB = XSITES * CIN * 2;       // x bytes a unit
  static constexpr int E_AT = DYB;                  // x as it is
  static constexpr int O_AT = DYB + (XB + 127) / 128 * 128 + 48;  // x one site on
  static constexpr int SLOT = (O_AT + XB + 16 + 127) / 128 * 128;
  static constexpr int SLOTS = 3;
  static constexpr int WARPS = 8, THREADS = 32 * WARPS;
  static constexpr int OUT = COUT * CIN * 27;       // dw elements
  static constexpr int SMEM = SLOTS * SLOT;
  static constexpr long long DY_ROW = 1ll * D * D * D * COUT * 2;
  static constexpr long long X_ROW = 1ll * S * S * S * CIN * 2;
  static constexpr long long X_CHUNK = 1ll * Z * S * S * CIN * 2;
  static_assert(S % 2 == 0, "a site's parity is its x coordinate's");
  static_assert(D % Z == 0 && PLANE % 16 == 0, "whole k16 steps a plane");
  static_assert(DYB % 128 == 0, "E starts a bank row");
  static_assert(SMEM <= 232448 && WARPS * OUT * 4 <= SMEM, "shared memory of one block");
};

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t address) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(address)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start the copy of unit `unit` into the slot at `slot` (one commit group,
// empty past `end`).
template <class F>
__device__ __forceinline__ void load_unit(uint32_t slot, const char* dy, const char* x,
                                          int unit, int end, int tid) {
  if (unit < end) {
    const long long row = unit / F::CHUNKS;
    const int chunk = unit % F::CHUNKS;
    const char* dsrc = dy + row * F::DY_ROW + static_cast<long long>(chunk) * F::DYB;
    for (int i = tid; i < F::DYB / 16; i += F::THREADS) {
      const int q = i >> 2, c = i & 3;
      cp_async16(slot + q * 64 + ((c ^ ((q >> 1) & 3)) << 4), dsrc + 16 * i);
    }
    const char* xsrc = x + row * F::X_ROW + chunk * F::X_CHUNK;
    for (int i = tid; i < F::XB / 16; i += F::THREADS)
      cp_async16(slot + F::E_AT + 16 * i, xsrc + 16 * i);
    for (int i = tid; i < F::XSITES; i += F::THREADS)
      cp_async8(slot + F::O_AT + 8 + 8 * i, xsrc + 8 * i);
  }
  cp_async_commit();
}

template <class F>
__global__ void __launch_bounds__(F::THREADS, 1)
    conv3d_wgrad_kernel(const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ x,
                        float* __restrict__ partial, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long units = static_cast<long long>(rows) * F::CHUNKS;
  const int first = static_cast<int>(units * blockIdx.x / gridDim.x);
  const int end = static_cast<int>(units * (blockIdx.x + 1) / gridDim.x);
  const uint32_t base = shared_address(smem);
  const char* dyb = reinterpret_cast<const char*>(dy);
  const char* xb = reinterpret_cast<const char*>(x);

  // The 8 bytes past each slot's O copy: read only into the junk tap.
  if (tid < F::SLOTS)
    *reinterpret_cast<uint2*>(smem + tid * F::SLOT + F::O_AT + 8 + 8 * F::XSITES) =
        make_uint2(0u, 0u);
#pragma unroll
  for (int s = 0; s < F::SLOTS - 1; ++s)
    load_unit<F>(base + s * F::SLOT, dyb, xb, first + s, end, tid);

  float acc[2][18][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 18; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
                                        acc[mt][nt][3] = 0.f;

  // ldmatrix's lane roles. A (dy, stored K x M): matrix lane / 8 is (m half
  // (lane / 8) % 2, k half lane / 16). B (x pairs, stored K x N): matrix
  // lane / 8 is (k half (lane / 8) % 2, tile lane / 16 of the pair).
  const int qa = (lane & 7) + 8 * (lane >> 4), ca = (lane >> 3) & 1;
  const int qb = (lane & 7) + 8 * ((lane >> 3) & 1), h = lane >> 4;

  int slot_i = 0;
  for (int u = first; u < end; ++u) {
    cp_async_wait<F::SLOTS - 2>();
    __syncthreads();  // unit u is in; every warp is done with unit u - 1
    load_unit<F>(base + ((slot_i + F::SLOTS - 1) % F::SLOTS) * F::SLOT, dyb, xb,
                 u + F::SLOTS - 1, end, tid);
    const uint32_t slot = base + slot_i * F::SLOT;
    slot_i = slot_i + 1 == F::SLOTS ? 0 : slot_i + 1;
    for (int ks = warp; ks < F::KSTEPS; ks += F::WARPS) {
      const int q = 16 * ks + qa;
      const int swz = (q >> 1) & 3;
      uint32_t a[2][4];
      ldmatrix_x4_trans(a[0], slot + q * 64 + ((ca ^ swz) << 4));
      ldmatrix_x4_trans(a[1], slot + q * 64 + (((2 + ca) ^ swz) << 4));
      const int p = 16 * ks + qb;
      const int pz = p / F::PLANE, pr = p % F::PLANE;
      const int py = pr / F::D, px = pr % F::D;
      const int site = (pz * F::S + py) * F::S + px;
      const uint32_t xrow = slot + ((px & 1) ? F::O_AT + 8 : F::E_AT) + 8 * site + 16 * h;
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, xrow + 8 * ((i / 3) * F::S * F::S + (i % 3) * F::S));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * i], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * i + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // The warps' tiles into shared memory by dw index, then added in warp
  // order. This lane's accumulator rows are channels o = 16 mt + lane / 4
  // (+ 8), its columns n = 2 (lane % 4) + {0, 1} of tile nt = 2 (tz, ty) +
  // j: tap tx = 2 j + n / 4 (3 is the junk tap), input channel n % 4.
  float* red = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 18; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 16 * mt + g + 8 * (e >> 1), n = 2 * t + (e & 1);
        const int tx = 2 * (nt & 1) + (n >> 2), tap = 3 * (nt >> 1) + tx;
        if (tx < 3) red[warp * F::OUT + (o * F::CIN + (n & 3)) * 27 + tap] = acc[mt][nt][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < F::OUT; i += F::THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < F::WARPS; ++w) sum += red[w * F::OUT + i];
    partial[static_cast<long long>(blockIdx.x) * F::OUT + i] = sum;
  }
}

// dw[i] = bf16(sum over blocks b in order of partial[b, i]): a block takes
// 32 outputs, its 8 warps' lanes add every 8th partial from their own in
// order, and lane (0, i) adds the eight in warp order.
constexpr int REDUCE_OUT = 32, REDUCE_SPLIT = 8;

__global__ void __launch_bounds__(REDUCE_OUT * REDUCE_SPLIT)
    conv3d_wgrad_reduce_kernel(const float* __restrict__ partial, __nv_bfloat16* __restrict__ dw,
                               int blocks, int out) {
  __shared__ float part[REDUCE_SPLIT][REDUCE_OUT];
  const int i = blockIdx.x * REDUCE_OUT + threadIdx.x, split = threadIdx.y;
  float sum = 0.f;
  if (i < out) {
#pragma unroll 4
    for (int b = split; b < blocks; b += REDUCE_SPLIT)
      sum += partial[static_cast<long long>(b) * out + i];
  }
  part[split][threadIdx.x] = sum;
  __syncthreads();
  if (split == 0 && i < out) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < REDUCE_SPLIT; ++k) total += part[k][threadIdx.x];
    dw[i] = __float2bfloat16_rn(total);
  }
}

// The main kernel on min(`blocks`, units) blocks, then the reduction of
// their partials. `partial` holds `blocks` x 3,456 floats.
template <class F>
int launch(const void* dy, const void* x, void* partial, void* dw, int rows, int blocks,
           cudaStream_t stream) {
  const long long units = static_cast<long long>(rows) * F::CHUNKS;
  if (rows <= 0 || blocks <= 0 || units >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = units < blocks ? static_cast<int>(units) : blocks;
  auto kernel = conv3d_wgrad_kernel<F>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, F::THREADS, F::SMEM, stream>>>(static_cast<const __nv_bfloat16*>(dy),
                                                static_cast<const __nv_bfloat16*>(x),
                                                static_cast<float*>(partial), rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3d_wgrad_reduce_kernel<<<(F::OUT + REDUCE_OUT - 1) / REDUCE_OUT,
                               dim3(REDUCE_OUT, REDUCE_SPLIT), 0, stream>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(dw), grid, F::OUT);
  return static_cast<int>(cudaGetLastError());
}

using Halo3 = Form<14, 4>;
using Halo1 = Form<10, 8>;

}  // namespace

// dw (32, 4, 3, 3, 3) from dy (rows, s-2, s-2, s-2, 32) and x (rows, s, s,
// s, 4), NDHWC, on the current device, with `blocks` x 3,456 floats of
// scratch at `partial` (blocks: the device's SM count); returns a
// cudaError_t.
extern "C" int conv3d_wgrad(const void* dy, const void* x, void* partial, void* dw, int rows,
                            int s, int cin, int cout, int blocks, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (cin != 4 || cout != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (s == 14) return launch<Halo3>(dy, x, partial, dw, rows, blocks, st);
  if (s == 10) return launch<Halo1>(dy, x, partial, dw, rows, blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
