// Input gradient of the VALID 3^3 stride-1 tile convolution, bf16, channels
// last: kernel K8.
//
// Replaces: no TPU kernel. The JAX package leaves this convolution and its
// backward to XLA (tricolo_tpu/models/voxel_cnn.py: block 2 on the halo-3
// window rows, the dense plan's tile-sparse blocks). K8 was added because
// cuDNN's heuristic picks a direct dgrad kernel for it
// (dgrad2d_grouped_direct_kernel) that ran at about 2,000 times its bound
// and took two thirds of every training step of the port's benchmark.
//
//   dy (R, D, D, D, Cout) bf16, NDHWC, D = S - 2; w (Cout, Cin, 3, 3, 3)
//   -> dx (R, S, S, S, Cin) bf16, NDHWC,
//   dx[r, q, c] = sum over taps t in 3^3 with p = q - t in D^3 and over o of
//                 dy[r, p, o] * w[o, c, t]      (f32 sums, one cast to bf16)
//
// Forms (template instances): (S, Cin, Cout) = (6, 32, 64), block 2 of the
// window rows and of the dense plan; (4, 64, 128), the dense plan's third
// tile-sparse block. Any other form is refused (cudaErrorInvalidValue).
//
// Bound: the tensor cores, barely. A block-2 row is 64 x 64 x 32 x 27 x 2 =
// 7.08 MFLOP against 8,192 bytes of dy read and 13,824 of dx written: at R =
// 17,536 rows, 124 GFLOP (0.126 ms at 989 TFLOP/s bf16) and 386 MB (0.115
// ms at 3.35 TB/s).
//
// Design: the scatter form (col2im). Per row, P = dy_row (D^3 x Cout) times
// the taps' weights (Cout x 27 Cin) is the true work only; each tap's slice
// of P is added into a (S^3 x Cin) f32 tile in shared memory at its shift,
// and the tile is cast to bf16 and written once. The gather form (dx rows as
// the GEMM's M, zero taps past the edges) would do 3.4-4 times the work.
//
// * The weights stay in shared memory: a block holds the 27 taps for a chunk
//   of CC input channels, 27 x Cout x CC bf16 = 110,592 bytes in both forms
//   (CC = 32 at Cout 64, 16 at Cout 128; the grid's y runs over the chunks).
//   The wrapper repacks w once a call into the order the tensor cores'
//   B fragments take it ("fragment-major": per tap, 8-channel group and pair
//   of k16 steps, one 16-byte word a lane), so a warp reads a tap's B
//   fragments as 512 contiguous bytes, with no conflict and no ldmatrix.
// * A team of CC/8 warps takes a set of M = 16 MT positions (64 positions,
//   one block-2 row; or 4 rows of 8 at the third block), a persistent loop
//   over the sets, two teams a block, one block an SM (212,480 / 192,512
//   bytes of shared memory). Each team streams its sets through a two-slot
//   ring by cp.async (16-byte chunks, XOR-swizzled by the position's low
//   three bits so that ldmatrix reads without bank conflicts; positions past
//   the last row are zero-filled), and holds a set's A fragments (dy) in 64
//   registers a thread.
// * mma.sync m16n8k16 (bf16 in, f32 sums): each warp owns 8 input channels
//   and runs, for each tap, its MT x Cout/16 products into a 16 MT x 8 f32
//   accumulator. Owning channels is what makes the fold cheap: no other
//   warp ever touches a warp's columns of the tile, so the fold needs no
//   atomics and no barrier across warps, only __syncwarp between taps
//   (within one tap, position -> position + shift is one-to-one). wgmma
//   splits its 64 rows over a warpgroup's four warps instead, so its fold
//   would need a barrier of the warpgroup for each tap, or shared atomics.
//   The tap after the current one is multiplied before the current one is
//   folded, so the tensor cores and the shared-memory pipe overlap.
// * The fold is a float2 read-add-write at a lane's precomputed site plus
//   the tap's constant offset. A site's Cin-chunk is padded to CC + 8 words,
//   which puts a half-warp's 16 float2 on 32 distinct banks at block 2.
// * The epilogue: each warp reads its columns, casts them to bf16, stores
//   16 bytes a site and writes zeros back for the next set. The kernel
//   allocates nothing; every dx element is written exactly once. No atomics:
//   the result is the same from launch to launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int S_, int CIN_, int COUT_>
struct Form {
  static constexpr int S = S_, CIN = CIN_, COUT = COUT_;
  static constexpr int D = S - 2;              // dy's edge
  static constexpr int P = D * D * D;          // dy positions a row
  static constexpr int Q = S * S * S;          // dx sites a row
  static constexpr int CC = COUT == 64 ? 32 : 16;  // input channels a block
  static constexpr int NCH = CIN / CC;         // channel chunks (grid y)
  static constexpr int MT = 256 / COUT;        // m16 tiles a set
  static constexpr int M = 16 * MT;            // positions a set
  static constexpr int G = M / P;              // rows a set
  static constexpr int KS = COUT / 16;         // k16 steps
  static constexpr int TEAM = CC / 8;          // warps a team, 8 channels each
  static constexpr int TEAMS = 2;              // teams a block
  static constexpr int TEAM_THREADS = TEAM * 32;
  static constexpr int THREADS = TEAMS * TEAM_THREADS;
  static constexpr int SD = CC + 8;            // f32 words a dx site in the tile
  static constexpr int ROWB = COUT * 2;        // bytes a dy position
  static constexpr int CHUNKS = ROWB / 16;     // 16-byte chunks a dy position
  static constexpr int SLOT = M * ROWB;        // bytes a ring slot
  static constexpr int WB = 27 * COUT * CC * 2;  // bytes of a block's weights
  static constexpr int DXB = G * Q * SD * 4;   // bytes of a team's dx tile
  static constexpr int TEAM_BYTES = 2 * SLOT + DXB;
  static constexpr int SMEM = WB + TEAMS * TEAM_BYTES;
  static_assert(M % P == 0 && CIN % CC == 0, "a set holds whole rows");
  static_assert(MT * KS * 4 == 64, "64 A registers a thread");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past src_bytes (0 or 16) are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A barrier of one team's threads (named barrier 1 + team).
__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t address) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start the copy of set `set` into the ring slot at `slot` (one commit
// group, empty past the last set).
template <class F>
__device__ __forceinline__ void load_set(uint32_t slot, const __nv_bfloat16* dy, int set,
                                         int sets, int rows, int tt) {
  if (set < sets) {
    const long long first = static_cast<long long>(set) * F::M;
    const long long limit = static_cast<long long>(rows) * F::P;
    const char* base = reinterpret_cast<const char*>(dy);
#pragma unroll
    for (int k = 0; k < F::M * F::CHUNKS / F::TEAM_THREADS; ++k) {
      const int i = tt + k * F::TEAM_THREADS;
      const int pos = i / F::CHUNKS, c = i % F::CHUNKS;
      const long long at = first + pos;
      const bool live = at < limit;
      cp_async16(slot + pos * F::ROWB + ((c ^ (pos & 7)) << 4),
                 base + (live ? at * F::ROWB + c * 16 : 0), live ? 16 : 0);
    }
  }
  cp_async_commit();
}

// One tap's products: acc[mt] = dy(set, m16 tile mt) x w(tap, this warp's
// 8 channels). `wl`: this lane's first B word of the warp's channel group.
template <class F>
__device__ __forceinline__ void tap_product(float (&acc)[F::MT][4],
                                            uint32_t (&a)[F::MT][F::KS][4],
                                            const uint4* wl, int tap) {
  uint4 b[F::KS / 2];
#pragma unroll
  for (int u = 0; u < F::KS / 2; ++u) b[u] = wl[(tap * F::TEAM * (F::KS / 2) + u) * 32];
#pragma unroll
  for (int mt = 0; mt < F::MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < F::KS; ++ks) {
    const uint4& w = b[ks >> 1];
    const uint32_t b0 = (ks & 1) ? w.z : w.x;
    const uint32_t b1 = (ks & 1) ? w.w : w.y;
#pragma unroll
    for (int mt = 0; mt < F::MT; ++mt) mma_bf16(acc[mt], a[mt][ks], b0, b1);
  }
}

template <class F>
__global__ void __launch_bounds__(F::THREADS, 1)
    conv3d_dgrad_kernel(const __nv_bfloat16* __restrict__ dy, const uint4* __restrict__ wpk,
                        __nv_bfloat16* __restrict__ dx, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp / F::TEAM, wc = warp % F::TEAM;
  const int tt = threadIdx.x - team * F::TEAM_THREADS;
  const int sets = (rows + F::G - 1) / F::G;
  const int stride = gridDim.x * F::TEAMS;
  int set = blockIdx.x * F::TEAMS + team;

  const uint32_t weights = shared_address(smem);
  unsigned char* mine_bytes = smem + F::WB + team * F::TEAM_BYTES;
  const uint32_t ring = shared_address(mine_bytes);
  float* tile = reinterpret_cast<float*>(mine_bytes + 2 * F::SLOT);
  float* cols = tile + 8 * wc;  // this warp's 8 channels of every site

  // The block's weights, once; then the team's first two sets.
  const char* wsrc = reinterpret_cast<const char*>(wpk) + static_cast<size_t>(blockIdx.y) * F::WB;
  for (int i = threadIdx.x; i < F::WB / 16; i += F::THREADS)
    cp_async16(weights + 16 * i, wsrc + 16 * i, 16);
  cp_async_commit();
  load_set<F>(ring, dy, set, sets, rows, tt);
  load_set<F>(ring + F::SLOT, dy, set + stride, sets, rows, tt);

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int site = lane; site < F::G * F::Q; site += 32) {
    float4* p = reinterpret_cast<float4*>(cols + site * F::SD);
    p[0] = zero;
    p[1] = zero;
  }

  // This lane's accumulator rows are positions 16 mt + 8 h + lane / 4 of a
  // set, its columns channels 2 (lane % 4) + {0, 1} of the warp's 8: the
  // tile word of each at tap (0, 0, 0).
  int site_word[F::MT][2];
#pragma unroll
  for (int mt = 0; mt < F::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = 16 * mt + 8 * h + (lane >> 2);
      const int gi = pos / F::P, pl = pos % F::P;
      const int pz = pl / (F::D * F::D), py = (pl / F::D) % F::D, px = pl % F::D;
      site_word[mt][h] = (gi * F::Q + (pz * F::S + py) * F::S + px) * F::SD + 8 * wc +
                         2 * (lane & 3);
    }
  }
  const uint4* wl = reinterpret_cast<const uint4*>(smem) + wc * (F::KS / 2) * 32 + lane;
  const int channel = blockIdx.y * F::CC + 8 * wc;

  cp_async_wait<2>();
  __syncthreads();  // the weights and the zeroed tile

  int slot = 0;
  for (; set < sets; set += stride) {
    cp_async_wait<1>();
    team_sync(1 + team, F::TEAM_THREADS);
    const uint32_t sa = ring + slot * F::SLOT;
    uint32_t a[F::MT][F::KS][4];
#pragma unroll
    for (int mt = 0; mt < F::MT; ++mt) {
#pragma unroll
      for (int ks = 0; ks < F::KS; ++ks) {
        // Matrix lane / 8 of the four: rows +8 for odd, k +8 for the upper two.
        const int pos = 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int c = 2 * ks + (lane >> 4);
        ldmatrix_x4(a[mt][ks], sa + pos * F::ROWB + ((c ^ (pos & 7)) << 4));
      }
    }
    team_sync(1 + team, F::TEAM_THREADS);  // the slot is free
    load_set<F>(sa, dy, set + 2 * stride, sets, rows, tt);
    slot ^= 1;

    float acc[2][F::MT][4];
    tap_product<F>(acc[0], a, wl, 0);
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      if (tap + 1 < 27) tap_product<F>(acc[(tap + 1) & 1], a, wl, tap + 1);
      __syncwarp();  // the previous tap's fold, by other lanes
      const int shift = (((tap / 9) * F::S + (tap / 3) % 3) * F::S + tap % 3) * F::SD;
#pragma unroll
      for (int mt = 0; mt < F::MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* p = reinterpret_cast<float2*>(tile + site_word[mt][h] + shift);
          float2 v = *p;
          v.x += acc[tap & 1][mt][2 * h];
          v.y += acc[tap & 1][mt][2 * h + 1];
          *p = v;
        }
      }
    }
    __syncwarp();

    for (int gi = 0; gi < F::G; ++gi) {
      const long long row = static_cast<long long>(set) * F::G + gi;
      for (int q = lane; q < F::Q; q += 32) {
        float4* p = reinterpret_cast<float4*>(cols + (gi * F::Q + q) * F::SD);
        const float4 lo = p[0], hi = p[1];
        p[0] = zero;
        p[1] = zero;
        if (row < rows) {
          uint4 out;
          out.x = pack_bf16(lo.x, lo.y);
          out.y = pack_bf16(lo.z, lo.w);
          out.z = pack_bf16(hi.x, hi.y);
          out.w = pack_bf16(hi.z, hi.w);
          *reinterpret_cast<uint4*>(dx + (row * F::Q + q) * F::CIN + channel) = out;
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

// Grid x: one block an SM over the channel chunks (grid y), and no more
// blocks than two teams' worth of sets. Refuses 2^31 positions or more
// (the kernel counts them in 32 bits).
template <class F>
int launch(const void* dy, const void* wpk, void* dx, int rows, cudaStream_t stream) {
  if (static_cast<long long>(rows) * F::P >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sets = (rows + F::G - 1) / F::G;
  const int wanted = (sets + F::TEAMS - 1) / F::TEAMS, room = sms / F::NCH;
  const int grid_x = wanted < room ? wanted : room;
  auto kernel = conv3d_dgrad_kernel<F>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(grid_x > 0 ? grid_x : 1, F::NCH), F::THREADS, F::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<const uint4*>(wpk),
      static_cast<__nv_bfloat16*>(dx), rows);
  return static_cast<int>(cudaGetLastError());
}

using Block2 = Form<6, 32, 64>;
using Block3 = Form<4, 64, 128>;

}  // namespace

// dx (rows, s, s, s, cin) from dy (rows, s-2, s-2, s-2, cout) and the
// repacked weights (ops/conv3d.py::pack_weight) on the current device;
// returns a cudaError_t.
extern "C" int conv3d_dgrad(const void* dy, const void* wpk, void* dx, int rows, int s, int cin,
                            int cout, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (s == 6 && cin == 32 && cout == 64) return launch<Block2>(dy, wpk, dx, rows, st);
  if (s == 4 && cin == 64 && cout == 128) return launch<Block3>(dy, wpk, dx, rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
