// host_loader: the port's host-side voxel sweeps (C++, plain C ABI).
//
// The loader's collation turns each batch's packed (site, rgb) u32 words
// into what the configured data.voxel_transfer ships to the card: a dense
// u32 grid, every tile's halo'd window rows, or each sample's active tiles'
// window rows. In numpy that is a chain of whole-batch temporaries (about
// 2 s for one 128-sample batch of 64^3 shapes at halo 3); here it is one
// pass over each sample's sites, samples split across threads. The split
// load packs each model's dense RGBA grid with dense_rgba_to_packed.
//
// These are the sweeps of the JAX package's host runtime, the same
// arithmetic and the same outputs, without its npz/gzip readers: the
// library needs a C++17 compiler and nothing else (no zlib). Bound with
// ctypes (tricolo_tpu_torch/native), whose foreign calls release the GIL,
// so the loader's prefetch thread runs them beside the main thread. Each
// numpy formulation stays beside its binding as the tests' reference
// (data/device_prep.py, data/datasets.py: the *_plain functions).
//
// Bound by host memory: each site's word is read once and written to at
// most 8 windows; the outputs are zeroed first. Build:
//   g++ -O3 -fPIC -std=c++17 -pthread -shared -o libhost_loader.so host_loader.cpp

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Worker threads of a sweep: TRICOLO_NATIVE_THREADS if set and positive,
// else hardware_concurrency.
int64_t worker_count() {
  int64_t n = 0;
  if (const char* env = std::getenv("TRICOLO_NATIVE_THREADS")) {
    n = std::atoll(env);
  }
  if (n <= 0) n = static_cast<int64_t>(std::thread::hardware_concurrency());
  return std::max<int64_t>(1, n);
}

// Run f(b0, b1) over [0, batch) split across worker threads. Each sample
// writes only its own output rows, so the split needs no synchronisation.
template <typename F>
void parallel_batches(int64_t batch, F f) {
  const int64_t n = std::max<int64_t>(1, std::min(worker_count(), batch));
  if (n == 1) {
    f(static_cast<int64_t>(0), batch);
    return;
  }
  std::vector<std::thread> workers;
  const int64_t chunk = (batch + n - 1) / n;
  for (int64_t t = 0; t < n; ++t) {
    const int64_t b0 = t * chunk;
    const int64_t b1 = std::min(batch, b0 + chunk);
    if (b0 >= b1) break;
    workers.emplace_back([&f, b0, b1] { f(b0, b1); });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// Bumped with any change of an entry's signature or contract.
int32_t tricolo_host_loader_abi_version() { return 1; }

// The thread count a sweep uses (parallel_batches caps it at the batch).
int64_t tricolo_host_loader_threads() { return worker_count(); }

// Packed (flat, rgb) words -> dense (B, D, D, D) u32 grid (zero elsewhere):
// the host half of data.voxel_transfer=dense. `flat` uses the fixed
// 256-stride-per-axis packing; 0xFFFFFFFF entries are trailing padding.
void tricolo_packed_to_dense(const uint32_t* flat, const uint32_t* rgb,
                             int64_t batch, int64_t n_points, int64_t d,
                             uint32_t* grid) {
  const int64_t d3 = d * d * d;
  parallel_batches(batch, [=](int64_t b0, int64_t b1) {
    std::memset(grid + b0 * d3, 0,
                static_cast<size_t>(b1 - b0) * d3 * sizeof(uint32_t));
    for (int64_t b = b0; b < b1; ++b) {
      const uint32_t* f = flat + b * n_points;
      const uint32_t* c = rgb + b * n_points;
      uint32_t* g = grid + b * d3;
      for (int64_t i = 0; i < n_points; ++i) {
        const uint32_t word = f[i];
        if (word == 0xFFFFFFFFu) break;  // padding is trailing by contract
        const int64_t x = (word >> 16) & 0xFF;
        const int64_t y = (word >> 8) & 0xFF;
        const int64_t z = word & 0xFF;
        // Out-of-range coordinates (a packed cache built at a larger
        // voxel_size) are skipped, as the numpy version and the device
        // scatter drop them; a write here would corrupt the heap.
        if (x >= d || y >= d || z >= d) continue;
        g[(x * d + y) * d + z] = c[i];
      }
    }
  });
}

// Packed (flat, rgb) words -> halo'd window rows: (batch*tg^3, s^3) u32
// with s = tile + 2*halo, plus a per-tile centre-occupancy byte map
// (batch*tg^3): the host half of data.voxel_transfer=windowed. Window
// (wa,wb,wc) of a sample covers grid coordinates [w*tile - halo,
// w*tile + tile + halo) per axis (zeros past the grid border); a site lands
// in up to 8 windows (its home tile plus face/edge/corner halos of
// neighbours). Row = b*tg^3 + ((wa*tg)+wb)*tg + wc, offset =
// (la*s + lb)*s + lc with axis a = (word >> 16). Needs d % tile == 0 and
// 2*halo <= tile (the binding checks both).
void tricolo_packed_to_windowed(const uint32_t* flat, const uint32_t* rgb,
                                int64_t batch, int64_t n_points, int64_t d,
                                int64_t tile, int64_t halo, uint32_t* rows,
                                uint8_t* tile_occ) {
  const int64_t tg = d / tile;
  const int64_t s = tile + 2 * halo;
  const int64_t s3 = s * s * s;
  const int64_t tiles_per_sample = tg * tg * tg;
  parallel_batches(batch, [=](int64_t b0, int64_t b1) {
    std::memset(rows + b0 * tiles_per_sample * s3, 0,
                static_cast<size_t>(b1 - b0) * tiles_per_sample * s3 *
                    sizeof(uint32_t));
    std::memset(tile_occ + b0 * tiles_per_sample, 0,
                static_cast<size_t>(b1 - b0) * tiles_per_sample);
    for (int64_t b = b0; b < b1; ++b) {
      const uint32_t* f = flat + b * n_points;
      const uint32_t* c = rgb + b * n_points;
      uint32_t* r = rows + b * tiles_per_sample * s3;
      uint8_t* occ = tile_occ + b * tiles_per_sample;
      for (int64_t i = 0; i < n_points; ++i) {
        const uint32_t word = f[i];
        if (word == 0xFFFFFFFFu) break;
        const int64_t v[3] = {(word >> 16) & 0xFF, (word >> 8) & 0xFF,
                              word & 0xFF};
        if (v[0] >= d || v[1] >= d || v[2] >= d) continue;  // malformed
        // Per axis: the home window, plus a neighbour within halo reach.
        int64_t w_opts[3][2];
        int n_opts[3];
        for (int axis = 0; axis < 3; ++axis) {
          const int64_t home = v[axis] / tile;
          const int64_t mod = v[axis] % tile;
          n_opts[axis] = 0;
          w_opts[axis][n_opts[axis]++] = home;
          if (mod < halo && home > 0) w_opts[axis][n_opts[axis]++] = home - 1;
          if (mod >= tile - halo && home + 1 < tg)
            w_opts[axis][n_opts[axis]++] = home + 1;
        }
        const int64_t home_tile =
            ((v[0] / tile) * tg + v[1] / tile) * tg + v[2] / tile;
        occ[home_tile] = 1;
        for (int ia = 0; ia < n_opts[0]; ++ia)
          for (int ib = 0; ib < n_opts[1]; ++ib)
            for (int ic = 0; ic < n_opts[2]; ++ic) {
              const int64_t wa = w_opts[0][ia], wb = w_opts[1][ib],
                            wc = w_opts[2][ic];
              const int64_t la = v[0] - (wa * tile - halo);
              const int64_t lb = v[1] - (wb * tile - halo);
              const int64_t lc = v[2] - (wc * tile - halo);
              r[((wa * tg + wb) * tg + wc) * s3 + (la * s + lb) * s + lc] =
                  c[i];
            }
      }
    }
  });
}

// Per-sample compacted windows: rows for only each sample's first `k`
// active tiles (ascending tile id within the sample: the nonzero(size=k)
// truncation rule). Outputs:
//   rows      (batch, k, s^3) u32: zeroed, active windows written
//   local_ids (batch, k) i32: tile ids in [0, tg^3), padded with tg^3
//   counts    (batch,) i32: each sample's TOTAL active tiles (count > k
//             means truncation; the loader decides error or warning)
// The host half of data.voxel_transfer=windowed_compact, the default.
void tricolo_packed_to_windowed_compact(
    const uint32_t* flat, const uint32_t* rgb, int64_t batch,
    int64_t n_points, int64_t d, int64_t tile, int64_t halo, int64_t k,
    uint32_t* rows, int32_t* local_ids, int32_t* counts) {
  const int64_t tg = d / tile;
  const int64_t s = tile + 2 * halo;
  const int64_t s3 = s * s * s;
  const int64_t tiles_per_sample = tg * tg * tg;
  parallel_batches(batch, [=](int64_t b0, int64_t b1) {
    std::vector<int32_t> slot(static_cast<size_t>(tiles_per_sample));
    for (int64_t b = b0; b < b1; ++b) {
      const uint32_t* f = flat + b * n_points;
      const uint32_t* c = rgb + b * n_points;
      uint32_t* r = rows + b * k * s3;
      int32_t* ids = local_ids + b * k;
      // Pass 1: this sample's per-tile centre occupancy (slot = -1/-2).
      std::fill(slot.begin(), slot.end(), -1);
      for (int64_t i = 0; i < n_points; ++i) {
        const uint32_t word = f[i];
        if (word == 0xFFFFFFFFu) break;
        const int64_t x = (word >> 16) & 0xFF;
        const int64_t y = (word >> 8) & 0xFF;
        const int64_t z = word & 0xFF;
        if (x >= d || y >= d || z >= d) continue;  // malformed
        slot[(x / tile) * tg * tg + (y / tile) * tg + z / tile] = -2;
      }
      // Slot assignment: ascending tile id -> row slot, first k winners.
      int64_t total = 0;
      for (int64_t t = 0; t < tiles_per_sample; ++t) {
        if (slot[static_cast<size_t>(t)] == -2) {
          if (total < k) {
            slot[static_cast<size_t>(t)] = static_cast<int32_t>(total);
            ids[total] = static_cast<int32_t>(t);
          } else {
            slot[static_cast<size_t>(t)] = -1;  // over the budget: dropped
          }
          ++total;
        }
      }
      counts[b] = static_cast<int32_t>(total);
      for (int64_t j = std::min(total, k); j < k; ++j) {
        ids[j] = static_cast<int32_t>(tiles_per_sample);  // "no tile"
      }
      std::memset(r, 0, static_cast<size_t>(k) * s3 * sizeof(uint32_t));
      // Pass 2: each site into its home window and the halo bands of
      // active neighbour windows.
      for (int64_t i = 0; i < n_points; ++i) {
        const uint32_t word = f[i];
        if (word == 0xFFFFFFFFu) break;
        const int64_t v[3] = {(word >> 16) & 0xFF, (word >> 8) & 0xFF,
                              word & 0xFF};
        if (v[0] >= d || v[1] >= d || v[2] >= d) continue;
        int64_t w_opts[3][2];
        int n_opts[3];
        for (int axis = 0; axis < 3; ++axis) {
          const int64_t home = v[axis] / tile;
          const int64_t mod = v[axis] % tile;
          n_opts[axis] = 0;
          w_opts[axis][n_opts[axis]++] = home;
          if (mod < halo && home > 0) w_opts[axis][n_opts[axis]++] = home - 1;
          if (mod >= tile - halo && home + 1 < tg)
            w_opts[axis][n_opts[axis]++] = home + 1;
        }
        for (int ia = 0; ia < n_opts[0]; ++ia)
          for (int ib = 0; ib < n_opts[1]; ++ib)
            for (int ic = 0; ic < n_opts[2]; ++ic) {
              const int64_t wa = w_opts[0][ia], wb = w_opts[1][ib],
                            wc = w_opts[2][ic];
              const int32_t row = slot[(wa * tg + wb) * tg + wc];
              if (row < 0) continue;  // inactive or over-budget tile
              const int64_t la = v[0] - (wa * tile - halo);
              const int64_t lb = v[1] - (wb * tile - halo);
              const int64_t lc = v[2] - (wc * tile - halo);
              r[static_cast<int64_t>(row) * s3 + (la * s + lb) * s + lc] =
                  c[i];
            }
      }
    }
  });
}

// Dense (4, D, D, D) u8 RGBA C-order grid -> packed words. Returns the
// occupied-site count (may exceed n_cap; only n_cap entries are written).
int64_t tricolo_dense_rgba_to_packed(const uint8_t* grid, int64_t d,
                                     uint32_t* flat, uint32_t* rgb,
                                     int64_t n_cap) {
  const int64_t d3 = d * d * d;
  const uint8_t* r_plane = grid;
  const uint8_t* g_plane = grid + d3;
  const uint8_t* b_plane = grid + 2 * d3;
  const uint8_t* a_plane = grid + 3 * d3;
  int64_t count = 0;
  // One linear sweep in site order: the output is sorted and unique.
  for (int64_t site = 0; site < d3; ++site) {
    if (a_plane[site]) {
      if (count < n_cap) {
        const uint32_t x = static_cast<uint32_t>(site / (d * d));
        const uint32_t y = static_cast<uint32_t>((site / d) % d);
        const uint32_t z = static_cast<uint32_t>(site % d);
        flat[count] = (x * 256u + y) * 256u + z;
        // Bit 24 = occupancy (the active-site rule is alpha > 0, so an
        // occupied pure-black voxel stays distinct from empty space).
        rgb[count] = static_cast<uint32_t>(r_plane[site]) |
                     (static_cast<uint32_t>(g_plane[site]) << 8) |
                     (static_cast<uint32_t>(b_plane[site]) << 16) |
                     (1u << 24);
      }
      ++count;
    }
  }
  return count;
}

}  // extern "C"
