// npz_reader: the port's zlib readers for the split load and the offline
// stages (C++, plain C ABI, linked -lz).
//
// A Text2Shape model's npz holds its solid voxel grids as (4, D, D, D)
// uint8 RGBA members, deflated. The split load needs only the packed
// occupied sites of one member, so this library fuses the three steps in
// one call: find the member through the zip central directory, inflate it
// (zlib, raw deflate) and sweep its grid once into the packed u32 (site,
// rgb) words, sorted and unique by construction. At 128^3 a member inflates
// to 8 MB a model that never becomes a numpy array. Also: one member's raw
// bytes (npz_read) and a gzip stream's (gzip_decode, NRRD payloads).
//
// The readers of the JAX package's host runtime, with their signatures,
// outputs and errors; they live apart from host_loader.cpp so that the
// main path's sweeps build without zlib. Bound with ctypes
// (tricolo_tpu_torch/native/npz_reader.py), whose foreign calls release
// the GIL, so the split load's threads overlap. Build:
//   g++ -O3 -fPIC -std=c++17 -shared -o libnpz_reader.so npz_reader.cpp -lz

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, errlen, "%s", msg.c_str());
  }
}

struct FileBuf {
  std::vector<uint8_t> data;
  bool ok = false;
};

FileBuf read_file(const char* path) {
  FileBuf out;
  FILE* f = std::fopen(path, "rb");
  if (!f) return out;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return out;
  }
  out.data.resize(static_cast<size_t>(size));
  out.ok = std::fread(out.data.data(), 1, out.data.size(), f) == out.data.size();
  std::fclose(f);
  return out;
}

uint16_t rd16(const uint8_t* p) { return static_cast<uint16_t>(p[0] | (p[1] << 8)); }
uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

constexpr uint32_t kEocdSig = 0x06054b50;
constexpr uint32_t kCdSig = 0x02014b50;
constexpr uint32_t kLocalSig = 0x04034b50;

struct ZipMember {
  size_t data_offset = 0;
  size_t comp_size = 0;
  size_t uncomp_size = 0;
  uint16_t method = 0;  // 0 stored, 8 deflate
  bool found = false;
};

// Locate a member via the central directory (its sizes are reliable even
// when the local headers defer to data descriptors, and numpy's zip64
// local headers carry 0xFFFFFFFF there).
ZipMember zip_find(const std::vector<uint8_t>& zip, const std::string& name) {
  ZipMember out;
  if (zip.size() < 22) return out;
  // End of central directory: scan back over a possible comment.
  size_t eocd = std::string::npos;
  size_t scan_start = zip.size() >= (1 << 16) + 22 ? zip.size() - (1 << 16) - 22 : 0;
  for (size_t i = zip.size() - 22 + 1; i-- > scan_start;) {
    if (rd32(&zip[i]) == kEocdSig) {
      eocd = i;
      break;
    }
  }
  if (eocd == std::string::npos) return out;
  uint16_t n_entries = rd16(&zip[eocd + 10]);
  size_t cd_offset = rd32(&zip[eocd + 16]);

  size_t pos = cd_offset;
  for (uint16_t i = 0; i < n_entries; ++i) {
    if (pos + 46 > zip.size() || rd32(&zip[pos]) != kCdSig) return out;
    uint16_t method = rd16(&zip[pos + 10]);
    uint32_t comp_size = rd32(&zip[pos + 20]);
    uint32_t uncomp_size = rd32(&zip[pos + 24]);
    uint16_t name_len = rd16(&zip[pos + 28]);
    uint16_t extra_len = rd16(&zip[pos + 30]);
    uint16_t comment_len = rd16(&zip[pos + 32]);
    uint32_t local_offset = rd32(&zip[pos + 42]);
    if (pos + 46 + name_len > zip.size()) return out;
    std::string entry_name(reinterpret_cast<const char*>(&zip[pos + 46]), name_len);
    if (entry_name == name) {
      // The local header gives the true data offset (its extra field can
      // differ in length from the central one).
      if (static_cast<size_t>(local_offset) + 30 > zip.size() ||
          rd32(&zip[local_offset]) != kLocalSig) {
        return out;
      }
      uint16_t lname = rd16(&zip[local_offset + 26]);
      uint16_t lextra = rd16(&zip[local_offset + 28]);
      out.data_offset = static_cast<size_t>(local_offset) + 30 + lname + lextra;
      out.comp_size = comp_size;
      out.uncomp_size = uncomp_size;
      out.method = method;
      out.found = true;
      return out;
    }
    pos += 46 + name_len + extra_len + comment_len;
  }
  return out;
}

bool inflate_raw(const uint8_t* src, size_t src_len, uint8_t* dst, size_t dst_len) {
  z_stream strm{};
  if (inflateInit2(&strm, -MAX_WBITS) != Z_OK) return false;
  strm.next_in = const_cast<uint8_t*>(src);
  strm.avail_in = static_cast<uInt>(src_len);
  strm.next_out = dst;
  strm.avail_out = static_cast<uInt>(dst_len);
  int rc = inflate(&strm, Z_FINISH);
  inflateEnd(&strm);
  return rc == Z_STREAM_END && strm.total_out == dst_len;
}

// Parse the .npy header: the data offset within buf and the dims (C
// order); the dtype must be uint8 ('|u1') and the array C-ordered.
bool npy_parse_u8(const std::vector<uint8_t>& buf, size_t* data_offset,
                  std::vector<int64_t>* dims, std::string* err) {
  if (buf.size() < 10 || std::memcmp(buf.data(), "\x93NUMPY", 6) != 0) {
    *err = "not an npy payload";
    return false;
  }
  uint8_t major = buf[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = rd16(&buf[8]);
    header_off = 10;
  } else {
    if (buf.size() < 12) {
      *err = "not an npy payload";
      return false;
    }
    header_len = rd32(&buf[8]);
    header_off = 12;
  }
  if (header_off + header_len > buf.size()) {
    *err = "npy header truncated";
    return false;
  }
  std::string header(reinterpret_cast<const char*>(&buf[header_off]), header_len);
  if (header.find("'|u1'") == std::string::npos &&
      header.find("'uint8'") == std::string::npos) {
    *err = "npy dtype is not uint8: " + header;
    return false;
  }
  if (header.find("'fortran_order': True") != std::string::npos) {
    *err = "fortran-order npy not supported";
    return false;
  }
  size_t lp = header.find('(');
  size_t rp = header.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) {
    *err = "npy shape not found";
    return false;
  }
  dims->clear();
  std::string shape = header.substr(lp + 1, rp - lp - 1);
  const char* p = shape.c_str();
  while (*p) {
    char* end;
    long v = std::strtol(p, &end, 10);
    if (end == p) break;
    dims->push_back(v);
    p = end;
    while (*p == ',' || *p == ' ') ++p;
  }
  *data_offset = header_off + header_len;
  return true;
}

// Dense (4, D, D, D) u8 RGBA C-order grid -> packed words: the occupied
// (alpha > 0) sites in site order, flat = (x*256 + y)*256 + z, rgb = r |
// g<<8 | b<<16 | 1<<24 (bit 24 keeps a pure-black occupied voxel apart
// from empty space). host_loader.cpp's tricolo_dense_rgba_to_packed, the
// same sweep. Returns the occupied count; writes at most n_cap entries.
int64_t pack_rgba(const uint8_t* grid, int64_t d, uint32_t* flat, uint32_t* rgb,
                  int64_t n_cap) {
  const int64_t d3 = d * d * d;
  const uint8_t* r_plane = grid;
  const uint8_t* g_plane = grid + d3;
  const uint8_t* b_plane = grid + 2 * d3;
  const uint8_t* a_plane = grid + 3 * d3;
  int64_t count = 0;
  for (int64_t site = 0; site < d3; ++site) {
    if (a_plane[site]) {
      if (count < n_cap) {
        const uint32_t x = static_cast<uint32_t>(site / (d * d));
        const uint32_t y = static_cast<uint32_t>((site / d) % d);
        const uint32_t z = static_cast<uint32_t>(site % d);
        flat[count] = (x * 256u + y) * 256u + z;
        rgb[count] = static_cast<uint32_t>(r_plane[site]) |
                     (static_cast<uint32_t>(g_plane[site]) << 8) |
                     (static_cast<uint32_t>(b_plane[site]) << 16) | (1u << 24);
      }
      ++count;
    }
  }
  return count;
}

}  // namespace

extern "C" {

int32_t tricolo_npz_reader_abi_version() { return 1; }

// Read + decompress an npz member ("<member>.npy", else "<member>") into a
// caller buffer. Returns the uncompressed size, or -1 with a message in
// err. With out == nullptr it returns the size alone.
int64_t tricolo_npz_read(const char* path, const char* member, uint8_t* out,
                         int64_t out_cap, char* err, int32_t errlen) {
  FileBuf file = read_file(path);
  if (!file.ok) {
    set_err(err, errlen, std::string("cannot read file: ") + path);
    return -1;
  }
  std::string member_name = std::string(member) + ".npy";
  ZipMember zm = zip_find(file.data, member_name);
  if (!zm.found) zm = zip_find(file.data, member);
  if (!zm.found) {
    set_err(err, errlen, std::string("member not found: ") + member);
    return -1;
  }
  if (zm.data_offset + zm.comp_size > file.data.size()) {
    set_err(err, errlen, "corrupt zip: member overruns file");
    return -1;
  }
  if (out == nullptr) return static_cast<int64_t>(zm.uncomp_size);
  if (out_cap < static_cast<int64_t>(zm.uncomp_size)) {
    set_err(err, errlen, "output buffer too small");
    return -1;
  }
  const uint8_t* src = file.data.data() + zm.data_offset;
  if (zm.method == 0) {
    std::memcpy(out, src, zm.uncomp_size);
  } else if (zm.method == 8) {
    if (!inflate_raw(src, zm.comp_size, out, zm.uncomp_size)) {
      set_err(err, errlen, "deflate stream corrupt");
      return -1;
    }
  } else {
    set_err(err, errlen, "unsupported zip compression method");
    return -1;
  }
  return static_cast<int64_t>(zm.uncomp_size);
}

// Fused: npz member -> npy parse -> packed sparse voxels. Returns the
// occupied count (writes clamped at n_cap) and the grid size in *d_out, or
// -1 with a message in err.
int64_t tricolo_load_npz_voxels_packed(const char* path, const char* member,
                                       uint32_t* flat, uint32_t* rgb,
                                       int64_t n_cap, int64_t* d_out,
                                       char* err, int32_t errlen) {
  int64_t size = tricolo_npz_read(path, member, nullptr, 0, err, errlen);
  if (size < 0) return -1;
  std::vector<uint8_t> payload(static_cast<size_t>(size));
  if (tricolo_npz_read(path, member, payload.data(), size, err, errlen) < 0) {
    return -1;
  }
  size_t data_offset;
  std::vector<int64_t> dims;
  std::string perr;
  if (!npy_parse_u8(payload, &data_offset, &dims, &perr)) {
    set_err(err, errlen, perr);
    return -1;
  }
  if (dims.size() != 4 || dims[0] != 4 || dims[1] != dims[2] ||
      dims[2] != dims[3]) {
    set_err(err, errlen, "expected (4, D, D, D) RGBA voxel grid");
    return -1;
  }
  const int64_t d = dims[1];
  if (d > 256) {
    set_err(err, errlen, "voxel size > 256 (8 bits an axis)");
    return -1;
  }
  if (static_cast<int64_t>(payload.size() - data_offset) < 4 * d * d * d) {
    set_err(err, errlen, "npy payload truncated");
    return -1;
  }
  if (d_out) *d_out = d;
  return pack_rgba(payload.data() + data_offset, d, flat, rgb, n_cap);
}

// Decode a gzip stream (NRRD payloads) into a caller buffer; returns the
// decompressed size or -1. gzip has no reliable size field past 4 GB, so
// the caller passes the capacity it expects.
int64_t tricolo_gzip_decode(const uint8_t* src, int64_t src_len, uint8_t* out,
                            int64_t out_cap) {
  z_stream strm{};
  if (inflateInit2(&strm, 16 + MAX_WBITS) != Z_OK) return -1;
  strm.next_in = const_cast<uint8_t*>(src);
  strm.avail_in = static_cast<uInt>(src_len);
  strm.next_out = out;
  strm.avail_out = static_cast<uInt>(out_cap);
  int rc = inflate(&strm, Z_FINISH);
  int64_t total = static_cast<int64_t>(strm.total_out);
  inflateEnd(&strm);
  return rc == Z_STREAM_END ? total : -1;
}

}  // extern "C"
