"""Minimal NRRD reader/writer (the subset Text2Shape voxel grids use).

The port's copy of ``tricolo_tpu.data.nrrd``: the Text2Shape archives'
``nrrd_256_filter_div_{32,64,128}_solid/<id>/<id>.nrrd`` solid-voxel RGBA
grids, NRRD0004-style files with attached raw, gzip or zlib payloads, the
integer and float scalar types those archives contain, in Fortran order
(the sizes list the fastest axis first). Offline host-side code, numpy
only.

Format: magic line ``NRRD000X``, then ``key: value`` header lines (``key:=``
for key-value pairs), a blank line, then the binary payload.
"""

from __future__ import annotations

import gzip
import zlib

import numpy as np

_TYPE_MAP = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8, "uint8_t": np.uint8,
    "short": np.int16, "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16, "uint16_t": np.uint16,
    "int": np.int32, "int32": np.int32, "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32, "uint32_t": np.uint32,
    "longlong": np.int64, "int64": np.int64, "int64_t": np.int64,
    "ulonglong": np.uint64, "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32, "double": np.float64,
}


def read(path: str):
    """Read an NRRD file → (ndarray, header_dict)."""
    with open(path, "rb") as f:
        data = f.read()

    magic_end = data.index(b"\n")
    magic = data[:magic_end].decode("ascii", "replace").strip()
    if not magic.startswith("NRRD"):
        raise ValueError(f"{path}: not an NRRD file (magic {magic!r})")

    header: dict[str, str] = {}
    pos = magic_end + 1
    while True:
        line_end = data.index(b"\n", pos)
        line = data[pos:line_end].rstrip(b"\r")
        pos = line_end + 1
        if not line:
            break  # blank line terminates the header
        if line.startswith(b"#"):
            continue
        text = line.decode("ascii", "replace")
        if ":=" in text:
            key, _, value = text.partition(":=")
        else:
            key, _, value = text.partition(":")
        header[key.strip().lower()] = value.strip()

    if "data file" in header or "datafile" in header:
        raise NotImplementedError("detached NRRD data files are not supported")

    dtype = np.dtype(_TYPE_MAP[header["type"].lower()])
    sizes = tuple(int(s) for s in header["sizes"].split())
    if int(header.get("dimension", len(sizes))) != len(sizes):
        raise ValueError(f"{path}: dimension/sizes mismatch")

    endian = header.get("endian", "little")
    if dtype.itemsize > 1:
        dtype = dtype.newbyteorder("<" if endian == "little" else ">")

    encoding = header.get("encoding", "raw").lower()
    payload = data[pos:]
    if encoding in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    elif encoding in ("zlib",):
        payload = zlib.decompress(payload)
    elif encoding not in ("raw",):
        raise NotImplementedError(f"NRRD encoding {encoding!r} not supported")

    count = int(np.prod(sizes))
    array = np.frombuffer(payload, dtype=dtype, count=count)
    # NRRD sizes list the FASTEST axis first (Fortran order).
    return array.reshape(sizes, order="F"), header


def write(path: str, array: np.ndarray, encoding: str = "gzip"):
    """Write ``array`` as NRRD (used by tests and data tooling)."""
    inv_types = {
        np.dtype(np.uint8): "uint8", np.dtype(np.int8): "int8",
        np.dtype(np.uint16): "uint16", np.dtype(np.int16): "int16",
        np.dtype(np.uint32): "uint32", np.dtype(np.int32): "int32",
        np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
        np.dtype(np.float32): "float", np.dtype(np.float64): "double",
    }
    dtype = np.dtype(array.dtype.base.name)  # native-order canonical dtype
    header_lines = [
        "NRRD0004",
        f"type: {inv_types[dtype]}",
        f"dimension: {array.ndim}",
        f"sizes: {' '.join(str(s) for s in array.shape)}",
        f"encoding: {encoding}",
    ]
    if dtype.itemsize > 1:
        header_lines.append("endian: little")
    payload = np.asarray(array, dtype=dtype.newbyteorder("<")).tobytes(order="F")
    if encoding == "gzip":
        payload = gzip.compress(payload)
    elif encoding != "raw":
        raise NotImplementedError(encoding)
    with open(path, "wb") as f:
        f.write(("\n".join(header_lines) + "\n\n").encode("ascii"))
        f.write(payload)
