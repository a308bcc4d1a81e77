"""Read the JAX package's msgpack checkpoints without flax or msgpack.

``tricolo_tpu.training.checkpoint.save_checkpoint`` writes
``flax.serialization.to_bytes`` of ``{step, params, batch_stats, opt_state,
epoch, extra}``: msgpack, with numpy arrays as msgpack ext records. This
module decodes that subset in pure Python and numpy:

* the msgpack types flax writes: nil, bool, int, float, str, bin, array,
  map and ext (an array decodes to a list, as ``msgpack.unpackb`` gives);
* flax's ext types: ``ndarray`` (1) and ``npscalar`` (3), each a msgpack
  (shape, dtype name, raw C-order bytes) record, and ``native_complex``
  (2), a msgpack (real, imag) pair;
* chunked arrays — ``{"__msgpack_chunked_array__": True, "shape": …,
  "chunks": …}``, which flax writes for arrays over 2³⁰ bytes — joined back.

``load_jax_checkpoint(path)`` returns the nested dict that
``flax.serialization.msgpack_restore`` returns for the same file.
``convert.jax_checkpoint_to_torch`` turns it into the port's state. A
bfloat16 leaf (``precision.param_dtype=bfloat16``) is the one difference:
flax gives an ``ml_dtypes`` bfloat16 array, which needs a package the port
does not import, so it decodes to a ``uint16`` array of the same bits,
which ``convert`` views as ``torch.bfloat16``.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


def is_msgpack_map(head: bytes) -> bool:
    """Whether a file starting with ``head`` holds a msgpack map (fixmap,
    map16 or map32), as every flax checkpoint does."""
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


class _Reader:
    """msgpack decoder over one buffer; ``raw`` keeps str values as bytes
    (flax decodes its ndarray records that way)."""

    def __init__(self, data, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n: int):
        raw = bytes(self._take(n))
        return raw if self.raw else raw.decode("utf-8")

    def _array(self, n: int, path: str) -> list:
        return [self.read(f"{path}/{i}") for i in range(n)]

    def _map(self, n: int, path: str) -> dict:
        out = {}
        for _ in range(n):
            key = self.read(path)
            out[key] = self.read(f"{path}/{key}")
        return out

    def read(self, path: str = ""):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b <= 0x8F:
            return self._map(b & 0x0F, path)
        if b <= 0x9F:
            return self._array(b & 0x0F, path)
        if b <= 0xBF:
            return self._str(b & 0x1F)
        if b >= 0xE0:
            return b - 0x100
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self._take(self._unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack(">" + "BHI"[b - 0xC7])
            return self._ext(self._unpack(">b"), bytes(self._take(n)), path)
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        if 0xCC <= b <= 0xCF:
            return self._unpack(">" + "BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self._unpack(">" + "bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:
            code = self._unpack(">b")
            return self._ext(code, bytes(self._take(1 << (b - 0xD4))), path)
        if 0xD9 <= b <= 0xDB:
            return self._str(self._unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">" + "HI"[b - 0xDC]), path)
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">" + "HI"[b - 0xDE]), path)
        raise ValueError(f"msgpack type byte 0x{b:02x} is not used by flax")

    def _ext(self, code: int, payload: bytes, path: str):
        if code == _EXT_COMPLEX:
            real, imag = _Reader(payload).read()
            return complex(real, imag)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code} at {path or '/'}")
        shape, dtype_name, buffer = _Reader(payload, raw=True).read()
        dtype = np.uint16 if dtype_name == b"bfloat16" else np.dtype(dtype_name.decode())
        array = np.frombuffer(buffer, dtype=dtype).reshape(shape)
        return array[()] if code == _EXT_NPSCALAR else array


def _unchunk(node):
    """Join chunked array leaves back into arrays (flax ``_unchunk``)."""
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in node.items()}


def load_jax_checkpoint(path: str) -> dict:
    """A JAX package checkpoint file → its nested dict of numpy leaves
    (``flax.serialization.msgpack_restore`` without flax)."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the msgpack map")
    return _unchunk(tree)
