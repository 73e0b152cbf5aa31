"""Reference-binary NDArray serialization (the port's copy of
mxnet_tpu/ndarray/legacy_io.py, kept byte for byte in its layout and
type table).

Reference parity: src/ndarray/ndarray.cc NDArray::Save/Load (per-array
V2 records, magic 0xF993fac9, with V1/legacy-TShape fallbacks on load)
and the list container (kMXAPINDArrayListMagic 0x112 header +
dmlc-serialized vectors) — the format of upstream ``*.params`` /
``*.ndarray`` files, so checkpoints move between the reference and this
framework in both directions.

Layout (little-endian throughout):

  file   := u64 0x112 | u64 0 | u64 n | record*n | u64 k | string*k
  string := u64 len | bytes
  record := u32 0xF993fac9 | i32 stype | shape | i32 dev_type |
            i32 dev_id | i32 type_flag | raw row-major data
  shape  := i32 ndim | i64*ndim

Only dense (stype 0) records are produced; sparse records are detected
and rejected with a clear error.  bfloat16 has no type flag here, as in
the JAX copy: cast before saving.  Loads also accept V1 records
(0xF993fac8: no stype field) and the pre-V1 layout where the leading
u32 is the ndim of a u32 shape.
"""
from __future__ import annotations

import struct

import numpy as np

from ..base import MXNetError

LIST_MAGIC = 0x112
V2_MAGIC = 0xF993FAC9
V1_MAGIC = 0xF993FAC8

# mshadow type flags (3rdparty/mshadow TypeFlag)
_FLAG_TO_DTYPE = {0: np.float32, 1: np.float64, 2: np.float16,
                  3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}
_DTYPE_TO_FLAG = {np.dtype(v): k for k, v in _FLAG_TO_DTYPE.items()}


def is_binary_format(fname):
    """Sniff the first 8 bytes for the list magic."""
    try:
        with open(fname, "rb") as f:
            head = f.read(8)
    except OSError:
        return False
    return len(head) == 8 and \
        struct.unpack("<Q", head)[0] == LIST_MAGIC


class _Reader:
    def __init__(self, buf):
        self._buf = buf
        self._pos = 0

    def take(self, n):
        if self._pos + n > len(self._buf):
            raise MXNetError("invalid NDArray file: truncated record")
        out = self._buf[self._pos:self._pos + n]
        self._pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]


def _read_shape_v2(r):
    ndim = r.i32()
    if ndim < 0:
        return None      # "none" shape
    dims = struct.unpack("<%dq" % ndim, r.take(8 * ndim))
    return tuple(int(d) for d in dims)


def _read_record(r):
    magic = r.u32()
    if magic == V2_MAGIC:
        stype = r.i32()
        if stype != 0:
            raise MXNetError(
                "sparse NDArray records (stype=%d) are not supported by "
                "the binary loader; densify before saving" % stype)
        shape = _read_shape_v2(r)
    elif magic == V1_MAGIC:
        shape = _read_shape_v2(r)
    else:
        # pre-V1: the magic word itself is the ndim of a u32 shape
        ndim = magic
        if ndim > 32:
            raise MXNetError("invalid NDArray file: bad record magic "
                             "0x%x" % magic)
        shape = tuple(struct.unpack("<%dI" % ndim, r.take(4 * ndim)))
    if shape is None:
        return np.zeros((0,), np.float32)
    r.i32()               # dev_type (placement is the loader's choice)
    r.i32()               # dev_id
    type_flag = r.i32()
    dtype = _FLAG_TO_DTYPE.get(type_flag)
    if dtype is None:
        raise MXNetError("unsupported dtype flag %d in NDArray file"
                         % type_flag)
    count = 1
    for d in shape:
        count *= d
    raw = r.take(count * np.dtype(dtype).itemsize)
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def load_binary(fname):
    """Parse a reference-format file -> (list_of_numpy, list_of_names).
    names is empty for unnamed (list) saves."""
    with open(fname, "rb") as f:
        r = _Reader(f.read())
    if r.u64() != LIST_MAGIC:
        raise MXNetError("invalid NDArray file format: bad header")
    r.u64()               # reserved
    n = r.u64()
    arrays = [_read_record(r) for _ in range(n)]
    k = r.u64()
    names = [r.take(r.u64()).decode("utf-8") for _ in range(k)]
    if names and len(names) != len(arrays):
        raise MXNetError("invalid NDArray file format: %d names for %d "
                         "arrays" % (len(names), len(arrays)))
    return arrays, names


def _write_record(out, arr):
    # capture the shape BEFORE ascontiguousarray: it promotes 0-d to
    # (1,) (its ndmin=1), which would silently change a scalar's shape
    # on round-trip
    shape = np.asarray(arr).shape
    arr = np.ascontiguousarray(arr)
    flag = _DTYPE_TO_FLAG.get(arr.dtype)
    if flag is None:
        raise MXNetError("dtype %s has no reference binary encoding; "
                         "cast before saving" % arr.dtype)
    out.append(struct.pack("<I", V2_MAGIC))
    out.append(struct.pack("<i", 0))                      # dense stype
    out.append(struct.pack("<i", len(shape)))
    out.append(struct.pack("<%dq" % len(shape), *shape))
    out.append(struct.pack("<ii", 1, 0))                  # cpu(0)
    out.append(struct.pack("<i", flag))
    out.append(arr.tobytes())


def save_binary(fname, arrays, names=()):
    """Write numpy arrays (optionally named) in the reference format."""
    out = [struct.pack("<QQ", LIST_MAGIC, 0),
           struct.pack("<Q", len(arrays))]
    for a in arrays:
        _write_record(out, a)
    out.append(struct.pack("<Q", len(names)))
    for name in names:
        b = name.encode("utf-8")
        out.append(struct.pack("<Q", len(b)))
        out.append(b)
    from ..checkpoint import atomic_write

    atomic_write(fname, b"".join(out))
