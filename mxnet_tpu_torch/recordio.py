"""RecordIO file format (parity: mxnet_tpu/recordio.py,
python/mxnet/recordio.py + dmlc-core RecordIO).

Byte-compatible with the reference's and the JAX package's ``.rec``
files: records framed as [kMagic(0xced7230a) u32][lrec u32][data][pad to
4B], where lrec = upper 3 bits cflag | lower 29 bits length.  IRHeader
packs (flag, label, id, id2) ahead of image payloads (tools/im2rec
output); ``.idx`` sidecars hold ``key\\tpos`` lines.  A file either
package writes reads back in the other.
"""
from __future__ import annotations

import numbers
import os
import struct

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_kMagic = 0xCED7230A
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)
_LEN_MASK = (1 << 29) - 1


class IRHeader:
    __slots__ = ("flag", "label", "id", "id2")

    def __init__(self, flag, label, id, id2):  # noqa: A002
        self.flag = flag
        self.label = label
        self.id = id
        self.id2 = id2

    def __iter__(self):
        return iter((self.flag, self.label, self.id, self.id2))

    def __repr__(self):
        return "IRHeader(flag=%s, label=%s, id=%s, id2=%s)" % tuple(self)


class MXRecordIO:
    """Sequential .rec reader/writer (``flag`` 'r' or 'w')."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.record = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()

    def close(self):
        if self.record is not None:
            self.record.close()
            self.record = None
        self.pid = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def __getstate__(self):
        d = {k: v for k, v in self.__dict__.items() if k != "record"}
        d["_pos"] = self.record.tell() if self.record else 0
        return d

    def __setstate__(self, d):
        pos = d.pop("_pos", 0)
        self.__dict__.update(d)
        self.record = None
        self.open()
        if not self.writable:
            self.record.seek(pos)

    def _check_pid(self, allow_reset=False):
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
            else:
                raise RuntimeError("fork detected: call reset() first")

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        if not self.writable:
            raise RuntimeError("%s is open for reading" % self.uri)
        self._check_pid()
        pad = (4 - (len(buf) % 4)) % 4
        self.record.write(struct.pack("<II", _kMagic, len(buf)) + buf
                          + b"\x00" * pad)

    def read(self):
        """The next record's payload, or None at the end of the file."""
        if self.writable:
            raise RuntimeError("%s is open for writing" % self.uri)
        self._check_pid(allow_reset=True)
        hdr = self.record.read(8)
        if len(hdr) < 8:
            return None
        magic, lrec = struct.unpack("<II", hdr)
        if magic != _kMagic:
            raise RuntimeError("invalid record magic at %d"
                               % self.record.tell())
        length = lrec & _LEN_MASK
        buf = self.record.read(length)
        pad = (4 - (length % 4)) % 4
        if pad:
            self.record.read(pad)
        return buf

    def tell(self):
        return self.record.tell()

    def seek(self, pos):
        self.record.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec through its .idx sidecar (``key\\tpos`` a line)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.exists(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        key = self.key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


def pack(header, s):
    """IRHeader ``header`` + payload bytes ``s``: a scalar label rides in
    the header, a vector label (flag = its length) follows it as f32."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        hdr = struct.pack(_IR_FORMAT, 0, header.label, header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
        hdr += label.tobytes()
    return hdr + s


def unpack(s):
    """(IRHeader, payload) of a packed record."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    from .image.image import imencode

    return pack(header, imencode(img, quality=quality, img_fmt=img_fmt))


def unpack_img(s, iscolor=-1):
    from .image.image import imdecode_np

    header, s = unpack(s)
    return header, imdecode_np(s, iscolor)
