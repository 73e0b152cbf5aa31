"""ctypes bindings for the native C++ runtime (parity: mxnet_tpu/native.py
over cpp/mxtpu_runtime.cc).

The runtime is the reference's C++ IO pipeline and storage manager
(src/io/iter_image_recordio_2.cc, src/storage/) in small: a pread-based
RecordIO reader and indexer, a libjpeg batch decoder on C++ threads (no
GIL), and a size-bucketed host buffer pool with statistics.

The port builds its own copy of ``cpp/mxtpu_runtime.cc`` on first use
with the flags of ``cpp/Makefile`` (``$CXX`` or ``g++``, ``-O2 -fPIC
-std=c++17 -shared ... -ljpeg -lpthread``) into
``mxnet_tpu_torch/_build/`` (named by a hash of the source and the
command, so an edit rebuilds; compiled to a temporary file and renamed
into place, so concurrent first uses never load a half-written file).
It writes nothing under ``cpp/`` and never loads the JAX package's
``cpp/libmxtpu_runtime.so``.

``capi_library()`` builds the C ABI library with ``cpp/Makefile``'s
flags: the port's own copies of ``mxtpu_predict.cc`` and ``mxtpu_api.cc``
(``mxnet_tpu_torch/cpp/``, whose workers are
``mxnet_tpu_torch.predict_worker`` / ``.api_worker``) against ``cpp/``'s
unchanged headers, into ``_build/capi_<hash>/libmxtpu_runtime.so`` (the
name the clients link).  ``cpp/mxtpu_runtime.cc`` stays in the library
above: its JPEG decoder needs libjpeg, which a host may lack, and the C
ABIs need none of it.  ``capi_client(name)`` links the unchanged clients
``cpp/test_predict.c`` and ``cpp/test_api_train.c`` against it beside it
(rpath ``$ORIGIN``).  A failed build raises with the compiler's stderr;
nothing falls back.  When the build or the load fails (no
compiler, no libjpeg), ``available()`` is False and consumers take the
pure-Python path, as upstream's portable build does; ``load_error()``
keeps the reason (the compiler's stderr), so the choice is never
invisible.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "load_error", "lib", "library_path",
           "recordio_index", "decode_batch", "pool_stats", "pool_clear",
           "RecordReader", "capi_dir", "capi_library", "capi_client"]

_CPP = Path(__file__).resolve().parent.parent / "cpp"
_SOURCE = _CPP / "mxtpu_runtime.cc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
# the C ABI library (the ABIs' half of cpp/Makefile's libmxtpu_runtime.so)
# and its clients
_CAPI_SOURCES = (Path(__file__).resolve().parent / "cpp" / "mxtpu_predict.cc",
                 Path(__file__).resolve().parent / "cpp" / "mxtpu_api.cc")
_CAPI_LDFLAGS = ["-shared", "-lpthread"]
_CAPI_HEADERS = (_CPP / "mxtpu_ipc.h", _CPP / "mxtpu_predict.h",
                 _CPP / "mxtpu_api.h")
_CLIENTS = {"test_predict": _CPP / "test_predict.c",
            "test_api_train": _CPP / "test_api_train.c"}
_CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]
_LDFLAGS = ["-shared", "-ljpeg", "-lpthread"]

_lock = threading.Lock()
_lib = None
_error = None
_path = None
_tried = False


def _command(cxx, out):
    return [cxx] + _CXXFLAGS + [str(_SOURCE), "-o", str(out)] + _LDFLAGS


def library_path():
    """Where this source and compiler build to (whether built or not)."""
    cxx = os.environ.get("CXX", "g++")
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(
        _command(cxx, "")).encode()).hexdigest()[:16]
    return _BUILD_DIR / ("libmxtpu_runtime_%s.so" % digest)


def _run_build(cmd, out):
    """Run ``cmd`` writing ``out`` (its argument after ``-o``) through a
    temporary name, then rename it into place; raise with the compiler's
    stderr when it fails."""
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    cmd = [str(tmp) if c == str(out) else c for c in cmd]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError("%s: %s" % (" ".join(cmd), e)) from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("%s failed (rc %d): %s"
                           % (" ".join(cmd), proc.returncode,
                              proc.stderr.strip()))
    os.replace(tmp, out)
    return out


def _build():
    """Path of the built library, compiling it if it is not there."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return _run_build(_command(os.environ.get("CXX", "g++"), out), out)


def _bind(lib):
    vp, i64, u8p = ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(
        ctypes.c_uint8)
    lib.mxtpu_recordio_open.restype = vp
    lib.mxtpu_recordio_open.argtypes = [ctypes.c_char_p]
    lib.mxtpu_recordio_close.restype = None
    lib.mxtpu_recordio_close.argtypes = [vp]
    lib.mxtpu_recordio_index.restype = i64
    lib.mxtpu_recordio_index.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(i64), i64]
    lib.mxtpu_recordio_read_at.restype = i64
    lib.mxtpu_recordio_read_at.argtypes = [vp, i64, u8p, i64]
    lib.mxtpu_decode_batch.restype = i64
    lib.mxtpu_decode_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(i64), i64, u8p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.mxtpu_pool_stats.restype = None
    lib.mxtpu_pool_stats.argtypes = [ctypes.POINTER(i64)]
    lib.mxtpu_pool_clear.restype = None
    lib.mxtpu_pool_clear.argtypes = []
    lib.mxtpu_version.restype = ctypes.c_int
    lib.mxtpu_version.argtypes = []
    return lib


def _load():
    global _lib, _error, _path, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _path = _build()
                _lib = _bind(ctypes.CDLL(str(_path)))
            except (OSError, RuntimeError) as e:
                _lib, _error = None, str(e)
        return _lib


def available():
    """Whether the native runtime built and loaded."""
    return _load() is not None


def load_error():
    """Why the runtime is unavailable (the build command and the
    compiler's stderr, or the loader's error); None when it loaded."""
    _load()
    return _error


def lib():
    l = _load()
    if l is None:
        raise RuntimeError("native runtime unavailable: %s" % _error)
    return l


def recordio_index(path):
    """Byte offsets of every record of a .rec file (the native scanner)."""
    l = lib()
    cap = 1 << 16
    while True:
        buf = (ctypes.c_int64 * cap)()
        n = l.mxtpu_recordio_index(os.fsencode(path), buf, cap)
        if n < 0:
            raise RuntimeError("native recordio: bad framing in %s" % path)
        if n <= cap:
            return list(buf[:n])
        cap = int(n)


def decode_batch(path, positions, out_h, out_w, threads=4):
    """Read + JPEG-decode the records at ``positions`` into an (N, H, W, 3)
    uint8 batch (each image centre-cropped to out_h x out_w) and a label
    vector, on ``threads`` C++ threads.  Returns (batch, labels,
    n_failed); a failed record's slot is zero and its label -1."""
    l = lib()
    n = len(positions)
    pos = (ctypes.c_int64 * n)(*[int(p) for p in positions])
    batch = np.empty((n, out_h, out_w, 3), np.uint8)
    labels = np.empty((n,), np.float32)
    failed = l.mxtpu_decode_batch(
        os.fsencode(path), pos, n,
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(out_h), int(out_w), int(threads))
    return batch, labels, int(failed)


class RecordReader:
    """pread-based record access (thread safe, one shared handle)."""

    def __init__(self, path):
        self._l = lib()
        self._h = self._l.mxtpu_recordio_open(os.fsencode(path))
        if not self._h:
            raise OSError("cannot open %s" % path)
        self._cap = 1 << 20
        self._buf = (ctypes.c_uint8 * self._cap)()

    def read_at(self, pos):
        n = self._l.mxtpu_recordio_read_at(self._h, int(pos), self._buf,
                                           self._cap)
        if n < 0:
            raise RuntimeError("bad record at %d" % pos)
        if n > self._cap:
            self._cap = int(n)
            self._buf = (ctypes.c_uint8 * self._cap)()
            n = self._l.mxtpu_recordio_read_at(self._h, int(pos),
                                               self._buf, self._cap)
            if n < 0:
                raise RuntimeError("record at %d vanished mid-read" % pos)
        return bytes(self._buf[:n])

    def close(self):
        if self._h:
            self._l.mxtpu_recordio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def pool_stats():
    """The pooled storage manager's counters: bytes_allocated,
    bytes_pooled, n_alloc, n_reuse, n_free."""
    l = lib()
    out = (ctypes.c_int64 * 5)()
    l.mxtpu_pool_stats(out)
    keys = ("bytes_allocated", "bytes_pooled", "n_alloc", "n_reuse",
            "n_free")
    return dict(zip(keys, out))


def pool_clear():
    lib().mxtpu_pool_clear()


# ---------------------------------------------------------------------------
# the C ABI library and its clients
# ---------------------------------------------------------------------------


def _capi_commands(out_dir):
    cxx = os.environ.get("CXX", "g++")
    cc = os.environ.get("CC") or shutil.which("cc") or "gcc"
    lib = [cxx] + _CXXFLAGS + ["-I", str(_CPP)] + [
        str(p) for p in _CAPI_SOURCES] + ["-o", str(out_dir /
                                               "libmxtpu_runtime.so")] + \
        _CAPI_LDFLAGS
    clients = {name: [cc, "-O2", "-Wall", "-I", str(_CPP), str(src), "-o",
                      str(out_dir / name), "-L", str(out_dir),
                      "-lmxtpu_runtime", "-Wl,-rpath,$ORIGIN"]
               for name, src in _CLIENTS.items()}
    return lib, clients


def capi_dir():
    """The directory the C ABI library and its clients build into, named
    by a hash of every source, header and command."""
    h = hashlib.sha256()
    for p in _CAPI_SOURCES + _CAPI_HEADERS + tuple(_CLIENTS.values()):
        h.update(p.read_bytes())
    lib, clients = _capi_commands(Path("."))
    h.update(" ".join(lib + sum(clients.values(), [])).encode())
    return _BUILD_DIR / ("capi_%s" % h.hexdigest()[:16])


def capi_library():
    """Path of the C ABI's ``libmxtpu_runtime.so``, built on first use
    (module doc)."""
    out_dir = capi_dir()
    out = out_dir / "libmxtpu_runtime.so"
    with _lock:
        if not out.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            _run_build(_capi_commands(out_dir)[0], out)
    return out


def capi_client(name):
    """Path of the C client ``name`` (``test_predict`` or
    ``test_api_train``) linked against :func:`capi_library`."""
    if name not in _CLIENTS:
        raise ValueError("no C client %r (have %s)" % (name,
                                                       sorted(_CLIENTS)))
    capi_library()
    out_dir = capi_dir()
    out = out_dir / name
    with _lock:
        if not out.exists():
            _run_build(_capi_commands(out_dir)[1][name], out)
    return out
