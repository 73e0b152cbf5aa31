"""Hand-written CUDA kernels of the port: build, load and launch.

The sources next to this file are compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface on first use, into
``mxnet_tpu_torch/_build/`` (named by a hash of the source, so an edit
rebuilds), and called through ``ctypes`` with ``data_ptr()``s and the
current torch stream.  Nothing is built or imported at package import:
callers reach this module only for CUDA tensors.

Each launching wrapper adds one to ``launch_counts[<kernel>]`` where it
launches, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["build", "quantize_2bit", "dequantize_2bit", "launch_counts",
           "reset_launch_counts", "SOURCES"]

_HERE = Path(__file__).resolve().parent
SOURCES = {"compression_2bit": _HERE / "compression_2bit.cu"}
_BUILD_DIR = _HERE.parent / "_build"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"

launch_counts = {"quantize_2bit": 0, "dequantize_2bit": 0}

_libs = {}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc():
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    return found


def _lib_path(name):
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / ("lib%s_%s.so" % (name, digest))


def _bind(lib):
    vp, ll, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.mxtt_quantize_2bit.argtypes = [vp, vp, vp, vp, ll, f32, vp]
    lib.mxtt_quantize_2bit.restype = ctypes.c_int
    lib.mxtt_dequantize_2bit.argtypes = [vp, vp, ll, f32, vp]
    lib.mxtt_dequantize_2bit.restype = ctypes.c_int
    lib.mxtt_error_string.argtypes = [ctypes.c_int]
    lib.mxtt_error_string.restype = ctypes.c_char_p
    return lib


def _load(name):
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = _libs[name]
    return lib


def build():
    """Compile every kernel source not built yet (one ``nvcc`` per source,
    all started together, each into a temporary file renamed into place)
    and load them all.  Returns ``(seconds, {name: ptxas report})``; a
    source reused from ``_build/`` reports ``""``."""
    t0 = time.perf_counter()
    running = {}
    for name, src in SOURCES.items():
        lib_path = _lib_path(name)
        if name in _libs or lib_path.exists():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(".so.tmp%d" % os.getpid())
        cmd = [_nvcc(), _ARCH, "-std=c++17", "-O3", "-Xptxas", "-v",
               "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, lib_path)
    reports = {name: "" for name in SOURCES}
    for name, (proc, tmp, lib_path) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s"
                               % (SOURCES[name], out))
        os.replace(tmp, lib_path)
        reports[name] = out
    for name in SOURCES:
        if name not in _libs:
            _libs[name] = _bind(ctypes.CDLL(str(_lib_path(name))))
    return time.perf_counter() - t0, reports


def _check(t, dtype, name):
    if not t.is_cuda:
        raise ValueError("%s must be a CUDA tensor" % name)
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError("%s launch failed: %s"
                           % (what, lib.mxtt_error_string(err).decode()))


def quantize_2bit(grad, residual, threshold):
    """Launch the quantize kernel on (rows, 128) f32 ``grad``/``residual``
    (rows a multiple of 128); returns (int32 codes (rows/16, 128), new
    f32 residual (rows, 128))."""
    _check(grad, torch.float32, "grad")
    _check(residual, torch.float32, "residual")
    rows = grad.shape[0]
    if grad.dim() != 2 or grad.shape[1] != 128 or rows % 128 or \
            residual.shape != grad.shape or residual.device != grad.device:
        raise ValueError("quantize_2bit takes two (rows, 128) arrays on one "
                         "device, rows a multiple of 128; got %s and %s"
                         % (tuple(grad.shape), tuple(residual.shape)))
    lib = _load("compression_2bit")
    codes = torch.empty((rows // 16, 128), dtype=torch.int32,
                        device=grad.device)
    new_res = torch.empty_like(grad)
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mxtt_quantize_2bit(
            grad.data_ptr(), residual.data_ptr(), codes.data_ptr(),
            new_res.data_ptr(), codes.numel(), float(threshold), stream)
    _raise_on(lib, err, "quantize_2bit")
    launch_counts["quantize_2bit"] += 1
    return codes, new_res


def dequantize_2bit(codes, threshold):
    """Launch the dequantize kernel on int32 codes (rows/16, 128); returns
    f32 (rows, 128)."""
    _check(codes, torch.int32, "codes")
    if codes.dim() != 2 or codes.shape[1] != 128 or codes.shape[0] % 8:
        raise ValueError("dequantize_2bit takes (rows/16, 128) codes, rows "
                         "a multiple of 128; got %s" % (tuple(codes.shape),))
    lib = _load("compression_2bit")
    out = torch.empty((codes.shape[0] * 16, 128), dtype=torch.float32,
                      device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mxtt_dequantize_2bit(codes.data_ptr(), out.data_ptr(),
                                       codes.numel(), float(threshold),
                                       stream)
    _raise_on(lib, err, "dequantize_2bit")
    launch_counts["dequantize_2bit"] += 1
    return out
