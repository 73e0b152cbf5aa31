"""Hand-written CUDA kernels of the port: build, load and launch.

The sources next to this file are compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface on first use, into
``mxnet_tpu_torch/_build/`` (named by a hash of the source, so an edit
rebuilds), and called through ``ctypes`` with ``data_ptr()``s and the
current torch stream.  Nothing is built or imported at package import:
callers reach this module only for CUDA tensors.

Each launching wrapper adds one to ``launch_counts[<kernel>]`` where it
launches, so a run can show that its path went through the kernel.  Flash
attention has two sources, and a launch counts under the one that ran:
``flash_attention.cu`` (f32 arithmetic on the CUDA cores) takes f32 inputs
at any head dim and bf16 inputs with D > ``FLASH_MAX_HEAD_DIM``, and counts
``"flash_attention"``; ``flash_attention_bf16.cu`` (tensor cores) takes
bf16 inputs up to that head dim and counts ``"flash_attention_bf16"``.
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

__all__ = ["build", "quantize_2bit", "dequantize_2bit", "flash_attention_fwd",
           "flash_kernel", "bf16_vector_loads", "f32_vector_loads",
           "launch_counts", "reset_launch_counts", "SOURCES",
           "FLASH_MAX_HEAD_DIM"]

_HERE = Path(__file__).resolve().parent
SOURCES = {"compression_2bit": _HERE / "compression_2bit.cu",
           "flash_attention": _HERE / "flash_attention.cu",
           "flash_attention_bf16": _HERE / "flash_attention_bf16.cu"}
_BUILD_DIR = _HERE.parent / "_build"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# the tensor-core kernel's largest head dim; flash_attention.cu takes any
FLASH_MAX_HEAD_DIM = 256

launch_counts = {"quantize_2bit": 0, "dequantize_2bit": 0,
                 "flash_attention": 0, "flash_attention_bf16": 0}

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


def _bind(name, lib):
    vp, ll, f32, i32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                        ctypes.c_int)
    if name == "compression_2bit":
        lib.mxtt_quantize_2bit.argtypes = [vp, vp, vp, vp, ll, f32, vp]
        lib.mxtt_quantize_2bit.restype = i32
        lib.mxtt_dequantize_2bit.argtypes = [vp, vp, ll, f32, vp]
        lib.mxtt_dequantize_2bit.restype = i32
    elif name == "flash_attention":  # also the type and the loader flag
        lib.mxtt_flash_attention_fwd.argtypes = (
            [vp] * 5 + [i32] * 5 + [ll] * 9 + [f32, i32, i32, i32, vp])
        lib.mxtt_flash_attention_fwd.restype = i32
    else:  # the bf16 entry point also takes the loader flag
        lib.mxtt_flash_attention_fwd_bf16.argtypes = (
            [vp] * 5 + [i32] * 5 + [ll] * 9 + [f32, i32, i32, vp])
        lib.mxtt_flash_attention_fwd_bf16.restype = i32
    lib.mxtt_error_string.argtypes = [ctypes.c_int]
    lib.mxtt_error_string.restype = ctypes.c_char_p
    return lib


def _load(name):
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = _libs[name]
    return lib


def build(names=None):
    """Compile the named kernel sources (default: all of ``SOURCES``) not
    built yet (one ``nvcc`` per source, all started together, each into a
    temporary file renamed into place) and load them.  Returns
    ``(seconds, {name: ptxas report})``; a source reused from ``_build/``
    reports ``""``."""
    names = tuple(SOURCES) if names is None else tuple(names)
    t0 = time.perf_counter()
    running = {}
    for name in names:
        src, lib_path = SOURCES[name], _lib_path(name)
        if name in _libs or lib_path.exists():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(".so.tmp%d" % os.getpid())
        cmd = [_nvcc(), _ARCH, "-std=c++17", "-O3", "-Xptxas", "-v",
               "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, lib_path)
    reports = {name: "" for name in names}
    for name, (proc, tmp, lib_path) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s"
                               % (SOURCES[name], out))
        os.replace(tmp, lib_path)
        reports[name] = out
    for name in names:
        if name not in _libs:
            _libs[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
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


def _vector_loads(tensors, per16):
    return all(t.data_ptr() % 16 == 0 and t.shape[3] % per16 == 0
               and all(s % per16 == 0 for s in t.stride()[:3])
               for t in tensors)


def bf16_vector_loads(*tensors):
    """Whether the bf16 kernels may stage these (B, T, H, D) tensors with
    16-byte copies: every data pointer and every stride times 2 bytes a
    multiple of 16, and D a multiple of 8.  Otherwise they load element by
    element into the same layout."""
    return _vector_loads(tensors, 8)


def f32_vector_loads(*tensors):
    """Whether ``flash_attention.cu`` may stage these f32 (B, T, H, D)
    tensors with 16-byte ``cp.async`` copies: every data pointer and every
    stride times 4 bytes a multiple of 16, and D a multiple of 4.
    Otherwise it loads element by element into the same layout."""
    return _vector_loads(tensors, 4)


def flash_kernel(dtype, head_dim):
    """The flash kernel (``launch_counts`` key and ``SOURCES`` name) that
    ``flash_attention_fwd`` runs for inputs of this type and head dim."""
    if dtype == torch.bfloat16 and head_dim <= FLASH_MAX_HEAD_DIM:
        return "flash_attention_bf16"
    return "flash_attention"


def flash_attention_fwd(q, k, v, scale, causal):
    """Launch the flash-attention forward on (B, T, H, D) ``q``, ``k``,
    ``v`` of one type, read through their strides (the head dim must have
    stride 1): f32 at any D, and bf16 with D > ``FLASH_MAX_HEAD_DIM``, on
    ``flash_attention.cu``; bf16 up to that D on the tensor-core kernel
    ``flash_attention_bf16.cu``.  Returns (o (B, Tq, H, D) in the input
    type, lse (B, Tq, H) f32), both contiguous."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError("flash_attention_fwd takes (B, T, H, D) q, k, v with "
                         "matching B, H, D and k, v of one shape; got %s, %s, "
                         "%s" % (tuple(q.shape), tuple(k.shape),
                                 tuple(v.shape)))
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if min(B, Tq, Tk, H, D) < 1:
        raise ValueError("flash_attention_fwd: empty input %s, %s"
                         % (tuple(q.shape), tuple(k.shape)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError("%s must be a CUDA tensor" % name)
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
        if t.dtype not in (torch.float32, torch.bfloat16) or \
                t.dtype != q.dtype:
            raise TypeError("q, k, v must all be float32 or all bfloat16; "
                            "got %s, %s, %s" % (q.dtype, k.dtype, v.dtype))
        if t.stride(3) != 1 or min(t.stride()) < 0:
            raise ValueError("%s: the head dim must have stride 1 and no "
                             "stride may be negative; strides %s"
                             % (name, t.stride()))
    bf16 = q.dtype == torch.bfloat16
    name = flash_kernel(q.dtype, D)
    lib = _load(name)
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Tq, H), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in (t.stride(0), t.stride(1),
                                              t.stride(2))]
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, Tq, Tk, D, *strides, float(scale),
            int(bool(causal))]
    # the loader: 16-byte copies or element by element
    vec = bf16_vector_loads(q, k, v) if bf16 else f32_vector_loads(q, k, v)
    if name == "flash_attention_bf16":
        fn = lib.mxtt_flash_attention_fwd_bf16
        args.append(int(vec))
    else:
        fn = lib.mxtt_flash_attention_fwd
        args += [int(bf16), int(vec)]
    with torch.cuda.device(q.device):
        args.append(torch.cuda.current_stream().cuda_stream)
        err = fn(*args)
    _raise_on(lib, err, name)
    launch_counts[name] += 1
    return o, lse
