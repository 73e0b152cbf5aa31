"""Hand-written CUDA kernels of the port: build, load and launch.

The sources next to this file are compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface on first use, into
``mxnet_tpu_torch/_build/`` (named by a hash of the source, so an edit
rebuilds), and called through ``ctypes`` with ``data_ptr()``s and the
current torch stream.  Nothing is built or imported at package import:
callers reach this module only for CUDA tensors.

Each launching wrapper adds one to ``launch_counts[<kernel>]`` where it
launches, so a run can show that its path went through the kernel.  The
two compression kernels take a whole batch of entries (every key and
worker of a KVStore push) in one launch each, placed by an entry table
that ``compression_table`` builds on the host; its device copy is reused
while the layout and the addresses stay the same (``table_uploads``
counts the copies).  Flash
attention has two sources, and a launch counts under the one that ran:
``flash_attention.cu`` (f32 arithmetic on the CUDA cores) takes f32 inputs
at any head dim and bf16 inputs with D > ``FLASH_MAX_HEAD_DIM``, and counts
``"flash_attention"``; ``flash_attention_bf16.cu`` (tensor cores) takes
bf16 inputs up to that head dim and counts ``"flash_attention_bf16"``.
Two kernels replace no Pallas kernel: ``int8_conv.cu``, the int8 x int8
-> int32 implicit-GEMM convolution of ``quantized_conv`` and
``quantized_fully_connected`` (``int8_conv``: a layout pass to padded
NHWC, then ``wgmma`` on a ``cp.async`` ring), and ``nms.cu``, the greedy
suppression pass of MultiBoxDetection, ``box_nms`` and Proposal (``nms``:
a bitmask NMS, the IoU mask on every SM, then a walk of 64-box chunks);
each is reached through a ``torch.library`` custom op
(``ops/quantization.py``, ``ops/ssd.py``), so a compiled graph holds it.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

__all__ = ["build", "quantize_2bit", "dequantize_2bit", "quantize_2bit_batch",
           "dequantize_2bit_batch", "quantize_2bit_batch_launcher",
           "dequantize_2bit_batch_launcher", "compression_table",
           "compression_vector_loads", "COMPRESSION_FIELDS",
           "flash_attention_fwd",
           "flash_kernel", "bf16_vector_loads", "f32_vector_loads",
           "launch_counts", "reset_launch_counts", "SOURCES",
           "FLASH_MAX_HEAD_DIM", "int8_conv", "int8_conv_weight_rows",
           "int8_conv_nhwc_plain", "nms", "nms_rows_per_pass",
           "NMS_MAX_BOXES", "NMS_WORKSPACE_BYTES"]

_HERE = Path(__file__).resolve().parent
SOURCES = {"compression_2bit": _HERE / "compression_2bit.cu",
           "flash_attention": _HERE / "flash_attention.cu",
           "flash_attention_bf16": _HERE / "flash_attention_bf16.cu",
           "int8_conv": _HERE / "int8_conv.cu",
           "nms": _HERE / "nms.cu"}
_BUILD_DIR = _HERE.parent / "_build"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# the tensor-core kernel's largest head dim; flash_attention.cu takes any
FLASH_MAX_HEAD_DIM = 256

# the nms kernel's walk keeps an image's removed bits in shared memory, a
# bit a box (29 KB at this many)
NMS_MAX_BOXES = 232448
# the most bytes of suppression mask one nms call holds; a larger mask is
# made and walked in passes over row ranges
NMS_WORKSPACE_BYTES = 256 << 20

launch_counts = {"quantize_2bit": 0, "dequantize_2bit": 0,
                 "flash_attention": 0, "flash_attention_bf16": 0,
                 "int8_conv": 0, "nms": 0}

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
        lib.mxtt_quantize_2bit_batch.argtypes = [vp, ll, ll, vp, vp, vp, f32,
                                                 vp]
        lib.mxtt_quantize_2bit_batch.restype = i32
        lib.mxtt_dequantize_2bit_batch.argtypes = [vp, ll, ll, vp, vp, f32,
                                                   i32, vp]
        lib.mxtt_dequantize_2bit_batch.restype = i32
    elif name == "flash_attention":  # also the type and the loader flag
        lib.mxtt_flash_attention_fwd.argtypes = (
            [vp] * 5 + [i32] * 5 + [ll] * 9 + [f32, i32, i32, i32, vp])
        lib.mxtt_flash_attention_fwd.restype = i32
    elif name == "flash_attention_bf16":  # also takes the loader flag
        lib.mxtt_flash_attention_fwd_bf16.argtypes = (
            [vp] * 5 + [i32] * 5 + [ll] * 9 + [f32, i32, i32, vp])
        lib.mxtt_flash_attention_fwd_bf16.restype = i32
    elif name == "int8_conv":
        lib.mxtt_int8_conv.argtypes = [vp] * 4 + [i32] * 14 + [vp]
        lib.mxtt_int8_conv.restype = i32
    else:
        lib.mxtt_nms.argtypes = [vp] * 6 + [i32, i32, i32, f32, i32, i32,
                                             i32, vp]
        lib.mxtt_nms.restype = i32
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


def _on(device):
    """The device context for a launch on ``device``: nothing to enter when
    it is current already (the common case; entering costs host time a
    call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError("%s launch failed: %s"
                           % (what, lib.mxtt_error_string(err).decode()))


# One row of the compression kernels' entry table (struct Entry in
# compression_2bit.cu), in int64s: the gradient's address, its real
# elements, the offsets of the residual read and written (floats), of the
# codes (words) and of the dequantized values (floats), the entry's first
# tile in the launch, and 1 where the gradient and both residuals take
# 16-byte accesses.
COMPRESSION_FIELDS = ("grad", "size", "residual_in", "residual_out",
                      "codes", "values", "first_tile", "vector")
_TABLES_KEPT = 16
_tables = OrderedDict()   # device copies of recent entry tables
table_uploads = 0         # host-to-device copies of entry tables


def compression_vector_loads(*tensors):
    """Whether the compression kernels may read and write these f32
    buffers (a gradient, a residual) with 16-byte accesses: every data
    pointer a multiple of 16 bytes.  Otherwise that entry takes the
    kernel's element-by-element path."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def compression_table(layout, grads=None, residual_in=None,
                      residual_out=None):
    """The entry table of a batched compression launch on ``layout`` (a
    ``contrib.compression.BatchLayout``), as int64 numpy: one row of
    ``COMPRESSION_FIELDS`` per entry, then the entry of each tile as
    int32, two to an int64.  Without ``grads`` (dequantize) the address
    and vector fields are 0."""
    rows = np.zeros((len(layout.sizes), len(COMPRESSION_FIELDS)), np.int64)
    rows[:, 1] = layout.sizes
    rows[:, 2] = rows[:, 3] = rows[:, 5] = layout.value_offsets
    rows[:, 4] = layout.code_offsets
    rows[:, 6] = layout.first_tile
    if grads is not None:
        rows[:, 0] = [g.data_ptr() for g in grads]
        aligned = compression_vector_loads(residual_in, residual_out)
        rows[:, 7] = [aligned and compression_vector_loads(g) for g in grads]
    tiles = np.repeat(np.arange(len(layout.sizes), dtype=np.int32),
                      layout.tiles)
    tiles = np.concatenate([tiles, np.zeros(len(tiles) % 2, np.int32)])
    return np.concatenate([rows.reshape(-1), tiles.view(np.int64)])


def _device_table(layout, device, grads=None, residual_in=None,
                  residual_out=None):
    """The entry table on ``device``: one host-to-device copy when the
    layout or an address changed, else the copy made before."""
    global table_uploads
    key = (device, layout, None if grads is None else (
        tuple(g.data_ptr() for g in grads), residual_in.data_ptr(),
        residual_out.data_ptr()))
    table = _tables.get(key)
    if table is None:
        host = compression_table(layout, grads, residual_in, residual_out)
        # from pageable memory: the call returns once the bytes are staged
        table = torch.from_numpy(host).to(device)
        table_uploads += 1
        _tables[key] = table
        if len(_tables) > _TABLES_KEPT:
            _tables.popitem(last=False)
    else:
        _tables.move_to_end(key)
    return table


def _check_flat(name, t, dtype, n, device):
    _check(t, dtype, name)
    if t.numel() < n or t.device != device:
        raise ValueError("%s: %d elements on %s, expected at least %d on %s"
                         % (name, t.numel(), t.device, n, device))


def _values_extent(layout):
    """Floats a residual or value buffer must hold: up to the last entry's
    last real element (the layout's ``n_values`` rounds that up to 4)."""
    return layout.value_offsets[-1] + layout.sizes[-1] if layout.sizes else 0


def _launcher(name, entry_point, table, args, device):
    """A call that launches kernel ``name`` with ``args`` (the entry table
    kept alive with it) on the current stream and counts the launch."""
    lib = _load("compression_2bit")
    fn = getattr(lib, entry_point)
    args = (table.data_ptr(),) + tuple(args)

    def launch():
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        _raise_on(lib, err, name)
        launch_counts[name] += 1
    return launch


def quantize_2bit_batch_launcher(layout, grads, residual_in, residual_out,
                                 codes, threshold):
    """Check the arguments of ``quantize_2bit_batch`` and return a call
    that launches it (each call one launch on the same buffers)."""
    device = codes.device
    if len(grads) != len(layout.sizes):
        raise ValueError("quantize_2bit_batch: %d gradients for %d entries"
                         % (len(grads), len(layout.sizes)))
    for i, (g, n) in enumerate(zip(grads, layout.sizes)):
        # the common case in one test, the message from the full checks
        if not (g.is_cuda and g.dtype == torch.float32 and g.numel() == n
                and g.is_contiguous() and g.device == device):
            _check_flat("grads[%d]" % i, g, torch.float32, n, device)
    extent = _values_extent(layout)
    _check_flat("residual_in", residual_in, torch.float32, extent, device)
    _check_flat("residual_out", residual_out, torch.float32, extent, device)
    _check_flat("codes", codes, torch.int32, layout.n_code_words, device)
    if codes.data_ptr() % 16:
        raise ValueError("codes must be 16-byte aligned")
    table = _device_table(layout, device, grads, residual_in, residual_out)
    return _launcher("quantize_2bit", "mxtt_quantize_2bit_batch", table,
                     (len(layout.sizes), layout.n_tiles,
                      residual_in.data_ptr(), residual_out.data_ptr(),
                      codes.data_ptr(), float(threshold)), device)


def quantize_2bit_batch(layout, grads, residual_in, residual_out, codes,
                        threshold):
    """Launch the quantize kernel once over every entry of ``layout``:
    entry e's flat f32 gradient ``grads[e]`` and its residual in the flat
    ``residual_in`` give its codes in the flat int32 ``codes`` and its new
    residual in ``residual_out`` (which may be ``residual_in``: the kernel
    updates in place), at the layout's offsets."""
    quantize_2bit_batch_launcher(layout, grads, residual_in, residual_out,
                                 codes, threshold)()


def dequantize_2bit_batch_launcher(layout, codes, out, threshold):
    """Check the arguments of ``dequantize_2bit_batch`` and return a call
    that launches it."""
    device = codes.device
    _check_flat("codes", codes, torch.int32, layout.n_code_words, device)
    _check_flat("out", out, torch.float32, _values_extent(layout), device)
    if out.data_ptr() % 16:
        raise ValueError("out must be 16-byte aligned")
    table = _device_table(layout, device)
    return _launcher("dequantize_2bit", "mxtt_dequantize_2bit_batch", table,
                     (len(layout.sizes), layout.n_tiles, codes.data_ptr(),
                      out.data_ptr(), float(threshold),
                      int(compression_vector_loads(codes))), device)


def dequantize_2bit_batch(layout, codes, out, threshold):
    """Launch the dequantize kernel once over every entry of ``layout``:
    entry e's codes in the flat int32 ``codes`` give its real elements in
    the flat f32 ``out`` at its values offset (the gaps between entries
    are not written)."""
    dequantize_2bit_batch_launcher(layout, codes, out, threshold)()


def quantize_2bit(grad, residual, threshold):
    """Quantize (rows, 128) f32 ``grad``/``residual`` (rows a multiple of
    128), a batch of one on the batched kernel; returns (int32 codes
    (rows/16, 128), new f32 residual (rows, 128))."""
    _check(grad, torch.float32, "grad")
    _check(residual, torch.float32, "residual")
    rows = grad.shape[0]
    if grad.dim() != 2 or grad.shape[1] != 128 or rows % 128 or \
            residual.shape != grad.shape or residual.device != grad.device:
        raise ValueError("quantize_2bit takes two (rows, 128) arrays on one "
                         "device, rows a multiple of 128; got %s and %s"
                         % (tuple(grad.shape), tuple(residual.shape)))
    from ..contrib.compression import batch_layout

    layout = batch_layout((grad.numel(),))
    codes = torch.empty((rows // 16, 128), dtype=torch.int32,
                        device=grad.device)
    new_res = torch.empty_like(grad)
    quantize_2bit_batch(layout, [grad.view(-1)], residual.view(-1),
                        new_res.view(-1), codes.view(-1), threshold)
    return codes, new_res


def dequantize_2bit(codes, threshold):
    """Dequantize int32 codes (rows/16, 128), a batch of one on the batched
    kernel; returns f32 (rows, 128)."""
    _check(codes, torch.int32, "codes")
    if codes.dim() != 2 or codes.shape[1] != 128 or codes.shape[0] % 8:
        raise ValueError("dequantize_2bit takes (rows/16, 128) codes, rows "
                         "a multiple of 128; got %s" % (tuple(codes.shape),))
    from ..contrib.compression import batch_layout

    layout = batch_layout((codes.numel() * 16,))
    out = torch.empty((codes.shape[0] * 16, 128), dtype=torch.float32,
                      device=codes.device)
    dequantize_2bit_batch(layout, codes.view(-1), out.view(-1), threshold)
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


def int8_conv_weight_rows(w):
    """The weights as ``int8_conv.cu`` reads them: OIHW int8 ``w`` (F, Cg,
    KH, KW) permuted to (F, KH, KW, Cg16) rows, each group's channels
    zero-padded to Cg16 (a multiple of 16), as one (F, KH KW Cg16)
    tensor: depth k = (ky, kx, c), channels innermost."""
    F, Cg, KH, KW = w.shape
    if KH * KW == 1 and Cg % 16 == 0:
        return w.reshape(F, Cg)   # that order already: a view
    rows = w.permute(0, 2, 3, 1)
    if Cg % 16:
        rows = torch.nn.functional.pad(rows, (0, -Cg % 16))
    return rows.reshape(F, -1)


def int8_conv_nhwc_plain(x, groups):
    """The plain version of ``int8_conv.cu``'s layout pass: NCHW int8
    ``x`` as (N, H, W, groups Cg16), each group's channels zero-padded to
    Cg16."""
    N, C, H, W = x.shape
    cg = C // groups
    cg16 = -(-cg // 16) * 16
    g = x.reshape(N, groups, cg, H, W).permute(0, 3, 4, 1, 2)
    return torch.nn.functional.pad(g, (0, cg16 - cg)) \
        .reshape(N, H, W, groups * cg16)


def int8_conv(x, w, stride, pad, dilate, groups):
    """Launch ``int8_conv.cu`` once: int8 NCHW ``x`` convolved with int8
    OIHW ``w`` (stride, pad and dilation pairs, ``groups``) into a new
    int32 (N, F, Ho, Wo) tensor, summed exactly in int32.  The call
    rewrites the data as padded NHWC into a workspace first (a 1x1 map
    whose group width is a multiple of 16 is that layout already)."""
    _check(x, torch.int8, "x")
    _check(w, torch.int8, "w")
    if x.dim() != 4 or w.dim() != 4 or x.device != w.device:
        raise ValueError("int8_conv takes (N, C, H, W) data and (F, C/g, KH, "
                         "KW) weights on one device; got %s and %s"
                         % (tuple(x.shape), tuple(w.shape)))
    N, C, H, W = x.shape
    F, Cg, KH, KW = w.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, pad, dilate
    if groups < 1 or C != Cg * groups or F % groups:
        raise ValueError("int8_conv: %d channels, %d filters of %d channels "
                         "and %d groups do not agree" % (C, F, Cg, groups))
    Ho = (H + 2 * ph - (dh * (KH - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (KW - 1) + 1)) // sw + 1
    if Ho < 1 or Wo < 1:
        raise ValueError("int8_conv: empty output %dx%d" % (Ho, Wo))
    cg16 = -(-Cg // 16) * 16
    if N * Ho * Wo >= 2 ** 31 or H * W * groups * cg16 >= 2 ** 31:
        raise ValueError("int8_conv: %d output pixels or %d bytes an image "
                         "reach 2^31" % (N * Ho * Wo, H * W * groups * cg16))
    wp = int8_conv_weight_rows(w)
    if wp.data_ptr() % 16:
        wp = wp.clone()
    out = torch.empty((N, F, Ho, Wo), dtype=torch.int32, device=x.device)
    ws = None
    if not (H * W == 1 and Cg % 16 == 0 and x.data_ptr() % 16 == 0):
        ws = torch.empty(N * H * W * groups * cg16, dtype=torch.int8,
                         device=x.device)
    lib = _load("int8_conv")
    with _on(x.device):
        err = lib.mxtt_int8_conv(
            x.data_ptr(), wp.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), N, C, H, W, F, KH, KW,
            sh, sw, ph, pw, dh, dw, groups,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "int8_conv")
    launch_counts["int8_conv"] += 1
    return out


def nms_rows_per_pass(batch, n):
    """Rows of each of ``nms.cu``'s passes: all of them (rounded up to
    64) when the mask, ``batch`` x rows x ceil(n/64) 8-byte words, fits in
    ``NMS_WORKSPACE_BYTES`` (read at each call), else the most multiples of
    64 that do (at least 64)."""
    nb = -(-n // 64)
    row_bytes = max(1, batch) * nb * 8
    if nb * 64 * row_bytes <= NMS_WORKSPACE_BYTES:
        return nb * 64
    return max(64, NMS_WORKSPACE_BYTES // row_bytes // 64 * 64)


def nms(boxes, ids, alive, thresh, class_aware, inclusive, plus_one):
    """Launch ``nms.cu`` once over a batch of sorted candidates: f32
    corner ``boxes`` (B, N, 4), f32 class ``ids`` (B, N) and bool
    ``alive`` (B, N) give the bool keep mask (B, N) of greedy
    suppression at IoU ``thresh`` (``>=`` when ``inclusive``, else ``>``;
    only within a class when ``class_aware``; the +1 pixel areas when
    ``plus_one``).  The suppression mask's workspace stays under
    ``NMS_WORKSPACE_BYTES``: above it the call runs in passes over row
    ranges (``nms_rows_per_pass``)."""
    _check(boxes, torch.float32, "boxes")
    _check(ids, torch.float32, "ids")
    _check(alive, torch.bool, "alive")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or \
            ids.shape != boxes.shape[:2] or alive.shape != ids.shape or \
            ids.device != boxes.device or alive.device != boxes.device:
        raise ValueError("nms takes (B, N, 4) boxes with (B, N) ids and alive "
                         "on one device; got %s, %s, %s"
                         % (tuple(boxes.shape), tuple(ids.shape),
                            tuple(alive.shape)))
    B, N = ids.shape
    if N > NMS_MAX_BOXES:
        raise ValueError("nms: %d boxes an image, at most %d"
                         % (N, NMS_MAX_BOXES))
    if B > 65535:
        raise ValueError("nms: %d images, at most 65535" % B)
    if boxes.data_ptr() % 16:
        raise ValueError("nms: boxes must be 16-byte aligned")
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes.device)
    rows = nms_rows_per_pass(B, N)
    nb = -(-N // 64)
    mask = torch.empty(max(1, B * rows * nb), dtype=torch.int64,
                       device=boxes.device)
    removed = torch.empty(max(1, B * nb), dtype=torch.int64,
                          device=boxes.device)
    lib = _load("nms")
    with _on(boxes.device):
        err = lib.mxtt_nms(boxes.data_ptr(), ids.data_ptr(), alive.data_ptr(),
                           keep.data_ptr(), mask.data_ptr(),
                           removed.data_ptr(), B, N, rows, float(thresh),
                           int(bool(class_aware)), int(bool(inclusive)),
                           int(bool(plus_one)),
                           torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "nms")
    launch_counts["nms"] += 1
    return keep
