"""2-bit gradient compression with error feedback (parity:
mxnet_tpu/contrib/compression.py; reference
src/kvstore/gradient_compression.h:38-47, python/mxnet/kvstore.py:394).

Per element: ``g = grad + residual``; emit +t and keep ``g - t`` when
``g >= t``, emit -t and keep ``g + t`` when ``g <= -t``, else emit 0 and
keep ``g``.  Codes are 2 bits (01 -> +t, 10 -> -t, 00 -> 0), 16 per
int32, in the JAX package's packed layout, so codes compare as integers
across the two packages.

On a CUDA tensor ``quantize_2bit``/``dequantize_2bit`` launch the
hand-written kernels in ``mxnet_tpu_torch/kernels/compression_2bit.cu``
and raise if they cannot; ``quantize_2bit_ref``/``dequantize_2bit_ref``
are the plain PyTorch versions, taken only for tensors on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["GradientCompression", "quantize_2bit", "dequantize_2bit",
           "quantize_2bit_ref", "dequantize_2bit_ref"]

_GROUP = 16            # codes per int32
_LANES = 128
_TILE_ROWS = 128       # rows padded to a multiple of this (one TPU tile)
_TILE = _TILE_ROWS * _LANES


def _padded_rows(size):
    return max(_TILE_ROWS, -(-size // _TILE) * _TILE // _LANES)


def _shifts(device):
    return (torch.arange(_GROUP, dtype=torch.int32, device=device) * 2
            ).view(1, _GROUP, 1)


def quantize_2bit_ref(grad, residual, threshold):
    """Plain PyTorch quantize on (rows, 128) f32 arrays; returns (int32
    codes (rows/16, 128), new residual (rows, 128))."""
    t = torch.tensor(float(threshold), dtype=torch.float32,
                     device=grad.device)
    zero = torch.zeros((), dtype=torch.float32, device=grad.device)
    g = grad + residual
    pos = g >= t
    neg = g <= -t
    new_res = (g - torch.where(pos, t, zero)) + torch.where(neg, t, zero)
    code = pos.to(torch.int32) | (neg.to(torch.int32) << 1)
    # OR the shifted codes in int32: code 2 at j = 15 is bit 31, the sign
    # bit, which an int64 sum narrowed to int32 would not keep
    shifted = code.view(-1, _GROUP, _LANES) << _shifts(grad.device)
    packed = shifted[:, 0]
    for j in range(1, _GROUP):
        packed = packed | shifted[:, j]
    return packed.contiguous(), new_res


def dequantize_2bit_ref(codes, threshold):
    """Plain PyTorch dequantize of int32 codes (rows/16, 128) to f32
    (rows, 128)."""
    t = torch.tensor(float(threshold), dtype=torch.float32,
                     device=codes.device)
    zero = torch.zeros((), dtype=torch.float32, device=codes.device)
    # arithmetic shift, made harmless by the & 3 mask
    bits = (codes.unsqueeze(1) >> _shifts(codes.device)) & 3
    vals = torch.where(bits == 1, t, torch.where(bits == 2, -t, zero))
    return vals.reshape(-1, _LANES)


def _pad2d(flat, rows):
    flat = flat.reshape(-1).to(torch.float32)
    return F.pad(flat, (0, rows * _LANES - flat.numel())).view(rows, _LANES)


def _quantize_padded(grad2d, residual2d, threshold):
    if grad2d.is_cuda:
        from .. import kernels

        return kernels.quantize_2bit(grad2d, residual2d, threshold)
    return quantize_2bit_ref(grad2d, residual2d, threshold)


def quantize_2bit(grad, residual, threshold=0.5):
    """(codes int32 (rows, 128)/16, new residual flat) from a flat f32
    gradient and residual, zero-padded to ``_padded_rows`` rows."""
    size = grad.numel()
    rows = _padded_rows(size)
    codes, new_res = _quantize_padded(_pad2d(grad, rows),
                                      _pad2d(residual, rows), threshold)
    return codes, new_res.reshape(-1)[:size]


def dequantize_2bit(codes, size, threshold=0.5):
    """Flat f32 gradient of ``size`` elements from packed codes."""
    if codes.is_cuda:
        from .. import kernels

        out = kernels.dequantize_2bit(codes, threshold)
    else:
        out = dequantize_2bit_ref(codes, threshold)
    return out.reshape(-1)[:size]


class GradientCompression:
    """Stateful compressor: one residual per key (the kvstore keys it by
    ``(key, worker)``), reference parameter names (type='2bit',
    threshold)."""

    def __init__(self, type="2bit", threshold=0.5, **kwargs):
        if str(type) != "2bit":
            raise MXNetError("unsupported gradient compression type %r "
                             "(only '2bit')" % (type,))
        self.type = "2bit"
        self.threshold = float(threshold)
        if self.threshold <= 0:
            raise MXNetError("threshold must be positive")
        self._residuals = {}

    def compress(self, key, grad_flat):
        """Codes for one worker's flat gradient, updating its residual.

        The residual is kept in the kernel's padded (rows, 128) layout,
        so only the gradient is padded on each push: its padding is zero
        and so stays the residual's (a zero sum emits no code)."""
        size = grad_flat.numel()
        rows = _padded_rows(size)
        kept = self._residuals.get(key)
        if kept is None or kept[0] != size:
            kept = (size, torch.zeros((rows, _LANES), dtype=torch.float32,
                                      device=grad_flat.device))
        codes, new_res = _quantize_padded(_pad2d(grad_flat, rows), kept[1],
                                          self.threshold)
        self._residuals[key] = (size, new_res)
        return codes

    def compress_dequantize(self, key, grad_nd):
        """Round-trip one gradient NDArray: what the receiving end of a
        compressed push reconstructs (the residual stays here)."""
        flat = grad_nd._data.detach().reshape(-1)
        codes = self.compress(key, flat)
        deq = dequantize_2bit(codes, flat.numel(), self.threshold)
        return NDArray(deq.view(grad_nd.shape))
