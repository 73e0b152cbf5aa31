"""2-bit gradient compression with error feedback (parity:
mxnet_tpu/contrib/compression.py; reference
src/kvstore/gradient_compression.h:38-47, python/mxnet/kvstore.py:394).

Per element: ``g = grad + residual``; emit +t and keep ``g - t`` when
``g >= t``, emit -t and keep ``g + t`` when ``g <= -t``, else emit 0 and
keep ``g``.  Codes are 2 bits (01 -> +t, 10 -> -t, 00 -> 0), 16 per
int32, in the JAX package's packed layout, so codes compare as integers
across the two packages.

Every call is a batch of entries (one per key and worker; a single-key
call is a batch of one) over three flat buffers, placed by
``BatchLayout``: each entry's codes keep the JAX package's per-key layout
(its own zero padding to whole (128, 128) tiles), while its residual and
its dequantized values hold only its real elements, at offsets rounded
up to 4 floats.  Padding always quantizes to code 00 with residual 0, so
it is never stored.

On CUDA tensors the batched calls launch the hand-written kernels in
``mxnet_tpu_torch/kernels/compression_2bit.cu``, one launch of each for
the whole batch, and raise if they cannot; ``quantize_batch_ref`` /
``dequantize_batch_ref`` (loops of ``quantize_2bit_ref`` /
``dequantize_2bit_ref`` over the entries, filling the same buffers) are
the plain PyTorch versions, taken only for tensors on the CPU.

``GradientCompression`` keeps the residuals of a push's (key, worker)
entries in one flat f32 arena that the quantize kernel updates in place
(each element is read and written by the one thread that owns it).  The
public ``quantize_2bit`` stays pure: it writes a fresh residual, as the
JAX package returns a new one.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["GradientCompression", "BatchLayout", "batch_layout",
           "quantize_2bit", "dequantize_2bit", "quantize_batch",
           "dequantize_batch", "quantize_2bit_ref", "dequantize_2bit_ref",
           "quantize_batch_ref", "dequantize_batch_ref"]

_GROUP = 16            # codes per int32
_LANES = 128
_TILE_ROWS = 128       # rows padded to a multiple of this (one TPU tile)
_TILE = _TILE_ROWS * _LANES
_TILE_WORDS = _TILE // _GROUP
_ALIGN = 4             # floats: 16-byte accesses


def _padded_rows(size):
    return max(_TILE_ROWS, -(-size // _TILE) * _TILE // _LANES)


class BatchLayout:
    """Where each entry of a batch lies.  For entry e of ``sizes[e]`` real
    elements: ``tiles[e]`` (128, 128) tiles of padded layout, numbered
    from ``first_tile[e]`` in the launch; its codes at
    ``code_offsets[e]`` words of the flat int32 code buffer
    (``n_code_words`` in all); its residual and dequantized values at
    ``value_offsets[e]`` floats of the flat f32 buffers (``n_values`` in
    all), a multiple of 4."""

    def __init__(self, sizes):
        self.sizes = tuple(int(n) for n in sizes)
        self.tiles = tuple(_padded_rows(n) // _TILE_ROWS for n in self.sizes)
        self.first_tile, self.value_offsets = [], []
        tiles = values = 0
        for n, t in zip(self.sizes, self.tiles):
            self.first_tile.append(tiles)
            self.value_offsets.append(values)
            tiles += t
            values += -(-n // _ALIGN) * _ALIGN
        self.code_offsets = [t * _TILE_WORDS for t in self.first_tile]
        self.n_tiles = tiles
        self.n_code_words = tiles * _TILE_WORDS
        self.n_values = values

    def values(self, flat, e):
        """Entry e's real elements in a flat f32 buffer."""
        off = self.value_offsets[e]
        return flat[off:off + self.sizes[e]]

    def codes(self, flat, e):
        """Entry e's codes, (rows/16, 128), in a flat int32 buffer."""
        off = self.code_offsets[e]
        return flat[off:off + self.tiles[e] * _TILE_WORDS].view(-1, _LANES)


@functools.lru_cache(maxsize=64)
def batch_layout(sizes):
    """The ``BatchLayout`` of a tuple of sizes (cached)."""
    return BatchLayout(sizes)


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
    return F.pad(flat, (0, rows * _LANES - flat.numel())).view(rows, _LANES)


def quantize_batch_ref(layout, grads, residual_in, residual_out, codes,
                       threshold):
    """The plain version of the batched quantize: entry e's flat f32
    gradient ``grads[e]`` and its residual in ``residual_in`` give its
    codes in ``codes`` and its new residual in ``residual_out`` (which may
    be ``residual_in``), at the layout's offsets."""
    for e, grad in enumerate(grads):
        rows = _padded_rows(layout.sizes[e])
        c, r = quantize_2bit_ref(
            _pad2d(grad, rows), _pad2d(layout.values(residual_in, e), rows),
            threshold)
        layout.codes(codes, e).copy_(c)
        layout.values(residual_out, e).copy_(r.view(-1)[:layout.sizes[e]])


def dequantize_batch_ref(layout, codes, out, threshold):
    """The plain version of the batched dequantize: entry e's codes give
    its real elements in ``out`` at the layout's offsets."""
    for e, n in enumerate(layout.sizes):
        deq = dequantize_2bit_ref(layout.codes(codes, e), threshold)
        layout.values(out, e).copy_(deq.view(-1)[:n])


def _flat_f32(t):
    return t.detach().reshape(-1).to(torch.float32)


def quantize_batch(layout, grads, residual_in, residual_out, threshold):
    """Codes (flat int32, fresh) of every entry of ``layout``: entry e's
    flat f32 gradient ``grads[e]`` against its residual in the flat
    ``residual_in``, its new residual written to ``residual_out`` (which
    may be ``residual_in``).  One kernel launch on the card."""
    codes = torch.empty(layout.n_code_words, dtype=torch.int32,
                        device=residual_out.device)
    if residual_out.is_cuda:
        from .. import kernels

        kernels.quantize_2bit_batch(layout, grads, residual_in,
                                    residual_out, codes, threshold)
    else:
        quantize_batch_ref(layout, grads, residual_in, residual_out, codes,
                           threshold)
    return codes


def dequantize_batch(layout, codes, threshold):
    """Every entry's real elements (flat f32, fresh) from the flat codes of
    ``quantize_batch``.  One kernel launch on the card."""
    out = torch.empty(layout.n_values, dtype=torch.float32,
                      device=codes.device)
    if codes.is_cuda:
        from .. import kernels

        kernels.dequantize_2bit_batch(layout, codes, out, threshold)
    else:
        dequantize_batch_ref(layout, codes, out, threshold)
    return out


def quantize_2bit(grad, residual, threshold=0.5):
    """(codes int32 (rows/16, 128), new residual flat) from a flat f32
    gradient and residual of one size, as if zero-padded to
    ``_padded_rows`` rows; the residual passed in is not changed."""
    size = grad.numel()
    if residual.numel() != size:
        raise ValueError("quantize_2bit: gradient of %d elements, residual "
                         "of %d" % (size, residual.numel()))
    layout = batch_layout((size,))
    new_res = torch.empty(size, dtype=torch.float32, device=grad.device)
    codes = quantize_batch(layout, [_flat_f32(grad)], _flat_f32(residual),
                           new_res, threshold)
    return layout.codes(codes, 0), new_res


def dequantize_2bit(codes, size, threshold=0.5):
    """Flat f32 gradient of ``size`` elements from its packed codes."""
    layout = batch_layout((int(size),))
    if tuple(codes.shape) != (layout.tiles[0] * _TILE_WORDS // _LANES,
                              _LANES):
        raise ValueError("dequantize_2bit: codes of shape %s do not hold "
                         "%d elements" % (tuple(codes.shape), size))
    out = dequantize_batch(layout, codes.reshape(-1), threshold)
    return layout.values(out, 0)


class GradientCompression:
    """Stateful compressor: one error-feedback residual per key (the
    kvstore keys it by ``(key, worker)``), reference parameter names
    (type='2bit', threshold)."""

    def __init__(self, type="2bit", threshold=0.5, **kwargs):
        if str(type) != "2bit":
            raise MXNetError("unsupported gradient compression type %r "
                             "(only '2bit')" % (type,))
        self.type = "2bit"
        self.threshold = float(threshold)
        if self.threshold <= 0:
            raise MXNetError("threshold must be positive")
        # key -> its residual, a view of the arena it was last pushed in
        self._residuals = {}
        # (keys, layout, flat f32 residuals) of the last batch's key set
        self._arena = None

    def _arena_for(self, keys, layout, device):
        """The residual arena of this key set, made anew (carrying each
        key's residual over, zeros for a new key or size) when the key
        set, the sizes or the device differ from the last batch's."""
        arena = self._arena
        if arena is not None and arena[0] == keys and arena[1] is layout \
                and arena[2].device == device:
            return arena[2]
        flat = torch.zeros(layout.n_values, dtype=torch.float32,
                           device=device)
        for e, key in enumerate(keys):
            view = layout.values(flat, e)
            kept = self._residuals.get(key)
            if kept is not None and kept.numel() == view.numel():
                view.copy_(kept)
            self._residuals[key] = view
        self._arena = (keys, layout, flat)
        return flat

    def quantize_batch(self, keys, grads_flat):
        """Codes of a batch of flat gradients, one entry per (distinct)
        key, each against its own residual, which is updated in place.
        Returns (layout, flat int32 codes)."""
        keys = tuple(keys)
        if len(set(keys)) != len(keys):
            raise MXNetError("quantize_batch: a key repeats in one batch")
        grads = [_flat_f32(g) for g in grads_flat]
        layout = batch_layout(tuple(g.numel() for g in grads))
        device = grads[0].device
        arena = self._arena_for(keys, layout, device)
        return layout, quantize_batch(layout, grads, arena, arena,
                                      self.threshold)

    def compress_dequantize_batch(self, keys, grads_nd):
        """Round-trip a batch of gradient NDArrays: what the receiving end
        of a compressed push reconstructs, each a view of one fresh flat
        buffer in its gradient's shape (the residuals stay here)."""
        layout, codes = self.quantize_batch(
            keys, [g._data.reshape(-1) for g in grads_nd])
        out = dequantize_batch(layout, codes, self.threshold)
        return [NDArray(layout.values(out, e).view(g.shape))
                for e, g in enumerate(grads_nd)]

    def compress(self, key, grad_flat):
        """Codes (rows/16, 128) for one worker's flat gradient, updating
        its residual."""
        layout, codes = self.quantize_batch([key], [grad_flat])
        return layout.codes(codes, 0)

    def compress_dequantize(self, key, grad_nd):
        """Round-trip one gradient NDArray (a batch of one)."""
        return self.compress_dequantize_batch([key], [grad_nd])[0]
