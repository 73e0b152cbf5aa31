"""Gluon utilities (parity: mxnet_tpu/gluon/utils.py:18-81; the reference
python/mxnet/gluon/utils.py): ``split_data``, ``split_and_load`` and
``clip_global_norm``.  ``download`` and ``check_sha1`` are not ported:
there is nothing to download in the port."""
from __future__ import annotations

import math
import warnings

import torch

from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; with
    ``even_split=False`` the last slices may be shorter."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." % (
                str(data.shape), num_slice, batch_axis, num_slice))
    if not even_split:
        step = int(math.ceil(size / num_slice))
        return [data.slice_axis(batch_axis, i * step,
                                min((i + 1) * step, size))
                for i in range(num_slice) if i * step < size]
    n_each = size // num_slice
    return [data.slice_axis(batch_axis, i * n_each, (i + 1) * n_each)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` (an NDArray or numpy array) into one slice per
    context and put each slice there."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True,
                     on_nonfinite=None):
    """Scale ``arrays`` in place so that their global L2 norm is at most
    ``max_norm``; returns the norm before scaling.  Each array's sum of
    squares is taken on its device and all of them reach the host in one
    copy, then add up in Python floats, as the JAX function adds its
    per-array scalars.  A NaN or Inf norm goes through the non-finite
    policy (``on_nonfinite``; None reads MXNET_NONFINITE_POLICY): 'warn'
    warns and clips anyway, 'skip' leaves the arrays as they are, 'raise'
    raises ``NonfiniteError``."""
    assert len(arrays) > 0
    with torch.no_grad():
        sums = torch.stack([torch.sum(a._data * a._data).to(
            arrays[0]._data.device) for a in arrays]).cpu().tolist()
    total_norm = math.sqrt(sum(float(s) for s in sums))
    if check_isfinite and not math.isfinite(total_norm):
        from ..checkpoint import nonfinite_policy, NonfiniteError

        policy = nonfinite_policy(on_nonfinite)
        if policy == "raise":
            raise NonfiniteError(
                "global gradient norm is %r (policy=raise)" % total_norm)
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
        if policy == "skip":
            return total_norm
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for a in arrays:
                a._data.mul_(scale)
    return total_norm
