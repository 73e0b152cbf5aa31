"""Gluon utilities (parity: mxnet_tpu/gluon/utils.py:18-165; the reference
python/mxnet/gluon/utils.py): ``split_data``, ``split_and_load``,
``clip_global_norm``, ``check_sha1`` and ``download``.  ``download``
reads any URL ``urllib`` opens; ``file://`` mirrors serve machines with
no network."""
from __future__ import annotations

import hashlib
import math
import os
import time
import warnings

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "shape_is_known"]


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


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 hex digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Fetch ``url`` to ``path`` (a file, or a directory to put the URL's
    file name in; default the current directory) and return the file's
    name.  An existing file that passes ``sha1_hash`` is kept unless
    ``overwrite``.  The payload is checked against ``sha1_hash`` before
    it is written, then written atomically, so a failed or corrupt fetch
    never leaves a file; each of ``retries`` attempts waits longer
    before the next (parity: mxnet_tpu/gluon/utils.py:93)."""
    from urllib.request import urlopen

    from ..checkpoint import atomic_write

    if path is None:
        fname = url.split("/")[-1]
        if not fname:
            raise MXNetError("cannot derive a file name from url %r" % url)
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if os.path.exists(fname) and not overwrite and \
            (sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    kwargs = {}
    if not verify_ssl and url.lower().startswith("https"):
        import ssl

        kwargs["context"] = ssl._create_unverified_context()
    for attempt in range(max(1, retries)):
        try:
            with urlopen(url, **kwargs) as resp:
                payload = resp.read()
            got = hashlib.sha1(payload).hexdigest()
            if sha1_hash is not None and got != sha1_hash:
                raise OSError("sha1 mismatch for %s: got %s, want %s"
                              % (url, got, sha1_hash))
            atomic_write(fname, payload)
            return fname
        except OSError:
            if attempt + 1 >= retries:
                raise
            time.sleep(0.1 * 2 ** attempt)


def shape_is_known(shape):
    """Whether every dimension of ``shape`` is known: not None and no
    dimension 0 or None (parity: mxnet_tpu/gluon/utils.py:168)."""
    if shape is None:
        return False
    for dim_size in shape:
        if dim_size in (0, None):
            return False
    return True
