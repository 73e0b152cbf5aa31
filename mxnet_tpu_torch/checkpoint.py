"""The non-finite step guard's policy (parity: mxnet_tpu/checkpoint.py
``NonfiniteError`` and ``nonfinite_policy`` / ``check_finite``) and
``atomic_write``, which the Trainer's and the KVStore's state files use.

Checkpointing itself (sharded, topology-elastic) is not ported yet.
"""
from __future__ import annotations

import logging
import os
import tempfile
import warnings

import numpy as np

from .base import MXNetError
from . import config as _config

__all__ = ["NonfiniteError", "NONFINITE_POLICIES", "nonfinite_policy",
           "check_finite", "atomic_write"]


def atomic_write(fname, data):
    """Write ``data`` (bytes, or str as UTF-8) to ``fname`` through a
    temporary file in its directory and a rename: a reader sees the old
    file or the whole new one, never a torn one."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    fname = os.fspath(fname)
    dirname = os.path.dirname(os.path.abspath(fname))
    fd, tmp = tempfile.mkstemp(dir=dirname, prefix=".tmp_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


class NonfiniteError(MXNetError):
    """A guarded value (loss/gradient norm) was NaN or Inf under the
    ``"raise"`` non-finite policy."""


NONFINITE_POLICIES = ("off", "warn", "skip", "raise")


def nonfinite_policy(policy=None):
    """Resolve a non-finite policy: explicit arg wins, else the
    ``MXNET_NONFINITE_POLICY`` env flag (default ``"warn"``)."""
    if policy is None:
        policy = _config.get("MXNET_NONFINITE_POLICY") or "warn"
    if policy not in NONFINITE_POLICIES:
        raise MXNetError("unknown non-finite policy %r (choose from %s or "
                         "None for the MXNET_NONFINITE_POLICY default)"
                         % (policy, "/".join(NONFINITE_POLICIES)))
    return policy


def check_finite(values, policy, what="loss", logger=None):
    """Apply ``policy`` to host value(s); returns whether the pending
    update should be APPLIED.

    ``True``  — values finite, or policy is ``off``/``warn`` (the warn
    policy reports but does not discard).  ``False`` — values non-finite
    under ``skip``: the caller must discard the update and keep the
    previous params/optimizer state.  Raises :class:`NonfiniteError`
    under ``raise``.
    """
    if policy == "off":
        return True
    if not isinstance(values, (list, tuple)):
        values = [values]
    finite = True
    for v in values:
        a = np.asarray(v)
        if a.dtype.kind in "fc" and not bool(np.all(np.isfinite(a))):
            finite = False
            break
    if finite:
        return True
    msg = ("non-finite %s detected (policy=%s)" % (what, policy))
    from . import tracing as _tracing

    # black-box dump before the policy acts (a no-op unless armed); under
    # "raise" it is taken inside the except block, so the bundle's
    # exception carries a traceback and the step's own exception hook
    # files no second bundle
    if policy == "raise":
        try:
            raise NonfiniteError(msg)
        except NonfiniteError as err:
            _tracing.record_crash("nonfinite", err,
                                  extra={"what": what, "policy": policy})
            raise
    _tracing.record_crash("nonfinite",
                          extra={"what": what, "policy": policy})
    if policy == "skip":
        (logger or logging).warning("%s: discarding this update, keeping "
                                    "previous params/optimizer state", msg)
        return False
    warnings.warn(msg + ": continuing; results will be undefined",
                  stacklevel=2)
    return True
