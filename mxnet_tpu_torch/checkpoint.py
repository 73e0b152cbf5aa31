"""The non-finite step guard's policy (parity: mxnet_tpu/checkpoint.py
``NonfiniteError`` and ``nonfinite_policy`` / ``check_finite``).

Checkpointing itself (atomic, sharded, topology-elastic) is not ported
yet.
"""
from __future__ import annotations

import logging
import warnings

import numpy as np

from .base import MXNetError
from . import config as _config

__all__ = ["NonfiniteError", "NONFINITE_POLICIES", "nonfinite_policy",
           "check_finite"]


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
    if policy == "raise":
        raise NonfiniteError(msg)
    if policy == "skip":
        (logger or logging).warning("%s: discarding this update, keeping "
                                    "previous params/optimizer state", msg)
        return False
    warnings.warn(msg + ": continuing; results will be undefined",
                  stacklevel=2)
    return True
