"""The non-finite step guard's policy (parity: mxnet_tpu/checkpoint.py
``NonfiniteError`` and ``nonfinite_policy`` / ``check_finite``) and
``atomic_write``, which the Trainer's and the KVStore's state files use,
and ``retry`` (parity: mxnet_tpu/checkpoint.py:164), which the serving
Predictor's host-to-card copy goes through.

Checkpointing itself (sharded, topology-elastic) is not ported yet.
"""
from __future__ import annotations

import logging
import os
import random as _pyrandom
import tempfile
import time
import warnings

import numpy as np

from .base import MXNetError
from . import config as _config

__all__ = ["NonfiniteError", "NONFINITE_POLICIES", "nonfinite_policy",
           "check_finite", "atomic_write", "retry"]


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


def retry(fn, retries=3, backoff=0.05, jitter=0.5, exceptions=(OSError,),
          logger=None, deadline=None):
    """Wrap ``fn`` with bounded retries + exponential backoff + jitter.

    ``retries`` is the number of *re*-attempts after the first call (so
    the function runs at most ``retries + 1`` times).  Backoff doubles
    per attempt; jitter adds a uniform fraction of the current delay so
    a fleet of workers retrying a shared endpoint does not stampede in
    lockstep.  Only ``exceptions`` are retried — anything else
    propagates immediately.

    ``deadline`` (seconds, measured from the first attempt of each
    call) is an overall wall-clock budget: a re-attempt whose backoff
    sleep would not fit inside the remaining budget is abandoned and
    the last failure re-raised immediately.
    """
    if retries < 0:
        raise ValueError("retries must be >= 0, got %r" % (retries,))
    if deadline is not None and deadline < 0:
        raise ValueError("deadline must be >= 0, got %r" % (deadline,))

    def wrapped(*args, **kwargs):
        t0 = time.monotonic()
        delay = backoff
        for attempt in range(retries + 1):
            try:
                return fn(*args, **kwargs)
            except exceptions as e:
                if attempt == retries:
                    raise
                sleep = delay * (1.0 + jitter * _pyrandom.random())
                if deadline is not None and \
                        time.monotonic() - t0 + sleep >= deadline:
                    (logger or logging).warning(
                        "retry budget exhausted after %s (deadline "
                        "%.3fs): %s", getattr(fn, "__name__", fn),
                        deadline, e)
                    raise
                (logger or logging).warning(
                    "retry %d/%d after %s: %s (sleeping %.3fs)",
                    attempt + 1, retries, getattr(fn, "__name__", fn), e,
                    sleep)
                time.sleep(sleep)
                delay *= 2
        raise AssertionError("unreachable")

    wrapped.__name__ = "retry(%s)" % getattr(fn, "__name__", "fn")
    return wrapped


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
