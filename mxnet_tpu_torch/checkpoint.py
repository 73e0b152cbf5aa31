"""Fault-tolerant checkpointing and the step guard (parity:
mxnet_tpu/checkpoint.py).

The reference framework writes checkpoints with a bare in-place binary
``open``: a preemption mid-write leaves a truncated file that loads as
garbage or not at all.  This module makes persistence crash-safe and
training loss-spike-safe, and writes the same files as the JAX package
(names, manifest schema, ``MANIFEST_FORMAT``, digests), so a checkpoint
written by either package loads in the other:

* :func:`atomic_write` / :func:`atomic_writer` — temp file in the target
  directory + flush + ``fsync`` + ``os.replace``.  A crash at any point
  leaves either the old complete file or the new complete file.
* :class:`CheckpointManager` — step-indexed checkpoints (one ``.npz``
  data file + one sidecar JSON manifest carrying per-array SHA-256
  digests and user metadata).  The manifest is written *after* the data
  file, so manifest-present == checkpoint-complete.  Loads verify every
  digest and fall back to the newest *intact* checkpoint with a loud
  warning when the latest is corrupt.  Retention keeps the last N.
  ``async_save=True`` copies tensors to host numpy synchronously and
  serializes in a background thread (which touches only those host
  copies and makes no CUDA call); ``wait()`` is the barrier, and a
  writer's failure re-raises there or at the next ``save``.
* :meth:`CheckpointManager.install_preemption_handler` — SIGTERM/SIGINT
  flush a final checkpoint (after draining any in-flight async save)
  and set ``manager.preempted`` so training loops can exit cleanly.
* Non-finite step guards — :func:`nonfinite_policy` resolves the
  ``"warn" | "skip" | "raise" | "off"`` policy (env default
  ``MXNET_NONFINITE_POLICY``); ``"skip"`` lets a front-end discard a
  NaN/Inf update and keep the previous params/optimizer state.
* :func:`retry` — bounded retry with backoff, which the serving
  Predictor's host-to-card copy goes through.
* Sharded mode — ``CheckpointManager(sharded=True)`` makes the same
  manager a distributed commit protocol: each process writes only the
  chunks it owns (one ``shard-<host>.npz`` + digest sidecar per process
  under ``{base}.shards/``), and process 0 writes the global manifest
  LAST, after a file barrier has seen every shard durable.  Interrupted
  sharded saves are therefore invisible, and ``load(restrict=...)``
  reads only the shard files that overlap what a process needs.  A
  plain tensor or numpy array is host-resident and owned by process 0;
  a duck-typed sharded array (``addressable_shards`` + ``sharding``,
  as :class:`~mxnet_tpu_torch.testing.faults.FakeShardedArray`) is
  written shard by shard.  The process index and count come from the
  constructor, else a live ``torch.distributed`` group, else (0, 1).

bfloat16 has no numpy type without ``ml_dtypes``, so a bf16 tensor is
stored as its 16-bit patterns (numpy ``V2``, as ``np.savez`` stores an
``ml_dtypes`` bf16 array) with ``"bfloat16"`` in the manifest;
:meth:`Checkpoint.tensor` gives it back as ``torch.bfloat16``.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import random as _pyrandom
import re
import shutil
import signal
import sys
import tempfile
import threading
import time
import warnings
import weakref

import numpy as np
import torch

from . import config as _config
from . import events as _events
from . import telemetry as _telemetry
from .base import MXNetError

__all__ = ["AtomicWriteError", "CheckpointCorruptError", "NonfiniteError",
           "atomic_write", "atomic_writer", "retry", "CheckpointManager",
           "Checkpoint", "nonfinite_policy", "check_finite",
           "NONFINITE_POLICIES", "validate_sharded_checkpoint",
           "module_payload", "split_module_payload", "MANIFEST_FORMAT"]

MANIFEST_FORMAT = 1
SHARD_FORMAT = 1

_ARRAY_KEY = "array:"
_BLOB_KEY = "blob:"
_LOGGER = "mxnet_tpu_torch.checkpoint"


class AtomicWriteError(MXNetError):
    """An atomic write could not be completed (the target is untouched)."""


class CheckpointCorruptError(MXNetError):
    """A checkpoint failed digest/structure verification."""


class NonfiniteError(MXNetError):
    """A guarded value (loss/gradient norm) was NaN or Inf under the
    ``"raise"`` non-finite policy."""


# ---------------------------------------------------------------------------
# atomic writes
# ---------------------------------------------------------------------------

def _fsync_dir(dirname):
    """fsync the directory so the rename itself is durable (best-effort:
    some filesystems refuse O_RDONLY dir fsync)."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_writer(path, mode="wb"):
    """Context manager yielding a file object whose contents appear at
    ``path`` atomically on clean exit.

    The temp file (``<name>.<random>.tmp``) lives in the target
    directory (``os.replace`` must not cross filesystems) and is fsync'd
    before the rename; on any error the temp file is removed and
    ``path`` is untouched.
    """
    if mode not in ("wb", "w"):
        raise AtomicWriteError("atomic_writer supports 'wb'/'w', got %r"
                               % (mode,))
    path = os.fspath(path)
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=dirname,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    f = os.fdopen(fd, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
        _fsync_dir(dirname)
    except BaseException:
        try:
            f.close()
        except Exception:
            pass
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write(path, data):
    """Write ``data`` (bytes, or str as UTF-8) to ``path`` atomically."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    with atomic_writer(path) as f:
        f.write(data)


# ---------------------------------------------------------------------------
# bounded retry
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# non-finite step-guard policy
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def _digest(arr):
    arr = np.ascontiguousarray(arr)
    return hashlib.sha256(arr.tobytes()).hexdigest()


_BF16 = "bfloat16"
_BF16_HOST = np.dtype("V2")


def _to_host(v):
    """Snapshot any array-like (NDArray / tensor / numpy / scalar) to a
    host numpy array — the synchronous part of an async save.

    Always a COPY that nothing else holds: a CPU tensor's ``numpy()``
    and ``np.asarray`` share memory with the caller's array, which the
    next train step may reuse, and the async writer thread must never
    read memory the training loop can still write.  A card tensor's
    ``cpu()`` is that copy already.  bf16 becomes its 16-bit patterns
    (``V2``)."""
    t = v._data if isinstance(getattr(v, "_data", None), torch.Tensor) \
        else v
    if isinstance(t, torch.Tensor):
        t = t.detach()
        host = t.cpu()
        if host.data_ptr() == t.data_ptr() or not host.is_contiguous():
            host = host.contiguous().clone()
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(_BF16_HOST)
        return host.numpy()
    return np.array(v, copy=True)


def _dtype_name(arr):
    """The manifest's dtype string: numpy's, and ``"bfloat16"`` for the
    16-bit patterns of a bf16 tensor (what the JAX package writes for
    an ``ml_dtypes`` bf16 array)."""
    return _BF16 if arr.dtype == _BF16_HOST else str(arr.dtype)


def _np_dtype(name):
    """The host dtype a manifest's dtype string loads as: bf16 stays as
    its 16-bit patterns (``V2``, as ``np.load`` gives it)."""
    return _BF16_HOST if name == _BF16 else np.dtype(name)


def host_to_tensor(arr, dtype_name=None):
    """A host array from a loaded checkpoint as a torch tensor (a copy);
    ``V2`` (or ``dtype_name == "bfloat16"``) becomes ``torch.bfloat16``."""
    arr = np.asarray(arr)
    if dtype_name == _BF16 or arr.dtype == _BF16_HOST or \
            arr.dtype.name == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


# ---------------------------------------------------------------------------
# sharded-checkpoint chunk geometry
# ---------------------------------------------------------------------------

def _process_info():
    """(process_index, process_count) from a live ``torch.distributed``
    group, else (0, 1).  Never initializes a group."""
    try:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank()), int(dist.get_world_size())
    except Exception:
        pass
    return 0, 1


def _index_bounds(index, shape):
    """Normalize a shard index (tuple of slices) against the global
    ``shape`` into ``[[start, stop], ...]`` (json-friendly)."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = int(dim) if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    return out


def _bounds_key(bounds):
    return tuple((int(a), int(b)) for a, b in bounds)


def _bounds_slices(bounds):
    return tuple(slice(a, b) for a, b in bounds)


def _bounds_volume(bounds):
    vol = 1
    for a, b in bounds:
        vol *= max(0, b - a)
    return vol


def _full_bounds(shape):
    return [[0, int(d)] for d in shape]


def _bounds_overlap(a, b):
    """Do two bounds lists (same rank) intersect?  Rank-0 ([] vs [])
    always overlaps."""
    return all(lo1 < hi2 and lo2 < hi1
               for (lo1, hi1), (lo2, hi2) in zip(a, b))


def _is_device_sharded(v):
    """Duck-typed sharded array: has addressable shards + a sharding
    that can map devices to index blocks (a plain tensor has neither)."""
    return hasattr(v, "addressable_shards") and hasattr(v, "sharding")


class Checkpoint:
    """One loaded checkpoint: ``step``, ``arrays`` (name -> numpy),
    ``blobs`` (name -> bytes), ``meta`` (the user dict), ``path``.

    Sharded loads additionally set ``sharded``/``n_shards``/``n_hosts``
    (the *saving* topology), ``resharded`` (saved topology differs from
    the loader's, when the loader passed its own via ``context=``) and
    ``shards_read`` (shard files actually opened — under ``restrict=``
    non-overlapping shard files are skipped entirely).

    ``dtypes`` maps each array to its manifest dtype string; a bf16
    array is held as its 16-bit patterns (``V2``) and :meth:`tensor`
    gives it back as ``torch.bfloat16``."""

    def __init__(self, step, arrays, blobs, meta, path, dtypes=None):
        self.step = step
        self.arrays = arrays
        self.blobs = blobs
        self.meta = meta
        self.path = path
        self.dtypes = dict(dtypes or {})
        self.sharded = False
        self.n_shards = 1
        self.n_hosts = 1
        self.resharded = None
        self.shards_read = 0

    def tensor(self, name):
        """Array ``name`` as a CPU torch tensor (a copy; bf16 restored)."""
        return host_to_tensor(self.arrays[name], self.dtypes.get(name))

    def __repr__(self):
        return ("Checkpoint(step=%d, arrays=%d, blobs=%d, path=%r)"
                % (self.step, len(self.arrays), len(self.blobs), self.path))


class CheckpointManager:
    """Atomic, digest-verified, optionally-async checkpoint store.

    Layout under ``directory`` (one pair per step)::

        {prefix}-{step:08d}.npz    # arrays + blobs (written first)
        {prefix}-{step:08d}.json   # manifest (written last = commit mark)

    The manifest carries per-array SHA-256 digests, shapes/dtypes, blob
    digests, wall-clock time, and arbitrary user ``meta``.  ``load()``
    verifies every digest and, when the newest checkpoint fails, warns
    loudly and falls back to the newest intact one.

    ``sharded=True`` (env default ``MXNET_CKPT_SHARDED``) switches to
    the pod-scale layout — every participating process constructs a
    manager over the SAME (shared-filesystem) directory::

        {prefix}-{step:08d}.shards/shard-{host:05d}.npz   # host h's chunks
        {prefix}-{step:08d}.shards/shard-{host:05d}.json  # digest sidecar
        {prefix}-{step:08d}.json                          # global manifest
                                                          # (process 0, LAST)

    Each process writes only chunks it *owns* (its addressable shards,
    deduped so a replicated block is written by the lowest process
    holding it — no full-array host gather ever happens).  The sidecar
    is written after the shard data, so sidecar-present == shard
    durable; the barrier waits for all ``n_processes`` sidecars before
    process 0 assembles + commits the global manifest.  A crash at any
    point before the manifest leaves only invisible debris (swept by
    :meth:`sweep_orphans` / retention).
    """

    def __init__(self, directory, prefix="ckpt", keep_last=None,
                 async_save=None, logger=None, sharded=None,
                 process_index=None, process_count=None,
                 barrier_timeout=None):
        self.directory = os.fspath(directory)
        if not prefix or any(c in prefix for c in "/\\"):
            raise MXNetError("invalid checkpoint prefix %r" % (prefix,))
        self.prefix = prefix
        self.keep_last = (_config.get("MXNET_CHECKPOINT_KEEP")
                          if keep_last is None else int(keep_last))
        if self.keep_last < 1:
            raise MXNetError("keep_last must be >= 1, got %r"
                             % (self.keep_last,))
        self.async_save = (_config.get("MXNET_CHECKPOINT_ASYNC")
                           if async_save is None else bool(async_save))
        self.sharded = (_config.get("MXNET_CKPT_SHARDED")
                        if sharded is None else bool(sharded))
        self._process_index = process_index
        self._process_count = process_count
        self.barrier_timeout = (
            _config.get("MXNET_DIST_BARRIER_TIMEOUT")
            if barrier_timeout is None else float(barrier_timeout))
        self.logger = logger or logging.getLogger(_LOGGER)
        self.preempted = False
        self.preempt_requested = False
        os.makedirs(self.directory, exist_ok=True)
        self._thread = None
        self._pending_error = None
        self._lock = threading.Lock()
        self._prev_handlers = {}
        self._installed = None
        self._hold_depth = 0
        self._held = []             # (signum, frame) deferred by a hold
        self.last_save_s = None     # the newest save's write wall time
        global _STATUS_MANAGER
        _STATUS_MANAGER = weakref.ref(self)

    def _procinfo(self):
        """(process_index, process_count): explicit ctor args win, else
        a live torch.distributed group, else single-process."""
        pidx, pcnt = _process_info()
        if self._process_index is not None:
            pidx = int(self._process_index)
        if self._process_count is not None:
            pcnt = int(self._process_count)
        return pidx, pcnt

    # -- paths -----------------------------------------------------------
    def _base(self, step):
        return os.path.join(self.directory,
                            "%s-%08d" % (self.prefix, int(step)))

    def data_path(self, step):
        return self._base(step) + ".npz"

    def manifest_path(self, step):
        return self._base(step) + ".json"

    def shard_dir(self, step):
        return self._base(step) + ".shards"

    def shard_data_path(self, step, process_index):
        return os.path.join(self.shard_dir(step),
                            "shard-%05d.npz" % int(process_index))

    def shard_sidecar_path(self, step, process_index):
        return os.path.join(self.shard_dir(step),
                            "shard-%05d.json" % int(process_index))

    def preempt_flag_path(self):
        return os.path.join(self.directory,
                            "%s-preempt.flag" % self.prefix)

    def steps(self):
        """Steps with a committed manifest, ascending (no verification)."""
        out = []
        pre = self.prefix + "-"
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for n in names:
            if n.startswith(pre) and n.endswith(".json"):
                stem = n[len(pre):-len(".json")]
                if stem.isdigit():
                    out.append(int(stem))
        return sorted(out)

    def latest_step(self):
        """Newest committed step, or None (manifest presence only — use
        ``load()`` for digest-verified access)."""
        steps = self.steps()
        return steps[-1] if steps else None

    # -- save ------------------------------------------------------------
    def save(self, step, arrays, blobs=None, meta=None, block=None):
        """Checkpoint ``arrays`` (+ optional ``blobs``/``meta``) as
        ``step``.

        Tensors are copied to host *synchronously* (so the caller may
        mutate them immediately after); serialization,
        digesting, fsync and retention run in a background thread when
        async is on.  ``block=True`` forces a synchronous save.  Errors
        from a previous async save re-raise here or at :meth:`wait`.
        """
        step = int(step)
        if block is None:
            block = not self.async_save
        for name in arrays:
            if name.startswith(_BLOB_KEY) or name.startswith(_ARRAY_KEY):
                raise MXNetError("array name %r collides with the "
                                 "checkpoint key namespace" % (name,))
        blobs = dict(blobs or {})
        for name, b in blobs.items():
            if not isinstance(b, (bytes, bytearray)):
                raise MXNetError("blob %r must be bytes, got %s"
                                 % (name, type(b).__name__))
        meta = dict(meta or {})
        pidx, pcnt = self._procinfo()
        if self.sharded:
            # per-chunk snapshot of the ADDRESSABLE shards only — the
            # sharded path must never host-gather a full global array
            chunks, specs = self._snapshot_shards(arrays, pidx, pcnt)
            writer = lambda: self._write_sharded(  # noqa: E731
                step, chunks, specs, blobs, meta, pidx, pcnt)
        else:
            host = {name: _to_host(v) for name, v in arrays.items()}
            writer = lambda: self._write(step, host, blobs, meta)  # noqa: E731
        # one in-flight async save at a time: overlapping saves serialize
        # (the async-overlap contract — order preserved, none dropped)
        self.wait()
        if block:
            t0 = time.perf_counter()
            try:
                with _telemetry.span("CheckpointManager.save",
                                     _telemetry.CHECKPOINT_SAVE_SECONDS,
                                     mode="sync"):
                    writer()
            except BaseException as e:
                self._note_save_event(step, "sync", t0, e, pcnt)
                self._note_goodput_save(step, t0, e)
                raise
            self.last_save_s = time.perf_counter() - t0
            self._note_save_event(step, "sync", t0, None, pcnt)
            self._note_goodput_save(step, t0, None)
            return
        t = threading.Thread(target=self._write_guarded,
                             args=(step, writer, pcnt),
                             name="ckpt-save-%d" % step, daemon=True)
        with self._lock:
            self._thread = t
        _telemetry.CHECKPOINT_QUEUE_DEPTH.inc()
        try:
            t.start()
        except BaseException:
            _telemetry.CHECKPOINT_QUEUE_DEPTH.dec()
            with self._lock:
                self._thread = None
            raise

    def _write_guarded(self, step, writer, pcnt):
        t0 = time.perf_counter()
        try:
            with _telemetry.span("CheckpointManager.save",
                                 _telemetry.CHECKPOINT_SAVE_SECONDS,
                                 mode="async"):
                writer()
            self.last_save_s = time.perf_counter() - t0
            self._note_save_event(step, "async", t0, None, pcnt)
            self._note_goodput_save(step, t0, None)
        except BaseException as e:  # surfaced on wait()/next save
            self._note_save_event(step, "async", t0, e, pcnt)
            self._note_goodput_save(step, t0, e)
            with self._lock:
                self._pending_error = e
        finally:
            _telemetry.CHECKPOINT_QUEUE_DEPTH.dec()

    def _note_goodput_save(self, step, t0, exc):
        """Goodput ledger: one ``ckpt_save`` segment per save — a
        committed one advances the lost-work baseline (no-op without a
        live recorder; never raises into the save path)."""
        gp = sys.modules.get("mxnet_tpu_torch.goodput")
        if gp is not None and gp.active():
            try:
                gp.record_segment("ckpt_save",
                                  time.perf_counter() - t0,
                                  step=int(step),
                                  committed=exc is None)
            except Exception:
                pass

    def _note_save_event(self, step, mode, t0, exc, pcnt=1):
        """One wide event per checkpoint save (events.py; no-op when
        emission is off)."""
        if not _events.enabled():
            return
        _events.emit(
            "checkpoint_save",
            outcome="ok" if exc is None else "error",
            error_kind=type(exc).__name__ if exc is not None else None,
            dur_s=time.perf_counter() - t0, step=step, mode=mode,
            sharded=bool(self.sharded),
            n_shards=int(pcnt) if self.sharded else 1,
            n_hosts=int(pcnt))

    def _write(self, step, host, blobs, meta):
        payload = {_ARRAY_KEY + k: v for k, v in host.items()}
        payload.update({_BLOB_KEY + k: np.frombuffer(bytes(b), np.uint8)
                        for k, b in blobs.items()})
        data_path = self.data_path(step)
        with atomic_writer(data_path) as f:
            np.savez(f, **payload)
        manifest = {
            "format_version": MANIFEST_FORMAT,
            "prefix": self.prefix,
            "step": step,
            "time": time.time(),
            "data_file": os.path.basename(data_path),
            "data_size": os.path.getsize(data_path),
            "arrays": {k: {"sha256": _digest(v),
                           "shape": list(v.shape),
                           "dtype": _dtype_name(v)}
                       for k, v in host.items()},
            "blobs": {k: {"sha256": hashlib.sha256(bytes(b)).hexdigest(),
                          "size": len(b)}
                      for k, b in blobs.items()},
            "meta": meta,
        }
        # the manifest is the commit record: readers ignore any .npz
        # without one, so a crash between the two writes is invisible
        atomic_write(self.manifest_path(step),
                     json.dumps(manifest, indent=1, sort_keys=True,
                                default=str))
        self.logger.info("saved checkpoint step %d -> %s", step, data_path)
        _telemetry.CHECKPOINT_LAST_STEP.set(step)
        _telemetry.CHECKPOINT_LAST_UNIXTIME.set(time.time())
        _telemetry.CHECKPOINT_SHARDS.set(1)
        self._retain()

    # -- sharded save ----------------------------------------------------
    @staticmethod
    def _snapshot_shards(arrays, pidx, pcnt):
        """Host-snapshot only the chunks THIS process owns.

        A chunk is one addressable shard block of a device-sharded
        array; replicated blocks (held by several processes) are owned
        by the lowest process index holding them so every block is
        written exactly once pod-wide.  Host-resident values (numpy,
        NDArray, plain tensors, the random-stream snapshot) are owned
        by process 0.  Returns ``(chunks, specs)`` where chunks
        maps name -> [(bounds, host ndarray)] and specs carries the
        GLOBAL shape/dtype of every array (known on every process).
        """
        chunks, specs = {}, {}
        for name, v in arrays.items():
            if _is_device_sharded(v):
                shape = tuple(int(d) for d in v.shape)
                specs[name] = {"shape": list(shape),
                               "dtype": _dtype_name(np.empty(0, v.dtype))}
                owners = {}
                try:
                    dmap = v.sharding.devices_indices_map(shape)
                except Exception:
                    dmap = {}
                for dev, idx in dmap.items():
                    key = _bounds_key(_index_bounds(idx, shape))
                    p = int(getattr(dev, "process_index", 0))
                    owners[key] = min(owners.get(key, p), p)
                owned, seen = [], set()
                for sh in v.addressable_shards:
                    bounds = _index_bounds(sh.index, shape)
                    key = _bounds_key(bounds)
                    if key in seen:
                        continue
                    seen.add(key)
                    if owners.get(key, 0) != pidx:
                        continue
                    owned.append((bounds, _to_host(sh.data)))
                chunks[name] = owned
            else:
                h = _to_host(v)
                specs[name] = {"shape": list(h.shape),
                               "dtype": _dtype_name(h)}
                chunks[name] = ([(_full_bounds(h.shape), h)]
                                if pidx == 0 else [])
        return chunks, specs

    def _write_sharded(self, step, chunks, specs, blobs, meta, pidx, pcnt):
        """The distributed commit: shard npz -> digest sidecar ->
        barrier on all sidecars -> (process 0 only) global manifest."""
        sdir = self.shard_dir(step)
        os.makedirs(sdir, exist_ok=True)
        payload, table, n = {}, [], 0
        for name in sorted(chunks):
            for bounds, data in chunks[name]:
                key = "chunk:%05d" % n
                n += 1
                payload[key] = data
                table.append({"key": key, "array": name,
                              "bounds": [list(b) for b in bounds],
                              "shape": list(data.shape),
                              "dtype": _dtype_name(data),
                              "sha256": _digest(data)})
        if pidx == 0:
            for bname in sorted(blobs):
                b = bytes(blobs[bname])
                key = "chunk:%05d" % n
                n += 1
                payload[key] = np.frombuffer(b, np.uint8)
                table.append({"key": key, "blob": bname, "size": len(b),
                              "sha256": hashlib.sha256(b).hexdigest()})
        spath = self.shard_data_path(step, pidx)
        with atomic_writer(spath) as f:
            np.savez(f, **payload)
        sidecar = {
            "shard_format": SHARD_FORMAT,
            "step": step,
            "process_index": pidx,
            "n_processes": pcnt,
            "data_file": os.path.basename(spath),
            "data_size": os.path.getsize(spath),
            "chunks": table,
        }
        # sidecar AFTER its npz: sidecar-present == this shard durable
        atomic_write(self.shard_sidecar_path(step, pidx),
                     json.dumps(sidecar, indent=1, sort_keys=True))
        sidecars = self._shard_barrier(step, sdir, pcnt)
        if pidx != 0:
            return
        manifest = {
            "format_version": MANIFEST_FORMAT,
            "sharded": True,
            "prefix": self.prefix,
            "step": step,
            "time": time.time(),
            "n_processes": pcnt,
            "shard_dir": os.path.basename(sdir),
            "shards": sidecars,
            "arrays": dict(specs),
            "meta": meta,
        }
        # global manifest LAST = the pod-wide commit mark
        atomic_write(self.manifest_path(step),
                     json.dumps(manifest, indent=1, sort_keys=True,
                                default=str))
        self.logger.info("committed sharded checkpoint step %d "
                         "(%d shard(s)) -> %s", step, pcnt, sdir)
        _telemetry.CHECKPOINT_LAST_STEP.set(step)
        _telemetry.CHECKPOINT_LAST_UNIXTIME.set(time.time())
        _telemetry.CHECKPOINT_SHARDS.set(pcnt)
        self._retain()

    def _shard_barrier(self, step, sdir, pcnt):
        """Wait until every process's digest sidecar for ``step`` is
        durable; returns {sidecar filename -> parsed sidecar}.  The
        sidecar is written after its shard data, so this doubles as the
        durability barrier the manifest commit requires."""
        deadline = time.monotonic() + max(0.1, float(self.barrier_timeout))
        want = {os.path.basename(self.shard_sidecar_path(step, i)): i
                for i in range(pcnt)}
        while True:
            got, missing = {}, []
            for name in want:
                try:
                    with open(os.path.join(sdir, name)) as f:
                        sc = json.load(f)
                except (OSError, ValueError):
                    missing.append(name)
                    continue
                if sc.get("step") != step:
                    missing.append(name)
                    continue
                got[name] = sc
            if not missing:
                return got
            if time.monotonic() >= deadline:
                raise AtomicWriteError(
                    "sharded save step %d: shard barrier timed out after "
                    "%.1fs waiting for %s (uncommitted debris left in %s "
                    "is invisible to readers)"
                    % (step, self.barrier_timeout, missing, sdir))
            time.sleep(0.02)

    def _retain(self):
        steps = self.steps()
        for s in steps[:-self.keep_last] if len(steps) > self.keep_last \
                else []:
            # manifest first: a half-deleted checkpoint must not look
            # committed
            for p in (self.manifest_path(s), self.data_path(s)):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            shutil.rmtree(self.shard_dir(s), ignore_errors=True)
        # aborted-save debris: shard dirs / atomic-writer temp files for
        # steps with no manifest.  Only steps strictly below the newest
        # COMMITTED step are swept here — every peer finished writing
        # that step's shards before its manifest committed, so nothing
        # below it can still be in flight (sweep_orphans at attach time
        # handles debris above it).
        if steps:
            self._sweep_debris(below=steps[-1], committed=set(steps))

    def orphan_shard_dirs(self):
        """Shard directories whose step has no committed manifest —
        leftovers of an interrupted sharded save."""
        committed = set(self.steps())
        out = []
        pre = self.prefix + "-"
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for n in sorted(names):
            if n.startswith(pre) and n.endswith(".shards"):
                stem = n[len(pre):-len(".shards")]
                if stem.isdigit() and int(stem) not in committed:
                    out.append(os.path.join(self.directory, n))
        return out

    def _sweep_debris(self, below, committed):
        """Remove uncommitted shard dirs and stray ``.tmp`` files whose
        step is < ``below``."""
        pre = self.prefix + "-"
        step_re = re.compile(re.escape(pre) + r"(\d{8})\.")
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 0
        removed = 0
        for n in names:
            m = step_re.match(n)
            if not m or int(m.group(1)) >= below:
                continue
            s = int(m.group(1))
            path = os.path.join(self.directory, n)
            if n.endswith(".shards") and s not in committed:
                shutil.rmtree(path, ignore_errors=True)
                removed += 1
            elif n.endswith(".tmp"):
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    pass
        return removed

    def sweep_orphans(self):
        """Remove ALL aborted-save debris: orphan shard dirs, ``.tmp``
        files from killed atomic writes (top level and inside shard
        dirs), and any stale preemption flag.  Call at attach/startup
        only — never while a peer's save may be in flight."""
        removed = 0
        for p in self.orphan_shard_dirs():
            shutil.rmtree(p, ignore_errors=True)
            removed += 1
        roots = [self.directory]
        roots += [self.shard_dir(s) for s in self.steps()]
        for root in roots:
            try:
                names = os.listdir(root)
            except OSError:
                continue
            for n in names:
                if n.endswith(".tmp"):
                    try:
                        os.unlink(os.path.join(root, n))
                        removed += 1
                    except OSError:
                        pass
        try:
            os.unlink(self.preempt_flag_path())
            removed += 1
        except OSError:
            pass
        self.preempt_requested = False
        if removed:
            self.logger.info("swept %d aborted-save leftover(s) from %s",
                             removed, self.directory)
        return removed

    def wait(self):
        """Barrier: block until the in-flight async save (if any) has
        committed; re-raise its error if it failed."""
        with self._lock:
            t = self._thread
        if t is not None:
            t.join()
            with self._lock:
                if self._thread is t:
                    self._thread = None
        with self._lock:
            err, self._pending_error = self._pending_error, None
        if err is not None:
            raise err

    # -- load ------------------------------------------------------------
    def read_manifest(self, step):
        """Parse + structurally validate the manifest for ``step``
        (no shard/data reads).  Raises CheckpointCorruptError."""
        mpath = self.manifest_path(step)
        try:
            with open(mpath, "r") as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                "checkpoint step %d: unreadable manifest %s (%s)"
                % (step, mpath, e))
        if manifest.get("format_version") != MANIFEST_FORMAT:
            raise CheckpointCorruptError(
                "checkpoint step %d: unsupported manifest format %r"
                % (step, manifest.get("format_version")))
        return manifest

    @staticmethod
    def _resharded_vs(manifest, context):
        """Did the saving topology differ from the loader's?  ``context``
        is the loader's {"mesh_axes": ..., "layout": ...} (or None)."""
        if not context:
            return None
        meta = manifest.get("meta") or {}
        saved_axes = meta.get("mesh_axes")
        if saved_axes is None:
            return None
        want_axes = dict(context.get("mesh_axes") or {})
        return (dict(saved_axes) != want_axes
                or meta.get("layout") != context.get("layout"))

    def _load_one(self, step, verify=True, restrict=None, context=None):
        manifest = self.read_manifest(step)
        if manifest.get("sharded"):
            return self._load_sharded(step, manifest, verify=verify,
                                      restrict=restrict, context=context)
        dpath = self.data_path(step)
        try:
            with np.load(dpath, allow_pickle=False) as f:
                raw = {k: f[k] for k in f.keys()}
        except Exception as e:
            raise CheckpointCorruptError(
                "checkpoint step %d: unreadable data file %s (%s)"
                % (step, dpath, e))
        arrays, blobs = {}, {}
        for k, v in raw.items():
            if k.startswith(_ARRAY_KEY):
                arrays[k[len(_ARRAY_KEY):]] = v
            elif k.startswith(_BLOB_KEY):
                blobs[k[len(_BLOB_KEY):]] = v.tobytes()
        if verify:
            want_a = manifest.get("arrays", {})
            if set(want_a) != set(arrays):
                raise CheckpointCorruptError(
                    "checkpoint step %d: array set mismatch (manifest %d, "
                    "file %d)" % (step, len(want_a), len(arrays)))
            for k, info in want_a.items():
                got = _digest(arrays[k])
                if got != info["sha256"]:
                    raise CheckpointCorruptError(
                        "checkpoint step %d: array %r digest mismatch "
                        "(manifest %s..., file %s...)"
                        % (step, k, info["sha256"][:12], got[:12]))
            want_b = manifest.get("blobs", {})
            if set(want_b) != set(blobs):
                raise CheckpointCorruptError(
                    "checkpoint step %d: blob set mismatch" % step)
            for k, info in want_b.items():
                got = hashlib.sha256(blobs[k]).hexdigest()
                if got != info["sha256"]:
                    raise CheckpointCorruptError(
                        "checkpoint step %d: blob %r digest mismatch"
                        % (step, k))
        ckpt = Checkpoint(step, arrays, blobs, manifest.get("meta", {}),
                          dpath, dtypes={k: info.get("dtype") for k, info
                                         in manifest.get("arrays",
                                                         {}).items()})
        ckpt.resharded = self._resharded_vs(manifest, context)
        return ckpt

    def _load_sharded(self, step, manifest, verify=True, restrict=None,
                      context=None):
        """Assemble host arrays from per-host shard files.

        ``restrict`` maps array name -> list of bounds this host
        actually needs (its addressable blocks under the NEW topology):
        shard files with no overlapping chunk are skipped entirely and
        non-overlapping regions of the returned arrays stay zero —
        elastic restore only ever reads what it will place.  Arrays
        absent from ``restrict`` (or ``restrict=None``) load fully.
        """
        sdir = self.shard_dir(step)
        specs = manifest.get("arrays", {})
        shards = manifest.get("shards", {})
        pcnt = int(manifest.get("n_processes", len(shards)) or 1)
        if len(shards) != pcnt:
            raise CheckpointCorruptError(
                "checkpoint step %d: manifest lists %d shard(s) for %d "
                "process(es)" % (step, len(shards), pcnt))

        def wanted(chunk):
            if restrict is None or "blob" in chunk:
                return True
            need = restrict.get(chunk["array"])
            if need is None:
                return True
            return any(_bounds_overlap(chunk["bounds"], b) for b in need)

        arrays, blobs, seen_volume = {}, {}, {}
        shards_read = 0
        for sname in sorted(shards):
            sc = shards[sname]
            want_chunks = [c for c in sc.get("chunks", []) if wanted(c)]
            if restrict is not None and not want_chunks:
                continue
            spath = os.path.join(sdir, sc["data_file"])
            try:
                with np.load(spath, allow_pickle=False) as f:
                    data = {c["key"]: f[c["key"]] for c in want_chunks}
            except Exception as e:
                raise CheckpointCorruptError(
                    "checkpoint step %d: unreadable shard %s (%s)"
                    % (step, spath, e))
            shards_read += 1
            for c in want_chunks:
                v = data[c["key"]]
                if verify:
                    got = (_digest(v) if "array" in c
                           else hashlib.sha256(v.tobytes()).hexdigest())
                    if got != c["sha256"]:
                        _telemetry.CHECKPOINT_SHARD_DIGEST_FAILURES.inc()
                        raise CheckpointCorruptError(
                            "checkpoint step %d: shard %s chunk %s (%s) "
                            "digest mismatch (manifest %s..., file %s...)"
                            % (step, sname, c["key"],
                               c.get("array", c.get("blob")),
                               c["sha256"][:12], got[:12]))
                if "blob" in c:
                    blobs[c["blob"]] = v.tobytes()
                    continue
                name = c["array"]
                spec = specs.get(name)
                if spec is None:
                    raise CheckpointCorruptError(
                        "checkpoint step %d: shard %s carries unknown "
                        "array %r" % (step, sname, name))
                if name not in arrays:
                    arrays[name] = np.zeros(tuple(spec["shape"]),
                                            dtype=_np_dtype(spec["dtype"]))
                buf = arrays[name]
                idx = _bounds_slices(c["bounds"])
                if buf[idx].shape != v.shape:
                    raise CheckpointCorruptError(
                        "checkpoint step %d: chunk %s bounds %r do not "
                        "fit array %r %r" % (step, c["key"], c["bounds"],
                                             name, buf.shape))
                buf[idx] = v
                seen_volume[name] = (seen_volume.get(name, 0)
                                     + _bounds_volume(c["bounds"]))
        if restrict is None and verify:
            # full-load coverage: chunks are disjoint by the ownership
            # rule, so summed chunk volume must equal the global volume
            for name, spec in specs.items():
                total = int(np.prod(spec["shape"], dtype=np.int64))
                if seen_volume.get(name, 0) != total:
                    raise CheckpointCorruptError(
                        "checkpoint step %d: array %r covered %d/%d "
                        "elements — missing or torn shard(s)"
                        % (step, name, seen_volume.get(name, 0), total))
        ckpt = Checkpoint(step, arrays, blobs, manifest.get("meta", {}),
                          sdir, dtypes={k: s.get("dtype")
                                        for k, s in specs.items()})
        ckpt.sharded = True
        ckpt.n_shards = len(shards)
        ckpt.n_hosts = pcnt
        ckpt.shards_read = shards_read
        ckpt.resharded = self._resharded_vs(manifest, context)
        return ckpt

    def _load_timed(self, step, verify=True, restrict=None, context=None):
        """_load_one + telemetry: load latency on success (the span
        skips failed scopes), a digest-failure count on any
        verification/structure rejection."""
        t0 = time.perf_counter()
        try:
            with _telemetry.span("CheckpointManager.load",
                                 _telemetry.CHECKPOINT_LOAD_SECONDS):
                out = self._load_one(step, verify=verify,
                                     restrict=restrict, context=context)
        except CheckpointCorruptError as e:
            _telemetry.CHECKPOINT_DIGEST_FAILURES.inc()
            self._note_load_event(step, t0, "digest")
            from . import tracing as _tracing

            _tracing.record_crash("digest_failure", e,
                                  extra={"step": step,
                                         "directory": self.directory})
            raise
        except BaseException as e:
            # any other failure (unreadable path, interrupt) still
            # files the load's ONE wide event — saves and loads keep
            # the same one-record-per-unit-of-work contract
            self._note_load_event(step, t0, type(e).__name__)
            raise
        self._note_load_event(step, t0, None, ckpt=out)
        gp = sys.modules.get("mxnet_tpu_torch.goodput")
        if gp is not None and gp.active() and out is not None:
            try:
                gp.record_segment("ckpt_restore",
                                  time.perf_counter() - t0,
                                  step=getattr(out, "step", None))
            except Exception:
                pass
        return out

    @staticmethod
    def _note_load_event(step, t0, error_kind, ckpt=None):
        if not _events.enabled():
            return
        _events.emit(
            "checkpoint_load",
            outcome="ok" if error_kind is None else "error",
            error_kind=error_kind,
            dur_s=time.perf_counter() - t0, step=step,
            sharded=ckpt.sharded if ckpt is not None else None,
            n_shards=ckpt.n_shards if ckpt is not None else None,
            n_hosts=ckpt.n_hosts if ckpt is not None else None,
            resharded=ckpt.resharded if ckpt is not None else None)

    def load(self, step=None, verify=True, fallback=True, restrict=None,
             context=None):
        """Load (and digest-verify) a checkpoint.

        ``step=None`` loads the newest intact checkpoint: corrupt ones
        are skipped with a LOUD warning (``fallback=False`` raises on
        the first corrupt candidate instead).  Returns a
        :class:`Checkpoint`, or None when nothing intact exists.

        ``restrict`` (sharded checkpoints) maps array name -> bounds
        list; only overlapping chunks are read (see
        :meth:`_load_sharded`).  ``context`` is the loader's
        {"mesh_axes", "layout"} — when given, the returned checkpoint's
        ``resharded`` says whether the saved topology differs, and the
        load event carries it.
        """
        self.wait()
        if step is not None:
            return self._load_timed(int(step), verify=verify,
                                    restrict=restrict, context=context)
        candidates = self.steps()
        for s in reversed(candidates):
            try:
                return self._load_timed(s, verify=verify,
                                        restrict=restrict, context=context)
            except CheckpointCorruptError as e:
                if not fallback:
                    raise
                warnings.warn(
                    "CORRUPT CHECKPOINT at step %d: %s — falling back to "
                    "the next newest intact checkpoint" % (s, e),
                    stacklevel=2)
                self.logger.error("corrupt checkpoint skipped: %s", e)
        return None

    # -- preemption ------------------------------------------------------
    def request_coordinated_commit(self, step, gate=1, signum=None):
        """Publish a pod-wide final-commit request (the coordinated
        SIGTERM protocol): an atomic flag file in the shared checkpoint
        directory naming a *target* step a little ahead of the
        signalled host's committed step.  Every host polls the flag at
        its step boundaries and commits a final sharded checkpoint at
        the first boundary >= target — since all hosts advance their
        committed counter by the same per-call stride from the same
        resume point, that boundary is the SAME step on every host, so
        the shard barrier converges."""
        pidx, _ = self._procinfo()
        payload = {"target_step": int(step) + max(1, int(gate)),
                   "from_step": int(step), "host": pidx,
                   "signal": int(signum) if signum is not None else None,
                   "time": time.time()}
        atomic_write(self.preempt_flag_path(),
                     json.dumps(payload, sort_keys=True))
        self.preempt_requested = True
        self.logger.warning(
            "coordinated preemption: host %d requested pod-wide final "
            "commit at step >= %d", pidx, payload["target_step"])
        return payload

    def coordinated_commit_request(self):
        """The pending coordinated-commit request dict, or None.  Cheap
        enough to poll every step (one failed open when no flag)."""
        try:
            with open(self.preempt_flag_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def clear_coordinated_commit(self):
        self.preempt_requested = False
        try:
            os.unlink(self.preempt_flag_path())
        except OSError:
            pass

    @contextlib.contextmanager
    def hold_signals(self):
        """Defer this manager's preemption handlers across a region (a
        train step's dispatch and commit): a signal that arrives inside
        runs its handler when the outermost hold ends.  A process-wide
        ``pthread_sigmask`` of the main thread alone does not hold a
        signal that the kernel hands to another thread (torch keeps
        worker threads), whose C-level handler still wakes the Python
        one in the main thread."""
        self._hold_depth += 1
        try:
            yield
        finally:
            self._hold_depth -= 1
            if not self._hold_depth and self._held:
                held, self._held = self._held, []
                handler = self._installed
                if handler is not None:
                    for signum, frame in held:
                        handler(signum, frame)

    def install_preemption_handler(self, state_fn,
                                   signals=(signal.SIGTERM, signal.SIGINT),
                                   exit_code=None, coordinated=None,
                                   gate=1):
        """Flush a final checkpoint on SIGTERM/SIGINT (preemption).

        ``state_fn() -> (step, arrays, blobs, meta)`` must return a
        consistent snapshot (front-ends publish one atomically after
        each step).  The handler drains any in-flight async save, writes
        the final checkpoint synchronously, sets ``self.preempted`` so
        cooperative training loops can exit, then chains to the previous
        handler; ``exit_code`` forces an immediate ``os._exit`` instead
        (for plain scripts with no loop check).  Main thread only.

        ``coordinated`` (default: on iff sharded with >1 process): the
        handler does NOT save locally — a sharded save needs every
        host's shards, and only one host got the signal.  Instead it
        publishes a :meth:`request_coordinated_commit` flag; every
        host's training loop observes it at a step boundary and commits
        one pod-wide final checkpoint (``ShardedTrainer`` polls via
        ``check_preemption``).  ``gate`` is the number of boundaries of
        headroom the target is placed ahead, bounding dispatch drift
        between hosts.
        """
        if coordinated is None:
            coordinated = self.sharded and self._procinfo()[1] > 1

        def _coordinated_handler(signum, frame):
            if self._hold_depth:
                self._held.append((signum, frame))
                return
            self.logger.warning(
                "signal %d: requesting coordinated pod-wide final "
                "checkpoint", signum)
            try:
                state = state_fn()
                step = int(state[0]) if state is not None else 0
                self.request_coordinated_commit(step, gate=gate,
                                                signum=signum)
            except Exception:
                self.logger.exception("coordinated preemption request "
                                      "failed")
            finally:
                from . import tracing as _tracing

                _tracing.record_crash("preemption",
                                      extra={"signal": int(signum),
                                             "coordinated": True})
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)

        def _handler(signum, frame):
            if self._hold_depth:
                self._held.append((signum, frame))
                return
            self.logger.warning(
                "signal %d: flushing final checkpoint before preemption",
                signum)
            final_step = None
            try:
                try:
                    self.wait()
                except Exception as e:
                    self.logger.error("in-flight save failed during "
                                      "preemption flush: %s", e)
                state = state_fn()
                if state is not None:
                    step, arrays, blobs, meta = state
                    final_step = int(step)
                    meta = dict(meta or {})
                    meta.setdefault("preempted", True)
                    self.save(step, arrays, blobs=blobs, meta=meta,
                              block=True)
            except Exception:
                # a failed flush must not throw into whatever bytecode
                # the signal interrupted — log it; the loop still exits
                # via self.preempted and older checkpoints remain intact
                self.logger.exception("preemption flush failed")
            finally:
                from . import tracing as _tracing

                # the eviction black box: spans + stacks + HBM state at
                # the moment the fleet pulled the plug (no-op when off;
                # record_crash never raises into the handler)
                _tracing.record_crash("preemption",
                                      extra={"signal": int(signum)})
                self.preempted = True
                gp = sys.modules.get("mxnet_tpu_torch.goodput")
                if gp is not None:
                    try:
                        # the SIGTERM exit boundary: the incarnation
                        # ended preempted, not killed — the flushed
                        # final checkpoint means no lost work
                        gp.note_exit("preempt", step=final_step)
                    except Exception:
                        pass
                if exit_code is not None:
                    os._exit(exit_code)
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)

        installed = _coordinated_handler if coordinated else _handler
        self._installed = installed
        for sig in signals:
            self._prev_handlers[sig] = signal.getsignal(sig)
            signal.signal(sig, installed)
        return installed

    def uninstall_preemption_handler(self):
        """Restore the signal handlers replaced by
        :meth:`install_preemption_handler`."""
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers.clear()
        self._installed = None


# ---------------------------------------------------------------------------
# offline sharded-checkpoint validation: no trainer, pure file inspection
# ---------------------------------------------------------------------------

def validate_sharded_checkpoint(directory, step=None, prefix="ckpt"):
    """Validate a committed sharded checkpoint offline.

    Checks manifest schema, every shard file's presence/size, every
    chunk digest, and that the union of chunk bounds covers each
    array's spec'd global shape exactly (no gaps, no overlaps).
    Returns ``(step, problems)`` — an empty ``problems`` list means the
    checkpoint is restorable on any topology.
    """
    mgr = CheckpointManager(directory, prefix=prefix, keep_last=10 ** 9,
                            async_save=False, sharded=True,
                            process_index=0, process_count=1)
    problems = []
    if step is None:
        step = mgr.latest_step()
        if step is None:
            return None, ["no committed checkpoint under %s" % directory]
    step = int(step)
    try:
        manifest = mgr.read_manifest(step)
    except CheckpointCorruptError as e:
        return step, [str(e)]
    if not manifest.get("sharded"):
        return step, ["checkpoint step %d is not sharded (dense manifest)"
                      % step]
    shards = manifest.get("shards", {})
    pcnt = int(manifest.get("n_processes", 0) or 0)
    if len(shards) != pcnt:
        problems.append("manifest lists %d shard(s) for %d process(es)"
                        % (len(shards), pcnt))
    specs = manifest.get("arrays", {})
    covered = {name: np.zeros(tuple(spec["shape"]), dtype=bool)
               for name, spec in specs.items()}
    sdir = mgr.shard_dir(step)
    for sname in sorted(shards):
        sc = shards[sname]
        spath = os.path.join(sdir, sc.get("data_file", sname + ".npz"))
        if not os.path.exists(spath):
            problems.append("missing shard file %s" % spath)
            continue
        size = os.path.getsize(spath)
        if size != sc.get("data_size"):
            problems.append("shard %s size %d != manifest %s (torn?)"
                            % (sname, size, sc.get("data_size")))
        try:
            with np.load(spath, allow_pickle=False) as f:
                data = {k: f[k] for k in f.keys()}
        except Exception as e:
            problems.append("unreadable shard %s (%s)" % (spath, e))
            continue
        for c in sc.get("chunks", []):
            v = data.get(c["key"])
            if v is None:
                problems.append("shard %s: missing chunk %s"
                                % (sname, c["key"]))
                continue
            got = (_digest(v) if "array" in c
                   else hashlib.sha256(v.tobytes()).hexdigest())
            if got != c.get("sha256"):
                problems.append("shard %s chunk %s (%s): digest mismatch"
                                % (sname, c["key"],
                                   c.get("array", c.get("blob"))))
            if "array" not in c:
                continue
            name = c["array"]
            mask = covered.get(name)
            if mask is None:
                problems.append("shard %s chunk %s names unknown array %r"
                                % (sname, c["key"], name))
                continue
            idx = _bounds_slices(c["bounds"])
            try:
                region = mask[idx]
            except IndexError:
                problems.append("chunk %s bounds %r out of range for %r"
                                % (c["key"], c["bounds"], name))
                continue
            if region.shape != tuple(v.shape):
                problems.append("chunk %s bounds %r do not match its "
                                "data shape %r" % (c["key"], c["bounds"],
                                                   tuple(v.shape)))
                continue
            if bool(np.any(region)):
                problems.append("array %r: overlapping chunks at %r"
                                % (name, c["bounds"]))
            mask[idx] = True
    for name, mask in covered.items():
        missing = int(mask.size - np.count_nonzero(mask))
        if missing:
            problems.append("array %r: %d/%d elements uncovered by any "
                            "shard (gap)" % (name, missing, mask.size))
    return step, problems


# ---------------------------------------------------------------------------
# /statusz checkpoint-subsystem enrichment: the most recent manager in
# the process reports its on-disk view (merged over telemetry's
# counter-derived "checkpoint" subsystem dict)
# ---------------------------------------------------------------------------

_STATUS_MANAGER = None


def _checkpoint_statusz():
    m = _STATUS_MANAGER() if _STATUS_MANAGER is not None else None
    if m is None:
        return {}
    out = {"directory": m.directory, "sharded": bool(m.sharded)}
    try:
        last = m.latest_step()
        out["last_committed_step"] = last
        if last is not None:
            out["manifest_age_s"] = round(
                time.time() - os.path.getmtime(m.manifest_path(last)), 3)
            try:
                out["shard_count"] = len(
                    [n for n in os.listdir(m.shard_dir(last))
                     if n.endswith(".npz")])
            except OSError:
                out["shard_count"] = 0
        out["orphan_shard_dirs"] = len(m.orphan_shard_dirs())
        out["preempt_requested"] = m.coordinated_commit_request() is not None
    except Exception:
        pass
    return out


_telemetry.register_status_provider("checkpoint", _checkpoint_statusz)


# ---------------------------------------------------------------------------
# Module-front-end payload helpers (numpy-only: no module import cycle)
# ---------------------------------------------------------------------------

_ARG_PREFIX = "arg:"
_AUX_PREFIX = "aux:"
_OPT_BLOB = "optimizer_states"


def module_payload(epoch, arg_params, aux_params, opt_states=None,
                   meta=None):
    """Build a (step, arrays, blobs, meta) tuple from Module-style param
    dicts (values: NDArray or numpy) for :meth:`CheckpointManager.save`."""
    arrays = {_ARG_PREFIX + k: v for k, v in (arg_params or {}).items()}
    arrays.update({_AUX_PREFIX + k: v
                   for k, v in (aux_params or {}).items()})
    blobs = {}
    if opt_states is not None:
        blobs[_OPT_BLOB] = opt_states
    meta = dict(meta or {})
    meta.setdefault("kind", "module")
    meta["epoch"] = int(epoch)
    return int(epoch), arrays, blobs, meta


def split_module_payload(ckpt):
    """Inverse of :func:`module_payload` over a loaded
    :class:`Checkpoint`: returns (epoch, arg numpy dict, aux numpy dict,
    optimizer-state bytes or None)."""
    arg, aux = {}, {}
    for k, v in ckpt.arrays.items():
        if k.startswith(_ARG_PREFIX):
            arg[k[len(_ARG_PREFIX):]] = v
        elif k.startswith(_AUX_PREFIX):
            aux[k[len(_AUX_PREFIX):]] = v
    epoch = int(ckpt.meta.get("epoch", ckpt.step))
    return epoch, arg, aux, ckpt.blobs.get(_OPT_BLOB)
