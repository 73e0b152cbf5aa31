"""Small-batch inference serving (parity: mxnet_tpu/serving.py).

:class:`Predictor` serves a forward function over committed parameters
on one device (by default the card), streaming outputs in submission
order.  Where the JAX package fuses ``chain`` microbatches into one
compiled program, this one runs them eagerly:

* **Parameters** are committed to the device once at construction, cast
  once to the dtype policy's per-parameter compute dtypes (the JAX
  package casts inside every compiled call, which gives the same
  values).
* **Uploads** stream ahead of compute: each incoming batch is pinned and
  copied with ``non_blocking=True`` on the replica's own side stream,
  fenced by an event that the compute stream waits on before the
  forward reads it (``io/prefetch.py``'s ``DevicePrefetcher`` does the
  same).  The host never normalizes: pass :func:`uint8_normalizer` and
  feed raw uint8 batches, a quarter of f32's bytes.
* **Dispatch**: one call of ``_jit_chain`` runs a chunk's ``chain``
  forwards back to back under ``torch.inference_mode()``; the chunk's
  outputs come back to the host in one pinned, non-blocking copy,
  fenced by an event, and are read only after it.  Chunk i's copy is
  read after chunk i+1 has been dispatched, so the card does not wait
  for the host between chunks.  ``_jit_chain`` is the per-replica seam
  the fault helpers (``testing.faults``) wrap.
* **Contract**: a ragged batch (fewer rows) is padded up to the batch
  shape and its output sliced back; a larger batch, another trailing
  shape or another dtype raises.

Observability is the JAX package's: ``SERVING_*`` series, one
``serving.request`` span a request, the error counters with a request
id, and a flight-recorder bundle for a failed stream.  Not ported: the
AOT executable store (``aot=``, ``aot_spec=``, ``MXNET_AOT``), which
raises.
"""
from __future__ import annotations

import logging
import time as _time

import numpy as np
import torch

from . import config as _config
from . import telemetry as _telemetry
from . import tracing as _tracing
from .base import MXNetError, torch_dtype
from .context import Context, current_context

__all__ = ["Predictor", "uint8_normalizer"]

_logger = logging.getLogger("mxnet_tpu_torch.serving")


def _device_put(tensor, device, stream):
    """Copy host ``tensor`` to ``device`` on ``stream`` (None: inline):
    pinned first, so that the ``non_blocking=True`` copy is
    asynchronous.  Returns ``(device tensor, event or None)``.  The
    upload's one I/O edge, retried by :meth:`Predictor._upload_impl` and
    patched by ``testing.faults.transient_device_put_failures``."""
    if device.type != "cuda":
        return tensor.to(device), None
    if tensor.device.type == "cpu" and not tensor.is_pinned():
        tensor = tensor.pin_memory()
    with torch.cuda.stream(stream):
        out = tensor.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def _as_device(device):
    if device is None:
        device = current_context()
    if isinstance(device, Context):
        return device.torch_device
    return torch.device(device)


def _np_dtype(dt):
    """The contract dtype of a dtype, tensor, NDArray or array: a numpy
    dtype (torch.bfloat16 stays itself: numpy has none)."""
    if not isinstance(dt, (type, str, np.dtype, torch.dtype)):
        dt = dt.dtype
    if isinstance(dt, torch.dtype):
        return dt if dt == torch.bfloat16 else np.dtype(str(dt)[6:])
    return np.dtype(dt)


_NORM_CACHE = {}


def uint8_normalizer(mean=(123.68, 116.779, 103.939), std=(58.393, 57.12, 57.375),
                     dtype="bfloat16"):
    """Build a device-side preprocess function: uint8 NCHW tensor ->
    ``(x - mean) / std`` in ``dtype``, computed in f32 on the device the
    batch lies on (the card for a Predictor), so the host ships raw
    bytes only.  The mean and std tensors are made once a device."""
    out_dtype = torch_dtype(dtype)

    def prep(x):
        c = x.shape[1]
        key = (x.device, c, tuple(mean[:c]), tuple(std[:c]))
        ms = _NORM_CACHE.get(key)
        if ms is None:
            ms = (torch.tensor(mean[:c], dtype=torch.float32,
                               device=x.device).reshape(1, c, 1, 1),
                  torch.tensor(std[:c], dtype=torch.float32,
                               device=x.device).reshape(1, c, 1, 1))
            _NORM_CACHE[key] = ms
        m, s = ms
        return ((x.to(torch.float32) - m) / s).to(out_dtype)

    return prep


def _commit(tree, device, cast, names=None):
    """Every tensor of ``tree`` (a tensor, NDArray or array; a dict of
    them by name; a list or tuple, named by ``names`` when it has one a
    leaf) copied to ``device`` once and cast by ``cast(name, tensor)``
    (name None for an unnamed leaf)."""
    from .ndarray.ndarray import NDArray

    def one(name, a):
        if isinstance(a, NDArray):
            a = a._data
        elif not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return cast(name, a.detach().to(device, copy=True))

    if isinstance(tree, dict):
        return {n: one(n, a) for n, a in tree.items()}
    if isinstance(tree, (list, tuple)):
        if names is None or len(names) != len(tree):
            names = [None] * len(tree)
        return tuple(one(n, a) for n, a in zip(names, tree))
    return one(None, tree)


class Predictor:
    """Streaming predictor over ``forward(x, params) -> out`` on one
    device, ``x`` one batch (a tensor on the device).  ``predict`` yields
    one host output (numpy) per input batch, in order.  ``preprocess``
    (a function on tensors) runs on the device on each batch before
    ``forward``; ``postprocess`` (a function on tensors returning one
    tensor with a leading batch dim, e.g. ``torch.topk(logits,
    5).indices``) after it, so only its result comes back to the host.
    """

    def __init__(self, forward, params, chain=8, preprocess=None,
                 postprocess=None, batch_shape=None, batch_dtype=None,
                 device=None, aot=None, aot_spec=None, dtype_policy=None,
                 param_names=None):
        from . import dtype_policy as _dtp

        if aot is not None or aot_spec is not None or \
                _config.get("MXNET_AOT"):
            raise MXNetError("Predictor(aot=...): the AOT executable store "
                             "is not ported yet; leave aot, aot_spec and "
                             "MXNET_AOT unset")
        if chain < 1:
            raise MXNetError("chain must be >= 1, got %r" % (chain,))
        self._chain = int(chain)
        dt_policy = _dtp.resolve_policy(dtype_policy)
        self._dtype_policy = dt_policy
        self._param_names = list(param_names) if param_names else None
        _dtp.note_policy(dt_policy, "predictor")

        def cast(name, a):
            if dt_policy is None or not a.is_floating_point():
                return a
            if name is None:   # anonymous leaf: the compute dtype
                return a.to(dt_policy.compute_dtype)
            return dt_policy.cast_compute(name, a)

        self._dev = _as_device(device)
        with torch.no_grad():
            self._params = _commit(params, self._dev, cast,
                                   self._param_names)
        # the replica's own upload stream: replicas on one card never
        # serialize their copies behind each other's
        self._stream = torch.cuda.Stream(self._dev) \
            if self._dev.type == "cuda" else None

        def one(x, params_):
            if preprocess is not None:
                x = preprocess(x)
            with _dtp.scope(dt_policy):
                out = forward(x, params_)
            if dt_policy is not None:
                out = dt_policy.cast_output(out)
            if postprocess is not None:
                out = postprocess(out)
            return out

        def chained(xs, params_):
            return [one(x, params_) for x in xs]

        self._one = one
        self._jit_chain = chained
        self._batch_shape = tuple(batch_shape) if batch_shape else None
        self._batch_dtype = _np_dtype(batch_dtype) \
            if batch_dtype is not None else None

    @property
    def chain(self):
        """Microbatches run per dispatch."""
        return self._chain

    @property
    def batch_shape(self):
        """The per-batch shape contract (None until pinned)."""
        return self._batch_shape

    @property
    def batch_dtype(self):
        """The batch dtype contract (None until pinned)."""
        return self._batch_dtype

    @property
    def device(self):
        """The torch device this replica's parameters are committed to."""
        return self._dev

    def prewarm(self):
        """The JAX package compiles (or loads) its executables here; with
        no AOT store this returns its ``disabled`` info, as the JAX one
        does without one.  Needs a pinned batch contract."""
        if self._batch_shape is None or self._batch_dtype is None:
            raise MXNetError(
                "Predictor.prewarm() needs a pinned batch contract "
                "(pass batch_shape=/batch_dtype= or build via "
                "from_block)")
        return [{"label": "predictor", "status": "disabled"}]

    @classmethod
    def from_block(cls, net, example_input, chain=8, preprocess=None,
                   postprocess=None, device=None, aot=None,
                   aot_spec=None, dtype_policy=None):
        """Build from a gluon block: its forward with training off and
        the committed parameters swapped in (``block.swapped_params``);
        a block the caller hybridized runs through its ``CachedOp`` on
        them.  With ``preprocess``, ``example_input`` is the raw batch
        (e.g. uint8).  Returns ``(predictor, example tensor)``."""
        from . import autograd
        from . import dtype_policy as _dtp
        from .gluon import block as block_mod
        from .gluon.parameter import DeferredInitializationError
        from .ndarray.ndarray import NDArray

        if isinstance(example_input, NDArray):
            x = example_input._data
        elif isinstance(example_input, torch.Tensor):
            x = example_input
        else:
            x = torch.as_tensor(np.asarray(example_input))
        params = list(net.collect_params().values())
        try:
            param_arrays = tuple(p.data()._data for p in params)
        except DeferredInitializationError:
            # finish deferred parameter init: one probe row where the
            # parameters live, under the policy (a bf16 preprocess feeds
            # the f32 parameters it harmonizes to)
            ctxs = params[0].list_ctx()
            probe = x[:1].to(ctxs[0].torch_device)
            if preprocess is not None:
                probe = preprocess(probe)
            with autograd.pause(), \
                    _dtp.scope(_dtp.resolve_policy(dtype_policy)):
                block_mod._abstract_eval_forward(net, [NDArray(probe)])
            param_arrays = tuple(p.data()._data for p in params)
        hybridized = getattr(net, "_active", False)

        def forward(x_, arrays):
            if hybridized:
                return _cached_forward(net, x_, arrays)
            with block_mod.swapped_params(params, arrays, training=False):
                out = net(NDArray(x_))
            return out._data

        pred = cls(forward, param_arrays, chain=chain,
                   preprocess=preprocess, postprocess=postprocess,
                   batch_shape=tuple(x.shape), batch_dtype=_np_dtype(x),
                   device=device, aot=aot, aot_spec=aot_spec,
                   dtype_policy=dtype_policy,
                   param_names=[p.name for p in params])
        return pred, x

    @classmethod
    def from_symbol(cls, sym, arg_params, aux_params=None,
                    data_name="data", chain=8, preprocess=None,
                    postprocess=None, batch_shape=None, batch_dtype=None,
                    device=None, aot=None, aot_spec=None,
                    dtype_policy=None, aot_policy_tag=None):
        """Build from a symbolic model: the graph's function
        (``Symbol._build_fn``) over named tensors, parameters committed
        once.  The serving entry point of the int8 artifacts that
        ``tools.quantize_model`` emits (``contrib.quantization.
        load_artifact``); ``data_name`` is the one variable fed per
        batch.  With ``aot_policy_tag`` (the artifact's graph-level
        precision) and no ``dtype_policy``, the cast policy is pinned
        off, so an ambient ``MXNET_DTYPE_POLICY`` cannot re-cast a gated
        artifact's range scalars or its f32 layers."""
        from .ndarray.ndarray import NDArray

        if aot_policy_tag is not None and dtype_policy is None:
            dtype_policy = "f32"
        fn, _, _ = sym._build_fn()
        params = {}
        for src in (arg_params or {}), (aux_params or {}):
            for n, a in src.items():
                if n != data_name:
                    params[n] = a._data if isinstance(a, NDArray) else a

        def forward(x, params_):
            values = dict(params_)
            values[data_name] = x
            outs, _aux = fn(values, is_train=False, device=x.device)
            return outs[0]

        return cls(forward, params, chain=chain, preprocess=preprocess,
                   postprocess=postprocess, batch_shape=batch_shape,
                   batch_dtype=batch_dtype, device=device, aot=aot,
                   aot_spec=aot_spec, dtype_policy=dtype_policy)

    # -- upload -------------------------------------------------------------

    def _upload(self, b, request_id=None):
        """Asynchronous host-to-device copy of one raw batch, padded up to
        the batch shape: ``(device tensor, valid rows, event or None)``."""
        try:
            return self._upload_impl(b)
        except (TypeError, ValueError) as e:
            # batch-contract violations (shape/dtype) — caller bug
            self._count_error("contract", request_id, e)
            raise
        except Exception as e:
            # retry-exhausted host->device transfer and anything else
            self._count_error("transfer", request_id, e)
            raise

    # per-request error series are bounded: past this many distinct ids
    # the overflow bucket absorbs the rest
    _MAX_ERROR_ID_SERIES = 128

    @classmethod
    def _count_error(cls, kind, request_id, exc):
        """Failure bookkeeping with a greppable request id: the request's
        root span id when tracing is on, else minted here."""
        rid = request_id or _tracing.new_request_id()
        _telemetry.SERVING_ERRORS.inc(kind=kind)
        label = rid if len(_telemetry.SERVING_REQUEST_ERRORS._series) \
            < cls._MAX_ERROR_ID_SERIES else "overflow"
        _telemetry.SERVING_REQUEST_ERRORS.inc(kind=kind, request_id=label)
        _logger.error("serving request %s failed (%s): %s", rid, kind, exc)

    def _upload_impl(self, b):
        from .checkpoint import retry
        from .ndarray.ndarray import NDArray

        if isinstance(b, NDArray):
            b = b._data
        if not isinstance(b, (np.ndarray, torch.Tensor)):
            b = np.asarray(b)
        dtype = _np_dtype(b)
        if self._batch_shape is None:
            # the first observed batch fixes the contract; warn only when
            # the dtype is unpinned too (a fully implicit contract)
            if self._batch_dtype is None:
                import warnings

                warnings.warn(
                    "Predictor batch contract implicitly set to %s/%s by "
                    "the first request; larger batches will be rejected — "
                    "pass batch_shape=/batch_dtype= to pin it explicitly"
                    % (tuple(b.shape), dtype), stacklevel=4)
            self._batch_shape = tuple(b.shape)
        if self._batch_dtype is None:
            self._batch_dtype = dtype
        if dtype != self._batch_dtype:
            raise TypeError("batch dtype %s != compiled dtype %s"
                            % (dtype, self._batch_dtype))
        n_valid = b.shape[0]
        if tuple(b.shape) != self._batch_shape:
            if tuple(b.shape[1:]) != self._batch_shape[1:] or \
                    n_valid > self._batch_shape[0]:
                raise ValueError(
                    "batch shape %s incompatible with compiled shape %s: "
                    "only the leading (batch) dim may shrink"
                    % (tuple(b.shape), self._batch_shape))
        rows = self._batch_shape[0]
        if isinstance(b, torch.Tensor) and b.device == self._dev:
            # device-resident: no host round trip; pad on the device
            if n_valid < rows:
                b = torch.cat([b, b.new_zeros((rows - n_valid,)
                                              + tuple(b.shape[1:]))])
            return b, n_valid, None
        if isinstance(b, torch.Tensor):
            b = b.detach().cpu()
        else:
            b = torch.from_numpy(np.ascontiguousarray(b))
        if n_valid < rows:
            b = torch.cat([b, b.new_zeros((rows - n_valid,)
                                          + tuple(b.shape[1:]))])
        # retry transient transfer failures (a transient OOM while an old
        # chunk drains) with backoff instead of dropping the request;
        # contract violations raised above and are never retried
        put = retry(_device_put, retries=2, backoff=0.05,
                    exceptions=(OSError, RuntimeError))
        out, event = put(b, self._dev, self._stream)
        return out, n_valid, event

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self, items):
        """Run one chunk: the compute stream waits on each upload's event,
        ``_jit_chain`` runs the chunk's forwards, and the stacked outputs
        start their copy to pinned host memory.  Returns ``(host tensor,
        event or None)``; the host tensor is read after the event."""
        arrs = []
        cuda = self._dev.type == "cuda"
        stream = torch.cuda.current_stream(self._dev) if cuda else None
        for arr, _n, event in items:
            if event is not None:
                stream.wait_event(event)
                # the allocator keeps the upload's memory until the
                # compute stream is done with it
                arr.record_stream(stream)
            arrs.append(arr)
        with torch.inference_mode():
            outs = self._jit_chain(tuple(arrs), self._params)
            out = torch.stack(list(outs))
            if out.dtype == torch.bfloat16:   # numpy has no bf16
                out = out.to(torch.float32)
            if not cuda:
                return out, None
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return host, done

    def predict(self, batches):
        """Yield one output (numpy) per input batch, in order.

        Uploads stream ahead of compute; chunks of ``chain`` batches run
        as single dispatches; chunk i's outputs are read after chunk i+1
        has been dispatched."""
        chunk = []            # [(device tensor, n_valid, event, t, span)]
        pending = None        # (host out, event, [(n, t, span)..])
        tel = _telemetry.enabled()
        tr_on = _tracing.enabled()
        outstanding = [0]     # uploads not yet drained (gauge bookkeeping)
        live_spans = []       # request spans not yet closed

        def dispatch(items):
            host, done = self._dispatch([(a, n, e) for a, n, e, _t, _s
                                         in items])
            return host, done, [(n, t, s) for _a, n, _e, t, s in items]

        def drain(p):
            out, done, valid = p
            if done is not None:
                done.synchronize()
            host = out.numpy()
            bs = self._batch_shape[0]
            pos = 0
            try:
                for i, (n, t0, sp) in enumerate(valid):
                    # finalize BEFORE the yield: a consumer that breaks
                    # mid-chunk must not strand this request's gauge/span
                    pos = i + 1
                    if t0 is not None:
                        # latency = upload submission -> output on host
                        _telemetry.SERVING_REQUEST_SECONDS.observe(
                            _time.perf_counter() - t0,
                            exemplar={"trace_id": _tracing.TRACE_ID,
                                      "span_id": sp.span_id}
                            if sp is not None else None)
                        _telemetry.SERVING_IN_FLIGHT.dec()
                        outstanding[0] -= 1
                    if sp is not None:
                        sp.set(rows=n).end()
                        live_spans.remove(sp)
                    yield host[i] if n == bs else host[i, :n]
            finally:
                # abandoned mid-drain: close the rest of the chunk's
                # requests here (error: the client went away)
                for n, t0, sp in valid[pos:]:
                    if t0 is not None:
                        _telemetry.SERVING_IN_FLIGHT.dec()
                        outstanding[0] -= 1
                    if sp is not None:
                        sp.set(rows=n, abandoned=True).end(error=True)
                        live_spans.remove(sp)

        try:
            for b in batches:
                t0 = _time.perf_counter() if tel else None
                # one detached root span per request; its span_id is the
                # request id the error paths log and label
                sp = _tracing.begin("serving.request", activate=False) \
                    if tr_on else None
                if sp is not None:
                    live_spans.append(sp)
                try:
                    with torch.inference_mode():
                        arr, n_valid, event = self._upload(
                            b, sp.span_id if sp is not None else None)
                except BaseException:
                    if sp is not None:
                        sp.end(error=True)
                        live_spans.remove(sp)
                    raise
                if tel:
                    _telemetry.SERVING_REQUESTS.inc()
                    _telemetry.SERVING_BATCH_SIZE.observe(n_valid)
                    _telemetry.SERVING_IN_FLIGHT.inc()
                    outstanding[0] += 1
                chunk.append((arr, n_valid, event, t0, sp))
                if len(chunk) == self._chain:
                    out_n = dispatch(chunk)
                    chunk = []
                    if pending is not None:
                        yield from drain(pending)
                    pending = out_n
            if chunk:
                out_n = dispatch(chunk)
                if pending is not None:
                    yield from drain(pending)
                pending = out_n
            if pending is not None:
                yield from drain(pending)
        except Exception as e:
            # black-box bundle for a failed request stream (no-op unless
            # the flight recorder is armed)
            _tracing.record_crash("exception-serving", e,
                                  extra={"layer": "serving.Predictor"})
            raise
        finally:
            # a stream abandoned early or killed by a contract error must
            # not leave phantom requests on the in-flight gauge, nor open
            # spans
            if outstanding[0]:
                _telemetry.SERVING_IN_FLIGHT.dec(outstanding[0])
                outstanding[0] = 0
            for sp in live_spans:
                sp.end(error=True)


def _cached_forward(net, x, arrays):
    """A hybridized block's compiled forward (its ``CachedOp``) on the
    committed parameter tensors ``arrays`` instead of its own, in
    predict mode."""
    from . import autograd
    from . import dtype_policy as _dtp
    from . import fusion_cost as _fc
    from .gluon.block import CachedOp, swapped_params
    from .ndarray.ndarray import NDArray
    from . import jit as _jit

    if net._cached_op is None:
        net._cached_op = CachedOp(net, **net._flags)
    op = net._cached_op
    arrays = list(arrays)
    prev = autograd.set_training(False)
    try:
        key = (False, False, _jit.signature([x]), _jit.signature(arrays))
        if key not in op._meta:
            plan = _fc.resolve_fusion(op._fusion)
            with _fc.scope(plan), swapped_params(op._params, arrays):
                op._meta[key] = op._probe([NDArray(x)]) + (plan,)
        _tmpl, _aux, plan = op._meta[key]
        with torch.set_grad_enabled(False), _dtp.scope(op._policy), \
                _fc.scope(plan):
            outs, _ = op._compiled(key, [x], arrays)
    finally:
        autograd.set_training(prev)
    return outs[0]
