"""Training step of one card (counterpart of mxnet_tpu/parallel/train.py).

``ShardedTrainer`` runs forward, backward and the optimizer update of a
gluon block in one call, on the device that holds the block's
parameters (``gpu(0)`` unless the caller initialised the net on
``mx.cpu()``).  The JAX package traces this into one XLA program; here
it runs eagerly through torch, with the same semantics:

- the parameters live in the trainer as one flat master buffer per
  dtype (trainable and not kept apart), each parameter a view of it, so
  that the optimizer update, the non-finite guard's select and the
  moving-stat write-back run over all parameters at once;
- the forward swaps each parameter's compute tensor into the block
  (cast per the dtype policy's rules, resolved once), under the policy's
  scope (compute follows the weight) and with BatchNorm handing its new
  moving stats to an aux sink instead of rebinding them;
- gradients come from ``torch.autograd.grad`` over the flat buffers:
  nothing accumulates in ``.grad`` between steps;
- under loss scaling the scaled loss drives the backward pass, the
  gradients are unscaled, and ``keep`` = finite loss and finite
  gradients; the guard then selects the previous params, optimizer
  state and moving stats wherever ``keep`` is false;
- each step's forward, backward and update run under
  ``torch.profiler.record_function`` ranges of those names;
- a device-resident 6-slot metric accumulator is read on the host only
  at flush boundaries, by the caller's thread (sync) or by a background
  thread that copies it after a CUDA event (``async_metrics``): no
  ``.item()``, ``float()`` or ``.cpu()`` of a device tensor lies on the
  dispatch path.

``step_many`` runs ``steps_per_call`` steps in one call through the same
step code, so it is bit for bit equal to as many ``step`` calls where the
kernels are deterministic (the CPU; cuDNN's default backward algorithms
on the card need not be).  The mesh, layouts, rematerialisation, fusion,
AOT and checkpoint arguments of the JAX trainer are not ported yet.
"""
from __future__ import annotations

import queue as _queue
import threading as _threading
import time as _time

import torch

from ..base import MXNetError, torch_dtype
from ..ndarray.ndarray import NDArray
from .. import autograd
from .. import config as _config
from .. import dtype_policy as _dtp
from ..checkpoint import check_finite, nonfinite_policy
from ..gluon import block as _block_mod
from ..gluon.parameter import DeferredInitializationError

__all__ = ["ShardedTrainer", "sgd_init", "adam_init"]


# device-resident metric accumulator, read on the host only at flush
# boundaries.  Layout:
#   [0] sum of FINITE losses   [1] steps accumulated
#   [2] non-finite loss count  [3] loss of the newest step (raw)
#   [4] current loss scale     [5] loss-scale backoffs (overflow skips)
_M_LOSS_SUM, _M_STEPS, _M_NONFINITE, _M_LAST, _M_LS_SCALE, \
    _M_LS_BACKOFF = range(6)
_METRICS_WIDTH = 6
_POLL_S = 0.0005
# named ranges of a step for torch.profiler (forward, backward, update):
# the split of the step's device and host time is read from them
_range = torch.profiler.record_function


class _MetricFetcher:
    """Bounded background device->host metric pull.

    ``submit`` enqueues a non-blocking copy of the accumulator into
    pinned host memory and records a CUDA event after it; the thread
    waits for the event (polling ``query``, which never blocks the
    device queue) and applies the values, so the dispatch thread never
    waits on the device.  The queue bound is backpressure: once
    ``depth`` flushes are in flight the next submit blocks until the card
    catches up."""

    def __init__(self, apply_fn, depth=2):
        self._apply = apply_fn
        self.error = None  # first fetch/apply failure (drain re-raises)
        self._q = _queue.Queue(maxsize=max(1, int(depth)))
        self._thread = _threading.Thread(
            target=self._run, name="mxnet_tpu_torch-metric-fetch",
            daemon=True)
        self._thread.start()

    def submit(self, step, n_steps, acc):
        if acc.is_cuda:
            host = torch.empty(acc.shape, dtype=acc.dtype, pin_memory=True)
            host.copy_(acc, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = acc, None
        self._q.put((step, n_steps, host, ready))

    def wait(self):
        """Block until every submitted fetch has completed AND been
        applied (the drain barrier)."""
        self._q.join()

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5.0)

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, n_steps, host, ready = item
                try:
                    if ready is not None:
                        while not ready.query():
                            _time.sleep(_POLL_S)
                    self._apply(step, n_steps, host.numpy().copy(),
                                async_mode=True)
                except Exception as e:
                    # a poisoned fetch must not kill the thread: wait()
                    # would deadlock with no consumer left.  The first
                    # error is kept for the next drain boundary.
                    if self.error is None:
                        self.error = e
            finally:
                self._q.task_done()


# ---- optimizers over lists of tensors (all parameters at once) ---------

def sgd_init(params, momentum=0.0):
    if momentum == 0.0:
        return {"mom": None}
    return {"mom": [torch.zeros_like(p) for p in params]}


def _sgd_update(params, grads, state, lr, momentum, wd):
    """``g += wd * p; m = momentum * m - lr * g; p += m``, out of place."""
    if wd:
        grads = torch._foreach_add(grads, params, alpha=wd)
    if state["mom"] is None:
        return list(torch._foreach_add(params, grads, alpha=-lr)), \
            {"mom": None}
    mom = list(torch._foreach_mul(state["mom"], momentum))
    torch._foreach_add_(mom, grads, alpha=-lr)
    return list(torch._foreach_add(params, mom)), {"mom": mom}


def adam_init(params, **kw):
    device = params[0].device if params else None
    return {"m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params],
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def _adam_update(params, grads, state, lr, beta1, beta2, eps, wd):
    """Adam with the bias correction folded into the step size:
    ``p -= lr * sqrt(1 - beta2^t) / (1 - beta1^t) * m / (sqrt(v) + eps)``,
    out of place; ``t`` stays on the device."""
    t = state["t"] + 1
    corr = torch.sqrt(1 - torch.pow(beta2, t)) / (1 - torch.pow(beta1, t))
    if wd:
        grads = torch._foreach_add(grads, params, alpha=wd)
    m = list(torch._foreach_mul(state["m"], beta1))
    torch._foreach_add_(m, grads, alpha=1 - beta1)
    v = list(torch._foreach_mul(state["v"], beta2))
    torch._foreach_addcmul_(v, grads, grads, value=1 - beta2)
    denom = torch._foreach_sqrt(v)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_mul(m, lr * corr)
    torch._foreach_div_(upd, denom)
    return list(torch._foreach_sub(params, upd)), {"m": m, "v": v, "t": t}


def _select(keep, new, old):
    """``new`` where ``keep`` else ``old``, over matching dicts/lists of
    tensors (the guard's select)."""
    if isinstance(new, dict):
        return {k: _select(keep, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return [torch.where(keep, n, o) for n, o in zip(new, old)]
    if new is None:
        return None
    return torch.where(keep, new, old)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return [] if tree is None else [tree]


class _Flat:
    """A list of tensors stored as one flat buffer per dtype, each tensor
    a view of its buffer."""

    def __init__(self, tensors):
        self.shapes = [tuple(t.shape) for t in tensors]
        dtypes = sorted({t.dtype for t in tensors}, key=str)
        self.groups = [[i for i, t in enumerate(tensors) if t.dtype == dt]
                       for dt in dtypes]
        self.sizes = [[tensors[i].numel() for i in g] for g in self.groups]

    def pack(self, tensors):
        return [torch.cat([tensors[i].reshape(-1) for i in g])
                for g in self.groups]

    def unpack(self, bufs):
        out = [None] * len(self.shapes)
        for g, sizes, buf in zip(self.groups, self.sizes, bufs):
            for i, v in zip(g, torch.split(buf, sizes)):
                out[i] = v.view(self.shapes[i])
        return out


_UNPORTED_DEFAULTS = (("mesh", None), ("batch_axis_spec", None),
                      ("param_spec_fn", None), ("donate", True),
                      ("remat_policy", None), ("fusion", None),
                      ("aot", None), ("aot_spec", None), ("layout", None),
                      ("distributed", "auto"))


class ShardedTrainer:
    """Compile-free train step of one card (see the module doc).

    Parameters
    ----------
    net : gluon.HybridBlock, initialized (shapes may still be deferred:
        they are inferred from the first batch)
    loss_fn : callable(outputs NDArray, label NDArray) -> NDArray
    optimizer : 'sgd' | 'adam'
    optimizer_params : learning_rate, wd, momentum (sgd), beta1, beta2,
        epsilon (adam)
    dtype : legacy blanket compute cast of parameters and inputs; cannot
        be combined with ``dtype_policy``
    on_nonfinite : 'off' | 'warn' | 'skip' | 'raise' (None = the
        ``MXNET_NONFINITE_POLICY`` default).  'skip' discards the whole
        update of a step whose loss is not finite.
    dtype_policy : a registered policy name or a DtypePolicy (None = the
        ``MXNET_DTYPE_POLICY`` default; '' / 'f32' = f32)
    async_metrics : non-blocking dispatch (None = ``MXNET_ASYNC_METRICS``):
        losses and skip counts are read on a background thread, one flush
        late; under 'raise' the error surfaces at the next ``step`` or
        ``drain``.
    steps_per_call : K for :meth:`step_many` (None = ``MXNET_STEPS_PER_CALL``)
    metrics_every : flush the metric accumulator every N steps (default:
        once per call)
    fetch_depth : bound on in-flight background fetches (default 2)

    ``mesh``, ``batch_axis_spec``, ``param_spec_fn``, ``donate``,
    ``remat_policy``, ``fusion``, ``aot``, ``aot_spec``, ``layout`` and
    ``distributed`` take the JAX trainer's defaults only; anything else
    raises ``MXNetError``.
    """

    def __init__(self, net, loss_fn, mesh=None, optimizer="sgd",
                 optimizer_params=None, batch_axis_spec=None,
                 param_spec_fn=None, dtype=None, donate=True,
                 remat_policy=None, fusion=None, on_nonfinite=None,
                 aot=None, aot_spec=None, layout=None,
                 async_metrics=None, steps_per_call=None,
                 metrics_every=None, fetch_depth=2, dtype_policy=None,
                 distributed="auto"):
        given = dict(mesh=mesh, batch_axis_spec=batch_axis_spec,
                     param_spec_fn=param_spec_fn, donate=donate,
                     remat_policy=remat_policy, fusion=fusion, aot=aot,
                     aot_spec=aot_spec, layout=layout,
                     distributed=distributed)
        for name, default in _UNPORTED_DEFAULTS:
            value = given[name]
            if value != default:
                raise MXNetError("ShardedTrainer(%s=%r) is not ported yet"
                                 % (name, value))
        self.net = net
        self.loss_fn = loss_fn
        self._on_nonfinite = nonfinite_policy(on_nonfinite)
        self._dtype_policy = _dtp.resolve_policy(dtype_policy)
        if self._dtype_policy is not None and dtype is not None:
            raise MXNetError(
                "pass dtype= (legacy blanket compute cast) or "
                "dtype_policy=, not both")
        self._ls_cfg = _dtp.LossScaleConfig() \
            if (self._dtype_policy is not None
                and self._dtype_policy.loss_scaling) else None
        self._ls_active = self._ls_cfg is not None
        # loss scaling reuses the non-finite select: an overflowed scaled
        # step is always discarded, whatever the host-side policy says
        self._guard = self._on_nonfinite == "skip" or self._ls_active
        self._async = _config.get("MXNET_ASYNC_METRICS") \
            if async_metrics is None else bool(async_metrics)
        k = _config.get("MXNET_STEPS_PER_CALL") \
            if steps_per_call is None else int(steps_per_call)
        if k < 1:
            raise MXNetError("steps_per_call must be >= 1; got %d" % k)
        self.steps_per_call = k
        self._metrics_every_explicit = metrics_every is not None
        self._metrics_every = max(1, int(metrics_every)) \
            if metrics_every is not None else k
        self._fetch_depth = max(1, int(fetch_depth))
        self._fetcher = None
        self._pending_exc = None
        self._metrics_acc = None
        self._metrics_pending = 0
        self.global_step = 0
        self.skipped_steps = 0
        self._params = list(net.collect_params().values())
        if not self._params:
            raise MXNetError("ShardedTrainer: the net has no parameters")
        self._device = self._params[0].list_ctx()[0].torch_device
        opts = dict(optimizer_params or {})
        self._lr = float(opts.get("learning_rate", 0.01))
        self._wd = float(opts.get("wd", 0.0))
        self._momentum = float(opts.get("momentum", 0.0))
        self._beta1 = float(opts.get("beta1", 0.9))
        self._beta2 = float(opts.get("beta2", 0.999))
        self._eps = float(opts.get("epsilon", 1e-8))
        if optimizer not in ("sgd", "adam"):
            raise MXNetError("ShardedTrainer supports sgd/adam; got %r"
                             % optimizer)
        self._opt_name = optimizer
        self._dtype = torch_dtype(dtype) if dtype is not None else None
        self._train_bufs = None  # filled by _lazy_init (deferred shapes)
        self._fixed_bufs = None
        self.opt_state = None
        try:
            self._lazy_init()
        except DeferredInitializationError:
            pass  # deferred-shape params: init on the first step

    # -- state -------------------------------------------------------------
    def _lazy_init(self, example_inputs=None):
        if self._train_bufs is not None:
            return
        if example_inputs is not None:
            try:
                for p in self._params:
                    p.data()
            except DeferredInitializationError:
                # finish deferred shapes on the first sample, in predict
                # mode so that no moving stat moves
                with autograd.pause(train_mode=False):
                    self.net(*[NDArray(x[:1]) for x in example_inputs])
        tensors = [p.data()._data.detach() for p in self._params]
        for p, t in zip(self._params, tensors):
            if t.device != self._device:
                raise MXNetError("ShardedTrainer runs on one device: %s is "
                                 "on %s, %s on %s"
                                 % (self._params[0].name, self._device,
                                    p.name, t.device))
        self._trainable = [p.grad_req != "null" for p in self._params]
        self._train_idx = [i for i, t in enumerate(self._trainable) if t]
        self._fixed_idx = [i for i, t in enumerate(self._trainable)
                           if not t]
        self._fixed_pos = {id(self._params[i]): k
                           for k, i in enumerate(self._fixed_idx)}
        self._train_flat = _Flat([tensors[i] for i in self._train_idx])
        self._fixed_flat = _Flat([tensors[i] for i in self._fixed_idx])
        # per-parameter compute-cast plan, resolved once: the policy's
        # ordered override rules fire by name (norm params and the loss
        # head stay f32 under bf16_mixed), everything else casts to the
        # compute dtype.  None = no cast.
        policy = self._dtype_policy
        self._cast = [None] * len(self._params)
        for i, (p, t) in enumerate(zip(self._params, tensors)):
            if not t.is_floating_point():
                continue
            if policy is not None:
                tgt = policy.param_cast_dtype(p.name, tuple(t.shape))
                if tgt != t.dtype:
                    self._cast[i] = tgt
            elif self._dtype is not None and self._dtype != t.dtype:
                self._cast[i] = self._dtype
        # the master copies: packing copies, so the net's own arrays stay
        # as they are until sync_to_net
        self._train_bufs = self._train_flat.pack(
            [tensors[i] for i in self._train_idx])
        self._fixed_bufs = self._fixed_flat.pack(
            [tensors[i] for i in self._fixed_idx])
        if self._opt_name == "sgd":
            self.opt_state = sgd_init(self._train_bufs,
                                      momentum=self._momentum)
        else:
            self.opt_state = adam_init(self._train_bufs)
        if self._ls_active:
            self.opt_state = {"base": self.opt_state,
                              "loss_scale": _dtp.init_loss_scale(
                                  self._ls_cfg, device=self._device)}
        self._metrics_acc = self._fresh_metrics()

    def _fresh_metrics(self):
        return torch.zeros((_METRICS_WIDTH,), dtype=torch.float32,
                           device=self._device)

    @property
    def param_arrays(self):
        """Each parameter's master tensor, in ``collect_params`` order
        (views of the trainer's buffers; None before the first step of a
        net with deferred shapes)."""
        if self._train_bufs is None:
            return None
        return self._views(self._train_bufs, self._fixed_bufs)

    def _views(self, train_bufs, fixed_bufs):
        """Each parameter's view of the given buffers, in parameter
        order."""
        out = [None] * len(self._params)
        for i, v in zip(self._train_idx, self._train_flat.unpack(train_bufs)):
            out[i] = v
        for i, v in zip(self._fixed_idx, self._fixed_flat.unpack(fixed_bufs)):
            out[i] = v
        return out

    def state_tensors(self):
        """Every tensor of the trainer's state: parameter buffers (moving
        stats included), optimizer state and loss-scale state."""
        return list(self._train_bufs) + list(self._fixed_bufs) + \
            _leaves(self.opt_state)

    @property
    def dtype_policy(self):
        """The resolved :class:`~mxnet_tpu_torch.dtype_policy.DtypePolicy`
        (None = the f32 path)."""
        return self._dtype_policy

    @property
    def dtype_policy_tag(self):
        """Policy tag (``"f32"`` when no policy is active)."""
        return _dtp.policy_tag(self._dtype_policy)

    def loss_scale(self):
        """Current dynamic loss scale (a host read, so a device sync: call
        it at drain boundaries, not per step).  None when the active
        policy does not loss-scale."""
        if not self._ls_active:
            return None
        if self.opt_state is None:  # deferred shapes: not yet stepped
            return float(self._ls_cfg.init)
        return float(self.opt_state["loss_scale"][0])

    def sync_to_net(self):
        """Write the trainer's parameters back into the gluon Parameters
        (as copies)."""
        for p, t in zip(self._params, self.param_arrays):
            p.set_data(NDArray(t))

    # -- the step ----------------------------------------------------------
    def _stage(self, inputs, label):
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        raw_in = tuple(self._to_device(x) for x in inputs)
        return raw_in, self._to_device(label)

    def _to_device(self, x):
        t = x._data if isinstance(x, NDArray) else torch.as_tensor(x)
        return t.to(self._device)

    def _forward_loss(self, train_leaves, fixed_bufs, inputs, label):
        """Mean loss (f32) of one batch with each parameter's compute
        tensor swapped into the block, and the aux sink's (param, value)
        pairs."""
        views = self._views(train_leaves, fixed_bufs)
        policy = self._dtype_policy
        sink = []
        saved = []
        _block_mod._aux_sink.sink = sink
        _block_mod._trace_state.active = True
        try:
            with torch.enable_grad(), autograd.record(train_mode=True), \
                    _dtp.scope(policy):
                for p, v, ct in zip(self._params, views, self._cast):
                    d = p.data()
                    saved.append((d, d._data))
                    d._data = v.to(ct) if ct is not None else v
                # inputs are not cast under a policy: the first
                # parameterized op harmonizes them to its weight
                out = self.net(*[NDArray(x.to(self._dtype)
                                         if self._dtype is not None else x)
                                 for x in inputs])
                if policy is not None and policy.cast_outputs is not None:
                    # the loss head boundary: logits in f32 before the
                    # softmax / cross-entropy
                    out = _cast_out(out, policy)
                loss = self.loss_fn(out, NDArray(label))
                loss = loss._data if isinstance(loss, NDArray) else loss
                # reduce in f32: a bf16 mean quantizes the reported loss
                loss = loss.to(torch.float32).mean()
        finally:
            for d, old in saved:
                d._data = old
            _block_mod._trace_state.active = False
            _block_mod._aux_sink.sink = None
        return loss, sink

    def _new_fixed(self, fixed_bufs, sink):
        """The non-trainable buffers with the sink's new moving stats
        written in (cast to the storage dtype; a later entry for the same
        parameter wins)."""
        if not sink:
            return fixed_bufs
        tensors = self._fixed_flat.unpack(fixed_bufs)
        for p, value in sink:
            k = self._fixed_pos.get(id(p))
            if k is None:
                raise MXNetError("aux update of trainable parameter %s"
                                 % p.name)
            tensors[k] = value.to(tensors[k].dtype)
        return self._fixed_flat.pack(tensors)

    def _step_core(self, state, inputs, label):
        """One step from ``state`` = (trainable buffers, non-trainable
        buffers, optimizer state, metric accumulator): the new state and
        the step's loss.  HOT PATH: no host sync."""
        train_bufs, fixed_bufs, opt_state, metrics = state
        ls = self._ls_active
        base_state = opt_state["base"] if ls else opt_state
        leaves = [b.detach().requires_grad_() for b in train_bufs]
        with _range("ShardedTrainer.forward"):
            loss, sink = self._forward_loss(leaves, fixed_bufs, inputs,
                                            label)
        # the SCALED loss drives the backward pass; gradients are
        # unscaled below in f32
        scale = opt_state["loss_scale"][0] if ls else None
        with _range("ShardedTrainer.backward"):
            grads = torch.autograd.grad(loss * scale if ls else loss,
                                        leaves, allow_unused=True)
        loss = loss.detach()
        with torch.no_grad(), _range("ShardedTrainer.update"):
            grads = [torch.zeros_like(b) if g is None else g
                     for g, b in zip(grads, train_bufs)]
            if ls:
                grads = torch._foreach_mul(grads, 1.0 / scale)
                # inf/nan survives the unscale: this catches a scaled
                # overflow and a poisoned batch alike
                finite = [torch.isfinite(g).all() for g in grads]
                keep = torch.isfinite(loss)
                if finite:
                    keep = keep & torch.stack(finite).all()
            else:
                keep = torch.isfinite(loss)
            if self._opt_name == "sgd":
                new_train, new_base = _sgd_update(
                    train_bufs, grads, base_state, self._lr,
                    self._momentum, self._wd)
            else:
                new_train, new_base = _adam_update(
                    train_bufs, grads, base_state, self._lr, self._beta1,
                    self._beta2, self._eps, self._wd)
            # moving stats after the update, cast to storage dtype
            new_fixed = self._new_fixed(fixed_bufs, sink)
            if self._guard:
                # a non-finite step (or, under loss scaling, an
                # overflowed gradient) keeps the previous params,
                # optimizer state and moving stats
                new_train = _select(keep, new_train, train_bufs)
                new_fixed = _select(keep, new_fixed, fixed_bufs)
                new_base = _select(keep, new_base, base_state)
            if ls:
                new_ls = _dtp.loss_scale_update(opt_state["loss_scale"],
                                                keep, self._ls_cfg)
                new_opt = {"base": new_base, "loss_scale": new_ls}
            else:
                new_opt = new_base
            # under loss scaling "finite" means the whole step (loss AND
            # unscaled grads) was finite, and the backoff slot counts skips
            finite = keep if ls else torch.isfinite(loss)
            bad = (~finite).to(torch.float32)
            zero = torch.zeros_like(loss)
            new_metrics = metrics + torch.stack(
                [torch.where(finite, loss, 0.0), torch.ones_like(loss), bad,
                 zero, zero, bad if ls else zero])
            new_metrics[_M_LAST] = loss
            if ls:
                new_metrics[_M_LS_SCALE] = new_ls[0]
        return (new_train, new_fixed, new_opt, new_metrics), loss

    def step(self, inputs, label):
        """One train step.  ``inputs``: an NDArray/tensor or a list of
        them; moved to the trainer's device if they are elsewhere.
        Returns the loss, a 0-dim device tensor (reading it waits for the
        step; the trainer itself never does under ``async_metrics``)."""
        raw_in, raw_label = self._stage(inputs, label)
        if self._train_bufs is None:
            self._lazy_init(example_inputs=raw_in)
        return self._step_inner(raw_in, raw_label)

    def step_many(self, batches):
        """Run ``steps_per_call`` train steps in one call.

        ``batches``: exactly ``steps_per_call`` pairs ``(inputs, label)``.
        The steps run in order through the code of :meth:`step`, with one
        metric flush at the end; returns the per-step losses (a device
        tensor of shape ``[K]``)."""
        K = self.steps_per_call
        if len(batches) != K:
            raise MXNetError(
                "step_many needs exactly steps_per_call=%d batches; "
                "got %d" % (K, len(batches)))
        if K == 1:
            inputs, label = batches[0]
            return torch.reshape(self.step(inputs, label), (1,))
        raws = [self._stage(inputs, label) for inputs, label in batches]
        n_in = len(raws[0][0])
        if any(len(r[0]) != n_in for r in raws):
            raise MXNetError("step_many batches disagree on input arity")
        if self._train_bufs is None:
            self._lazy_init(example_inputs=raws[0][0])
        return self._step_many_inner(raws)

    def _step_inner(self, raw_in, raw_label):
        # HOT PATH (see _dispatch_commit for the no-host-sync contract)
        return self._dispatch_commit([(raw_in, raw_label)])[0]

    def _step_many_inner(self, raws):
        # HOT PATH — same contract as _step_inner
        return torch.stack(self._dispatch_commit(raws))

    def _dispatch_commit(self, batches):
        """Run the steps and commit the new state in one assignment.

        HOT PATH.  No host sync lives here (or in _flush_metrics): every
        loss/metric host read happens in _consume_metrics_sync (sync
        mode) or on the fetch thread (async mode)."""
        self._raise_pending()
        state = (self._train_bufs, self._fixed_bufs, self.opt_state,
                 self._metrics_acc)
        losses = []
        for raw_in, raw_label in batches:
            state, loss = self._step_core(state, raw_in, raw_label)
            losses.append(loss)
        (self._train_bufs, self._fixed_bufs, self.opt_state,
         self._metrics_acc) = state
        self.global_step += len(batches)
        self._metrics_pending += len(batches)
        self._flush_metrics(self.global_step)
        return losses

    # -- metric flush / drain boundaries -----------------------------------
    def _flush_metrics(self, step, force=False):
        """Hand the device-resident accumulator off every
        ``metrics_every`` steps: to the bounded fetch thread (async) or to
        the synchronous consumer.  A fresh zeroed buffer replaces it."""
        if self._metrics_acc is None or self._metrics_pending == 0:
            return
        if not force and self._metrics_pending < self._metrics_every:
            return
        acc, self._metrics_acc = self._metrics_acc, self._fresh_metrics()
        n, self._metrics_pending = self._metrics_pending, 0
        if self._async:
            if self._fetcher is None:
                self._fetcher = _MetricFetcher(self._apply_metrics_host,
                                               depth=self._fetch_depth)
            self._fetcher.submit(step, n, acc)
        else:
            self._consume_metrics_sync(step, n, acc)

    def _consume_metrics_sync(self, step, n, acc):
        """The synchronous metric path: block on the accumulator right
        inside the step."""
        self._apply_metrics_host(step, n, acc.cpu().numpy(),
                                 async_mode=False)

    def _apply_metrics_host(self, step, n, host, async_mode=True):
        """Consume one flushed accumulator on the host: the non-finite
        policy and skip counting.  Runs on the fetch thread under async
        dispatch, inline otherwise."""
        nonfinite = int(host[_M_NONFINITE])
        if self._ls_active:
            # a scaled overflow is routine: the update was already
            # discarded and the scale backed off, so it is counted, not
            # warned or raised through the non-finite policy
            backoffs = int(host[_M_LS_BACKOFF])
            scale_now = float(host[_M_LS_SCALE])
            if backoffs:
                self.skipped_steps += backoffs
                if scale_now <= 1.0 and \
                        self._on_nonfinite in ("warn", "raise"):
                    # the scale is at its floor and steps still overflow:
                    # a poisoned run, not a routine overflow
                    what = ("loss/gradients (%d of %d steps ending at "
                            "step %d; loss scale at floor %.1f)"
                            % (backoffs, n, step, scale_now))
                    try:
                        check_finite(float("nan"), self._on_nonfinite,
                                     what=what)
                    except MXNetError as e:  # NonfiniteError ("raise")
                        if not async_mode:
                            raise
                        self._pending_exc = e
            return
        if self._on_nonfinite != "off" and nonfinite:
            what = "loss (%d of %d steps ending at step %d)" % (
                nonfinite, n, step)
            try:
                applied = check_finite(float("nan"), self._on_nonfinite,
                                       what=what)
            except MXNetError as e:  # NonfiniteError under "raise"
                if not async_mode:
                    raise
                # deferred raise: surfaces at the next step()/drain()
                self._pending_exc = e
                return
            if not applied:  # "skip": the select already discarded them
                self.skipped_steps += nonfinite

    def _raise_pending(self):
        exc, self._pending_exc = self._pending_exc, None
        if exc is not None:
            raise exc

    def drain(self):
        """Hard sync boundary for async dispatch: flush the accumulator,
        wait for every in-flight fetch to complete and apply, then
        re-raise any deferred non-finite error.  Call before reading
        ``skipped_steps``.  A no-op in sync mode."""
        self._flush_metrics(self.global_step, force=True)
        if self._fetcher is not None:
            self._fetcher.wait()
            if self._fetcher.error is not None:
                err, self._fetcher.error = self._fetcher.error, None
                raise err
        self._raise_pending()
        return self

    def close(self):
        """Drain and stop the fetch thread.  Safe to call repeatedly; the
        trainer keeps working afterwards."""
        self.drain()
        if self._fetcher is not None:
            fetcher, self._fetcher = self._fetcher, None
            fetcher.close()
        return self

    def configure_overlap(self, async_metrics=None, steps_per_call=None,
                          metrics_every=None):
        """Re-knob async metrics, K and the flush cadence after
        construction.  Drains first, so a toggle neither loses nor
        double-counts in-flight metrics."""
        self.drain()
        if async_metrics is not None:
            self._async = bool(async_metrics)
            if not self._async and self._fetcher is not None:
                fetcher, self._fetcher = self._fetcher, None
                fetcher.close()
        if steps_per_call is not None:
            k = int(steps_per_call)
            if k < 1:
                raise MXNetError("steps_per_call must be >= 1; got %d" % k)
            self.steps_per_call = k
            if not self._metrics_every_explicit:
                self._metrics_every = k
        if metrics_every is not None:
            self._metrics_every = max(1, int(metrics_every))
            self._metrics_every_explicit = True
        return self


def _cast_out(out, policy):
    if isinstance(out, NDArray):
        return NDArray(policy.cast_output(out._data))
    if isinstance(out, (list, tuple)):
        return type(out)(_cast_out(v, policy) for v in out)
    return out
