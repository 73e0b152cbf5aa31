"""Executor: a bound symbol run as one compiled function (parity:
mxnet_tpu/executor.py; include/mxnet/executor.h:53,
src/executor/graph_executor.cc Forward/Backward, SimpleBind :1694).

The symbol evaluates as one Python function over named tensors
(``Symbol._build_fn``), run through the port's compiled path (``jit``),
the counterpart of the JAX Executor's ``jax.jit``; there is one compiled
object for each (train or eval, grad or not, bound shapes and dtypes).
``forward(is_train=True)`` runs it under torch's grad mode with the
arguments whose ``grad_req`` is not ``null`` as fresh leaves;
``backward`` runs ``torch.autograd.grad`` for those leaves and writes
(``write``) or adds (``add``) each gradient into its grad array.

At bind, ``fusion`` (else ``MXNET_FUSION``) runs the graph-fusion passes
(``symbol.fusion.apply_fusion``) over the graph the compiled function
runs; with neither set, the default-on patterns fire (``add_act``,
``act_scale_add``), as in the JAX Executor.  ``fusion_fired`` lists the
rewrites.  BatchNorm's moving stats are threaded as in the JAX Executor:
the graph function returns their new values, which are rebound into
``aux_dict`` after the forward.  Under a dtype policy, arguments are cast to their
compute dtype by name, except data and labels (``_DATA_INPUT_RE``), and
floating outputs come back in the policy's output dtype.
"""
from __future__ import annotations

import re

import torch

from .base import MXNetError
from .context import current_context
from . import autograd as _ag
from . import dtype_policy as _dtp
from . import fusion_cost as _fc
from . import jit as _jit
from .ndarray.ndarray import NDArray

__all__ = ["Executor"]

# symbolic args that carry per-batch DATA, not parameters: the mxnet
# naming convention ("data", "data0", "softmax_label", "label", ...).
# A dtype policy must not cast these — labels/token ids ride f32
# carriers whose integer values bf16 cannot represent above 256.
_DATA_INPUT_RE = re.compile(r"(^|_)(data|label)s?\d*$")


def _not_ported(**flags):
    for name, value in flags.items():
        if value is not None:
            raise MXNetError("%s=%r: not ported yet" % (name, value))


class Executor:
    def __init__(self, symbol, ctx, args, args_grad, grad_req, aux_states,
                 shared_exec=None, remat_policy=None, fusion=None,
                 aot=None, dtype_policy=None):
        _not_ported(remat_policy=remat_policy, aot=aot)
        # None defers to MXNET_FUSION; a bad spec fails here, at bind
        fusion_plan = _fc.resolve_fusion(fusion)
        self._fusion = fusion
        self._dtype_policy = dtype_policy
        policy = _dtp.resolve_policy(dtype_policy)
        self._symbol = symbol
        self._ctx = ctx or current_context()
        self.arg_dict = dict(args)
        self.grad_dict = dict(args_grad or {})
        self.aux_dict = dict(aux_states or {})
        self._grad_req = grad_req
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._out_names = symbol.list_outputs()

        missing = [n for n in self._arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        self._grad_names = tuple(sorted(
            n for n in self.grad_dict if self._req(n, "null") != "null"))

        # the compiled function runs the graph after the fusion passes;
        # they keep every argument, auxiliary and output name, so
        # self._symbol and the name lists stay the caller's graph
        exec_symbol = symbol
        self.fusion_fired = []
        if fusion_plan is not None:
            from .symbol import fusion as _fusion

            known = {n: (tuple(a.shape), a.dtype)
                     for d in (self.arg_dict, self.aux_dict)
                     for n, a in d.items()}
            exec_symbol, self.fusion_fired = _fusion.apply_fusion(
                symbol, fusion_plan, known=known)
        graph_fn, _, _ = exec_symbol._build_fn()
        device = self._ctx.torch_device

        def fwd(values, is_train):
            orig = values
            if policy is not None:
                values = {n: v if _DATA_INPUT_RE.search(n)
                          else policy.cast_compute(n, v)
                          for n, v in values.items()}
            with _dtp.scope(policy):
                outs, aux = graph_fn(values, is_train=is_train,
                                     device=device)
            if policy is not None:
                outs = [policy.cast_output(o) for o in outs]
                aux = {k: v.to(orig[k].dtype) for k, v in aux.items()}
            return tuple(outs), aux

        self._compiled = _jit.Compiled(fwd, "executor")
        self._outputs = None
        self._leaves = None   # (grad names' leaves, outputs) of a train fwd
        self.monitor_callback = None
        self._monitor_all = False

    def _req(self, name, default="write"):
        req = self._grad_req
        return req.get(name, default) if isinstance(req, dict) else req

    # ------------------------------------------------------------------
    @property
    def outputs(self):
        return self._outputs or []

    def _values(self, grad_leaves):
        v = {}
        for n in self._arg_names:
            t = self.arg_dict[n]._data.detach()
            v[n] = t.requires_grad_(True) if grad_leaves and \
                n in self._grad_names else t
        v.update({n: self.aux_dict[n]._data.detach()
                  for n in self._aux_names})
        return v

    def _run(self, values, is_train, grad):
        key = (is_train, grad, _jit.signature(values.values()))
        prev = _ag.set_training(is_train)
        try:
            with torch.set_grad_enabled(grad):
                return self._compiled(key, values, is_train)
        except MXNetError:
            raise
        except Exception as e:
            raise MXNetError("error executing graph: %s" % e) from e
        finally:
            _ag.set_training(prev)

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k in self.arg_dict:
                self.arg_dict[k]._rebind(
                    v._data if isinstance(v, NDArray) else v)
        grad = bool(is_train) and bool(self._grad_names)
        values = self._values(grad)
        outs, aux = self._run(values, bool(is_train), grad)
        for name, val in aux.items():
            if name in self.aux_dict:
                self.aux_dict[name]._rebind(val)
        self._leaves = ([values[n] for n in self._grad_names], outs) \
            if grad else None
        self._outputs = [NDArray(o.detach()) for o in outs]
        if self.monitor_callback is not None:
            for name, out in zip(self._out_names, self._outputs):
                self.monitor_callback(name, out)
        return self._outputs

    def backward(self, out_grads=None, is_train=True):
        if self._leaves is None:
            if not self._grad_names:
                return
            raise MXNetError("backward called before forward(is_train=True)")
        leaves, outs = self._leaves
        if out_grads is None:
            cots = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cots = [g._data if isinstance(g, NDArray) else g
                    for g in out_grads]
        pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], leaves, [c for _, c in pairs],
            allow_unused=True)
        for name, leaf, g in zip(self._grad_names, leaves, grads):
            tgt = self.grad_dict[name]
            g = torch.zeros_like(leaf) if g is None else g
            g = g.to(tgt._data.dtype)
            if self._req(name) == "add":
                tgt._rebind(tgt._data + g)
            else:
                tgt._rebind(g)
        self._leaves = None

    # ------------------------------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._out_names, self.outputs))

    @property
    def compile_seconds(self):
        return self._compiled.compile_seconds

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in (arg_params or {}).items():
            if k in self.arg_dict:
                tgt = self.arg_dict[k]._data
                self.arg_dict[k]._rebind(v._data.to(tgt.device, tgt.dtype,
                                                    copy=True))
            elif not allow_extra_params:
                raise MXNetError("unknown arg %s" % k)
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                tgt = self.aux_dict[k]._data
                self.aux_dict[k]._rebind(v._data.to(tgt.device, copy=True))
            elif not allow_extra_params:
                raise MXNetError("unknown aux %s" % k)

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor for new shapes: arrays whose shape stays are
        shared, the others are made anew as zeros."""
        from .ndarray.ndarray import zeros as nd_zeros

        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new_args = {}
        for name, shp in zip(self._arg_names, arg_shapes):
            old = self.arg_dict[name]
            new_args[name] = old if tuple(old.shape) == tuple(shp) else \
                nd_zeros(shp, ctx=self._ctx, dtype=old.dtype)
        new_grads = {n: nd_zeros(new_args[n].shape, ctx=self._ctx)
                     for n in self.grad_dict}
        new_aux = {}
        for name, shp in zip(self._aux_names, aux_shapes):
            old = self.aux_dict[name]
            new_aux[name] = old if tuple(old.shape) == tuple(shp) else \
                nd_zeros(shp, ctx=self._ctx, dtype=old.dtype)
        return Executor(self._symbol, self._ctx, new_args, new_grads,
                        self._grad_req, new_aux, fusion=self._fusion,
                        dtype_policy=self._dtype_policy)

    def set_monitor_callback(self, callback, monitor_all=False):
        self.monitor_callback = callback
        self._monitor_all = monitor_all

    def debug_str(self):
        return "Executor(outputs=%s)" % (self._out_names,)
