"""Custom operator framework: CustomOp / CustomOpProp / register
(parity: mxnet_tpu/operator.py; python/mxnet/operator.py:426 CustomOp,
:472 CustomOpProp, :692 register, driven upstream by
src/operator/custom/custom.cc).  Usage is upstream's::

    @mx.operator.register("sqr")
    class SqrProp(mx.operator.CustomOpProp):
        ...
    y = mx.nd.Custom(x, op_type="sqr")
    s = mx.sym.Custom(data=d, op_type="sqr")

The user's ``forward`` and ``backward`` receive NDArrays on the inputs'
own device, as upstream's engine hands them, with the same ``req`` /
``in_data`` / ``out_data`` / ``in_grad`` / ``aux`` contract; the output
and gradient arrays are zeros of the shapes and dtypes that
``infer_shape`` / ``infer_type`` give.  The op body is a
``torch.autograd.Function`` whose backward calls the same operator
instance on the saved inputs and outputs.  Inside a compiled graph
(``hybridize()``, the symbolic ``Executor``) the body is the
``torch.library`` op ``mxnet_tpu_torch::custom`` and its backward
``mxnet_tpu_torch::custom_backward``, which dynamo and inductor keep
whole: their fake versions answer from ``infer_shape`` / ``infer_type``,
and the operator instance is made once a trace, as the JAX package makes
one a trace.  That instance lasts for the life of the process (see
``_TRACED``).  In a compiled graph an auxiliary state's writes are not
propagated back (the op works on copies, and a warning says so, as in
the JAX package); eagerly they land in the aux arrays.
"""
from __future__ import annotations

import itertools
import warnings
from typing import List

import numpy as onp
import torch

from .base import MXNetError, numpy_dtype, torch_dtype

__all__ = ["CustomOp", "CustomOpProp", "register", "get_prop_cls"]

_CUSTOM_REGISTRY = {}


class CustomOp:
    """Base class for operators implemented in Python (parity:
    operator.py:426)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        pass

    def assign(self, dst, req, src):
        """Assign ``src`` to ``dst`` honoring the write request."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src


class CustomOpProp:
    """Describes a custom op: arity, shapes, dtypes (parity:
    operator.py:472)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, (in_shape[0],) * len(self.list_outputs()), ()

    def infer_type(self, in_type):
        return (in_type,
                [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def infer_storage_type(self, in_stype):
        return in_stype, ["default"] * len(self.list_outputs()), \
            ["default"] * len(self.list_auxiliary_states())

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Decorator registering a CustomOpProp subclass under ``op_type``
    (parity: operator.py:692)."""

    def _do(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("can only register subclass of CustomOpProp")
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return _do


def get_prop_cls(op_type):
    if op_type not in _CUSTOM_REGISTRY:
        raise MXNetError("custom op type %r is not registered with "
                         "mx.operator.register" % op_type)
    return _CUSTOM_REGISTRY[op_type]


_PROP_CACHE = {}


def _make_prop(op_type, ctor_kwargs):
    # reference custom.cc hands ctor kwargs to the prop as strings;
    # memoized since num_outputs/shape queries re-ask per node access
    key = (op_type, tuple(sorted((k, str(v))
                                 for k, v in ctor_kwargs.items())))
    prop = _PROP_CACHE.get(key)
    if prop is None:
        prop = get_prop_cls(op_type)(**{k: str(v) for k, v in
                                        ctor_kwargs.items()})
        _PROP_CACHE[key] = prop
    return prop


def _custom_num_outputs(attrs):
    ctor = {k: v for k, v in attrs.items() if k != "op_type"}
    return len(_make_prop(attrs["op_type"], ctor).list_outputs())


def _shapes3(res, what):
    """Normalize infer_shape/infer_type's 2-or-3-tuple return."""
    if len(res) == 2:
        return res[0], res[1], ()
    if len(res) == 3:
        return res
    raise MXNetError("CustomOpProp.%s must return 2 or 3 lists" % what)


class _Call:
    """One operator instance and what its calls need: the prop's
    argument count, the training flag of the call, and the outputs'
    shapes and dtypes from ``infer_shape`` / ``infer_type``."""

    def __init__(self, op_type, ctor, in_shapes, in_dtypes, n_aux, device,
                 is_train):
        from .context import Context

        prop = _make_prop(op_type, ctor)
        self.n_args = len(prop.list_arguments())
        if len(in_shapes) != self.n_args or \
                n_aux != len(prop.list_auxiliary_states()):
            raise MXNetError(
                "Custom op %r expects %d arguments + %d auxiliary states, "
                "got %d inputs" % (op_type, self.n_args,
                                   len(prop.list_auxiliary_states()),
                                   len(in_shapes) + n_aux))
        shapes = [list(s) for s in in_shapes]
        _, out_shapes, _ = _shapes3(prop.infer_shape(shapes), "infer_shape")
        types = [onp.dtype(t) for t in in_dtypes]
        _, out_types, _ = _shapes3(prop.infer_type(list(types)),
                                   "infer_type")
        self.out_shapes = [tuple(int(d) for d in s) for s in out_shapes]
        self.out_dtypes = [torch_dtype(onp.dtype(t)) for t in out_types]
        self.device = torch.device(device)
        self.is_train = is_train
        self.op = prop.create_operator(Context.from_device(self.device),
                                       shapes, types)

    def forward(self, args, aux):
        """Output tensors of the user's forward on ``args`` and ``aux``
        (written in place by the user, as upstream's aux states are)."""
        from . import autograd
        from .ndarray.ndarray import NDArray

        device = args[0].device if args else self.device
        outs = [torch.zeros(s, dtype=d, device=device)
                for s, d in zip(self.out_shapes, self.out_dtypes)]
        out_nd = [NDArray(o) for o in outs]
        with autograd.pause(self.is_train):
            self.op.forward(self.is_train, ["write"] * len(outs),
                            [NDArray(a.detach()) for a in args], out_nd,
                            [NDArray(a) for a in aux])
        return _fresh([o._data for o in out_nd], list(args) + list(aux))

    def backward(self, args, aux, outs, grads):
        """The inputs' gradients from the user's backward."""
        from . import autograd
        from .ndarray.ndarray import NDArray

        igrads = [NDArray(torch.zeros_like(a)) for a in args]
        with autograd.pause(self.is_train):
            self.op.backward(["write"] * len(args),
                             [NDArray(g) for g in grads],
                             [NDArray(a) for a in args],
                             [NDArray(o) for o in outs], igrads,
                             [NDArray(a) for a in aux])
        return _fresh([g._data.to(a.dtype) for g, a in zip(igrads, args)],
                      list(args) + list(aux) + list(outs) + list(grads))


def _fresh(results, sources):
    """``results``, each copied where it shares storage with one of
    ``sources`` or with an earlier result (a custom op's outputs may not
    alias its inputs or each other)."""
    seen = {s.untyped_storage().data_ptr() for s in sources
            if s.numel()}
    out = []
    for r in results:
        ptr = r.untyped_storage().data_ptr()
        if r.numel() and ptr in seen:
            r = r.clone()
            ptr = r.untyped_storage().data_ptr()
        seen.add(ptr)
        out.append(r.contiguous())
    return out


class _CustomFunction(torch.autograd.Function):
    """The eager body: the user's forward, and a backward on the saved
    inputs and outputs with the same operator instance."""

    @staticmethod
    def forward(ctx, call, n_args, *flat):
        args, aux = flat[:n_args], flat[n_args:]
        outs = call.forward(args, aux)
        ctx.call, ctx.aux = call, aux
        ctx.save_for_backward(*args, *outs)
        for o in outs:
            if not o.is_floating_point():
                ctx.mark_non_differentiable(o)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        saved = ctx.saved_tensors
        args, outs = saved[:call.n_args], saved[call.n_args:]
        grads = [torch.zeros_like(o) if g is None else g
                 for g, o in zip(grads, outs)]
        igrads = call.backward(args, ctx.aux, outs, grads)
        # aux states receive no gradient
        return (None, None) + tuple(igrads) + (None,) * len(ctx.aux)


# the operator of each traced call, by the key its graph holds.  An entry
# lasts for the life of the process: the graph holds only the key, and
# its compiled backward may run after the block that compiled it is
# gone.  Entries grow by one a trace, as compiled graphs do (jit.Compiled
# keeps one graph a signature and evicts none)
_TRACED = {}
_trace_ids = itertools.count()


@torch.compiler.assume_constant_result
def _trace_key(op_type, ctor, shapes, dtypes, device, is_train):
    """Make the operator of a call that a compiled graph holds (once a
    trace, outside the graph) and return its key; ``shapes`` and
    ``dtypes`` are the arguments' and then the aux states'."""
    n_args = len(_make_prop(op_type, dict(ctor)).list_arguments())
    call = _Call(op_type, dict(ctor), shapes[:n_args],
                 [numpy_dtype(getattr(torch, d)) for d in dtypes[:n_args]],
                 len(shapes) - n_args, device, is_train)
    if len(shapes) > n_args:
        warnings.warn(
            "Custom op %r: auxiliary-state mutations inside a traced "
            "(hybridized/jitted) region are not propagated back to the "
            "aux NDArrays; run the op eagerly if forward must update aux "
            "state" % op_type, RuntimeWarning, stacklevel=2)
    key = "%s#%d" % (op_type, next(_trace_ids))
    _TRACED[key] = call
    return key


@torch.library.custom_op("mxnet_tpu_torch::custom", mutates_args=())
def _custom_op(flat: List[torch.Tensor], key: str) -> List[torch.Tensor]:
    """A Custom call inside a compiled graph: the user's forward on the
    arguments and on copies of the aux states (``flat`` holds both)."""
    call = _TRACED[key]
    return call.forward(flat[:call.n_args],
                        [a.clone() for a in flat[call.n_args:]])


@_custom_op.register_fake
def _(flat, key):
    call = _TRACED[key]
    device = flat[0].device if flat else call.device
    return [torch.empty(s, dtype=d, device=device)
            for s, d in zip(call.out_shapes, call.out_dtypes)]


@torch.library.custom_op("mxnet_tpu_torch::custom_backward",
                         mutates_args=())
def _custom_backward_op(flat: List[torch.Tensor], outs: List[torch.Tensor],
                        grads: List[torch.Tensor],
                        key: str) -> List[torch.Tensor]:
    """The arguments' gradients of a Custom call in a compiled graph."""
    call = _TRACED[key]
    return call.backward(flat[:call.n_args], flat[call.n_args:], outs,
                         grads)


@_custom_backward_op.register_fake
def _(flat, outs, grads, key):
    return [torch.empty_like(a) for a in flat[:_TRACED[key].n_args]]


def _custom_setup(ctx, inputs, output):
    flat, key = inputs
    ctx.key, ctx.n_flat = key, len(flat)
    ctx.save_for_backward(*flat, *output)


def _custom_backward(ctx, grads):
    saved = ctx.saved_tensors
    flat, outs = list(saved[:ctx.n_flat]), list(saved[ctx.n_flat:])
    grads = [torch.zeros_like(o) if g is None else g
             for g, o in zip(grads, outs)]
    igrads = _custom_backward_op(flat, outs, grads, ctx.key)
    # aux states receive no gradient
    return list(igrads) + [None] * (ctx.n_flat - len(igrads)), None


_custom_op.register_autograd(_custom_backward, setup_context=_custom_setup)


def _custom_fn(*arrays, op_type=None, **ctor_kwargs):
    """The registered 'Custom' op body (module doc): the eager
    ``torch.autograd.Function``, the ``mxnet_tpu_torch::custom`` op in a
    compiled graph, and the outputs' shapes alone on meta tensors (shape
    inference)."""
    from . import autograd
    from .context import current_context

    if op_type is None:
        raise MXNetError("Custom op requires op_type=")
    device = arrays[0].device if arrays else \
        current_context().torch_device
    is_train = autograd.is_training()
    if torch.compiler.is_compiling():
        # everything about the prop is asked once, outside the graph
        key = _trace_key(op_type, tuple(sorted(
            (k, str(v)) for k, v in ctor_kwargs.items())),
            tuple(tuple(a.shape) for a in arrays),
            tuple(str(a.dtype)[6:] for a in arrays), str(device), is_train)
        outs = _custom_op(list(arrays), key)
    else:
        n_args = len(_make_prop(op_type, ctor_kwargs).list_arguments())
        call = _Call(op_type, ctor_kwargs,
                     [tuple(a.shape) for a in arrays[:n_args]],
                     [numpy_dtype(a.dtype) for a in arrays[:n_args]],
                     len(arrays) - n_args, device, is_train)
        if device.type == "meta":
            outs = [torch.empty(s, dtype=d, device=device)
                    for s, d in zip(call.out_shapes, call.out_dtypes)]
        else:
            outs = _CustomFunction.apply(call, n_args, *arrays)
    return tuple(outs) if len(outs) > 1 else outs[0]


def _register_custom_op():
    from .ops.registry import register as _reg_op

    _reg_op("Custom", num_inputs=-1, num_outputs=_custom_num_outputs)(
        _custom_fn)


_register_custom_op()


# ---------------------------------------------------------------------------
# nd.Custom / sym.Custom surfaces (kwarg inputs ordered by the prop's
# declared argument names, as upstream's C++ front end does)
# ---------------------------------------------------------------------------


def _order_inputs(prop, pos_args, array_kwargs):
    names = prop.list_arguments() + prop.list_auxiliary_states()
    inputs = []
    pos = list(pos_args)
    missing = []
    for n in names:
        if n in array_kwargs:
            inputs.append(array_kwargs.pop(n))
        elif pos:
            inputs.append(pos.pop(0))
        else:
            missing.append(n)
    if missing:
        raise MXNetError("Custom op %s: missing inputs %s"
                         % (type(prop).__name__, missing))
    if pos or array_kwargs:
        raise MXNetError(
            "Custom op %s: unmatched inputs (extra positional: %d, "
            "unknown names: %s)" % (type(prop).__name__, len(pos),
                                    sorted(array_kwargs)))
    return inputs


def _custom_surface(array_type, invoke):
    def Custom(*args, **kwargs):
        op_type = kwargs.pop("op_type", None)
        name = kwargs.pop("name", None)
        if op_type is None:
            raise MXNetError("Custom requires op_type=")
        arr_kw = {k: v for k, v in kwargs.items()
                  if isinstance(v, array_type)}
        ctor = {k: str(v) for k, v in kwargs.items() if k not in arr_kw}
        prop = _make_prop(op_type, ctor)
        inputs = _order_inputs(prop, args, dict(arr_kw))
        attrs = dict(ctor)
        attrs["op_type"] = op_type
        return invoke(inputs, attrs, name)

    Custom.__doc__ = "Invoke a registered custom operator (op_type=...)."
    return Custom


def make_nd_custom():
    from .ndarray.ndarray import NDArray, _invoke_nd

    return _custom_surface(
        NDArray, lambda inputs, attrs, name: _invoke_nd("Custom", inputs,
                                                        attrs))


def make_sym_custom():
    from .symbol.symbol import Symbol, _invoke_sym

    return _custom_surface(
        Symbol, lambda inputs, attrs, name: _invoke_sym("Custom", inputs,
                                                        attrs, name=name))
