"""Operator registry (parity: mxnet_tpu/ops/registry.py; the reference's
nnvm op registry and the codegen of python/mxnet/ndarray/register.py).

An op is a plain function on ``torch.Tensor``s plus attributes.  Its
gradient is torch autograd's (the JAX package takes ``jax.vjp`` of the
same function), so no op carries a hand-written backward.  ``mx.nd`` is
generated from this registry (``ndarray/register.py``).
"""
from __future__ import annotations

from ..base import MXNetError, _Null

__all__ = ["OpInfo", "register", "get_op", "list_ops", "alias"]

_OP_REGISTRY = {}


class OpInfo:
    """One registered operator.

    Parameters
    ----------
    name : canonical op name (MXNet spelling, e.g. 'broadcast_add')
    fn : callable(*tensors, **attrs) -> tensor | tuple(tensors)
    num_inputs : int, or -1 for variadic
    num_outputs : int or callable(attrs) -> int
    differentiable : run under the recording state's grad mode; a
        non-differentiable op always runs without grad
    mutate_inputs : indices of inputs the op updates in place; the
        NDArray layer rebinds those handles to the results
    uses_rng : the op draws from the framework random stream
    visible_outputs : outputs past this count are internal (BatchNorm's
        batch statistics)
    static_inputs : inputs that take no gradient (kept for parity: torch
        autograd sees the concrete tensors, so nothing is replayed)
    """

    __slots__ = (
        "name", "fn", "num_inputs", "num_outputs", "differentiable",
        "mutate_inputs", "doc", "aliases", "uses_rng", "visible_outputs",
        "static_inputs",
    )

    def __init__(self, name, fn, num_inputs=1, num_outputs=1,
                 differentiable=True, mutate_inputs=(), doc=None,
                 uses_rng=False, visible_outputs=None, static_inputs=()):
        self.name = name
        self.fn = fn
        self.num_inputs = num_inputs
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self.mutate_inputs = tuple(mutate_inputs)
        self.doc = doc or (fn.__doc__ if fn else None)
        self.aliases = []
        self.uses_rng = uses_rng
        self.visible_outputs = visible_outputs
        self.static_inputs = tuple(static_inputs)

    def n_outputs(self, attrs=None):
        if callable(self.num_outputs):
            return self.num_outputs(attrs or {})
        return self.num_outputs

    def n_visible_outputs(self, attrs=None):
        if self.visible_outputs is None:
            return self.n_outputs(attrs)
        if callable(self.visible_outputs):
            return self.visible_outputs(attrs or {})
        return self.visible_outputs

    def __repr__(self):
        return "OpInfo(%s)" % self.name


def register(name, num_inputs=1, num_outputs=1, differentiable=True,
             mutate_inputs=(), aliases=(), uses_rng=False,
             visible_outputs=None, static_inputs=()):
    """Decorator: register a function on tensors as an operator."""

    def _reg(fn):
        info = OpInfo(name, fn, num_inputs, num_outputs, differentiable,
                      mutate_inputs, uses_rng=uses_rng,
                      visible_outputs=visible_outputs,
                      static_inputs=static_inputs)
        if name in _OP_REGISTRY:
            raise MXNetError("op %r already registered" % name)
        _OP_REGISTRY[name] = info
        for a in aliases:
            alias(name, a)
        return fn

    return _reg


def alias(name, alias_name):
    info = _OP_REGISTRY[name]
    info.aliases.append(alias_name)
    _OP_REGISTRY[alias_name] = info


def get_op(name):
    try:
        return _OP_REGISTRY[name]
    except KeyError:
        raise MXNetError("operator %r is not registered" % name) from None


def list_ops():
    return sorted(_OP_REGISTRY)


def clean_attrs(kwargs):
    """Drop _Null placeholders and framework-internal kwargs."""
    return {k: v for k, v in kwargs.items()
            if v is not _Null and not k.startswith("__")}
