"""Basic layers (parity: mxnet_tpu/gluon/nn/basic_layers.py —
HybridSequential, Dense, Activation, BatchNorm, Embedding :261, Flatten,
LayerNorm :326, HybridLambda)."""
from __future__ import annotations

import math

import torch

from ...base import MXNetError
from ..block import HybridBlock, _current_aux_sink
from ... import autograd

__all__ = ["HybridSequential", "Dense", "Activation", "BatchNorm",
           "Embedding", "Flatten", "LayerNorm", "HybridLambda"]


def _init_by_name(init):
    from ... import initializer

    if isinstance(init, str):
        return initializer.create(init)
    return init


class HybridSequential(HybridBlock):
    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully-connected layer (FullyConnected -> one cuBLAS GEMM)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        self._units = units
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,),
                    init=_init_by_name(bias_initializer), dtype=dtype,
                    allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _infer_param_shapes(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        act = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class BatchNorm(HybridBlock):
    """Batch normalization with the JAX package's defaults (epsilon 1e-5,
    momentum 0.9, ``fix_gamma = not scale``).  In training the moving
    stats are updated from the batch mean and the biased batch variance:
    ``new = m * running + (1 - m) * batch``, rebound here, or handed to
    the aux sink inside a ``ShardedTrainer`` step."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        if axis != 1:
            raise MXNetError("only channel axis 1 is ported")
        self._kwargs = {"eps": epsilon, "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._momentum = momentum
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=_init_by_name(gamma_initializer),
            allow_deferred_init=True, differentiable=scale)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=_init_by_name(beta_initializer),
            allow_deferred_init=True, differentiable=center)
        self.running_mean = self.params.get(
            "running_mean", grad_req="null", shape=(in_channels,),
            init=_init_by_name(running_mean_initializer),
            allow_deferred_init=True, differentiable=False)
        self.running_var = self.params.get(
            "running_var", grad_req="null", shape=(in_channels,),
            init=_init_by_name(running_variance_initializer),
            allow_deferred_init=True, differentiable=False)

    def _infer_param_shapes(self, x, *args):
        c = x.shape[1]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        training = autograd.is_training() and \
            not self._kwargs["use_global_stats"]
        out, mean, var = F.BatchNorm(x, gamma, beta, running_mean,
                                     running_var, training=training,
                                     **self._kwargs)
        if training:
            m = self._momentum
            with torch.no_grad():
                new_mean = m * running_mean._data + (1 - m) * mean._data
                new_var = m * running_var._data + (1 - m) * var._data
            sink = _current_aux_sink()
            if sink is not None:
                sink.append((self.running_mean, new_mean))
                sink.append((self.running_var, new_var))
            else:
                running_mean._rebind(new_mean)
                running_var._rebind(new_var)
        return out


class Embedding(HybridBlock):
    """Rows of an ``(input_dim, output_dim)`` weight by integer id."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": sparse_grad}
        self.weight = self.params.get("weight", shape=(input_dim, output_dim),
                                      init=weight_initializer, dtype=dtype,
                                      allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` with learned gamma and beta
    (their length deferred to the first input)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=_init_by_name(gamma_initializer),
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=_init_by_name(beta_initializer),
            allow_deferred_init=True)

    def _infer_param_shapes(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, data, gamma, beta):
        return F.LayerNorm(data, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class HybridLambda(HybridBlock):
    """Wrap ``function(F, x, *args)`` (or the name of an F function)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd

            if not hasattr(nd, function):
                raise MXNetError("Function name %s is not found in nd."
                                 % function)
            self._func = lambda F, *args: getattr(F, function)(*args)
        elif callable(function):
            self._func = function
        else:
            raise ValueError("Unrecognized function in lambda: {}".format(
                function))

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)
