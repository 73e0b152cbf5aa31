"""Basic layers (parity: mxnet_tpu/gluon/nn/basic_layers.py — Sequential
:18, HybridSequential, Dense, Dropout :158, Activation, BatchNorm,
Embedding, Flatten, InstanceNorm :289, LayerNorm, Lambda :360,
HybridLambda)."""
from __future__ import annotations

import math

import numpy as np

from ...base import MXNetError
from ..block import Block, HybridBlock, _current_aux_sink
from ... import autograd

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "Activation", "BatchNorm", "Embedding", "Flatten", "InstanceNorm",
           "LayerNorm", "Lambda", "HybridLambda"]


def _init_by_name(init):
    from ... import initializer

    if isinstance(init, str):
        return initializer.create(init)
    return init


class Sequential(Block):
    """Children run in order, eagerly (a ``Block``, not hybridizable)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children.values()):
            import warnings

            warnings.warn("All children of this Sequential layer are "
                          "HybridBlocks. Consider using HybridSequential.",
                          stacklevel=2)
        super().hybridize(active, **kwargs)


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
        if bias is None:
            act = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        else:
            act = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act


class Dropout(HybridBlock):
    """Dropout with rate ``rate`` (the op's ``p``); ``axes`` share one
    draw.  The identity, as a copy, at rate 0."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return F._copy(x)

    def __repr__(self):
        return "Dropout(p = {_rate}, axes={_axes})".format(**self.__dict__)


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
        # the JAX layer's attributes; use_global_stats stays as given, so
        # an exported BatchNorm follows the executor's is_train (the JAX
        # layer writes True there when it exports in predict mode)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._momentum = momentum
        self._half_out = False
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

    def cast(self, dtype):
        """float16 keeps the parameters at float32 (parity:
        basic_layers.py:219); the output then takes the data's float16,
        as the reference's BatchNorm gives."""
        self._half_out = np.dtype(dtype).name == "float16"
        if self._half_out:
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out = F.BatchNorm(x, gamma, beta, running_mean, running_var,
                          **self._kwargs)
        if not isinstance(out, (list, tuple)):
            # a symbolic BatchNorm has one visible output; the executor
            # updates its moving stats (parity: basic_layers.py:224-253)
            return out
        out, mean, var = out
        if self._half_out and out.dtype != x.dtype:
            out = out.astype(x.dtype)
        if autograd.is_training() and not self._kwargs["use_global_stats"]:
            m = self._momentum
            new_mean = m * running_mean + (1 - m) * mean
            new_var = m * running_var + (1 - m) * var
            sink = _current_aux_sink()
            if sink is not None:
                sink.append((self.running_mean, new_mean._data))
                sink.append((self.running_var, new_var._data))
            else:
                running_mean._rebind(new_mean._data)
                running_var._rebind(new_var._data)
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


class InstanceNorm(HybridBlock):
    """Instance normalization over the spatial axes, per sample and
    channel (channel ``axis``), with the JAX package's defaults: epsilon
    1e-5, ``center`` True, ``scale`` False (gamma stays at one)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
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
        c = x.shape[1]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta,
                              eps=self._epsilon).swapaxes(1, self._axis)

    def __repr__(self):
        return "InstanceNorm(eps=%s, axis=%s)" % (self._epsilon, self._axis)


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


class Lambda(Block):
    """Wrap ``function(*args)`` (or the name of an ``mx.nd`` function) as
    a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd

            if not hasattr(nd, function):
                raise MXNetError("Function name %s is not found in nd."
                                 % function)
            self._func_impl = getattr(nd, function)
            self._func_name = function
        elif callable(function):
            self._func_impl = function
            self._func_name = function.__name__
        else:
            raise ValueError("Unrecognized function in lambda: {}".format(
                function))

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "Lambda({})".format(self._func_name)


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
