"""Weight initializers (parity: mxnet_tpu/initializer.py,
python/mxnet/initializer.py).  Random draws come from the explicit
per-device generator in ``mxnet_tpu_torch.random``.

An initializer dispatches on the parameter name's suffix, or on an
``__init__`` attribute of its ``InitDesc`` (the JSON of ``dumps``), as the
reference does.  ``Load`` takes values from a dict of arrays and
``Mixed`` picks an initializer by a regular expression of the name.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from .base import MXNetError
from . import random as _random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Load", "Mixed", "create", "register"]

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """Name descriptor handed to initializers, with the parameter's
    attributes."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base class: ``__call__(desc, arr)`` fills ``arr`` in place."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose = verbose
        self._print_func = print_func
        return self

    def dumps(self):
        """``[name, kwargs]`` as JSON, the form ``InitDesc``'s
        ``__init__`` attribute takes."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        init = desc.attrs.get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            _INIT_REGISTRY[klass.lower()](**kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith(("running_mean", "moving_mean", "moving_inv_var",
                            "moving_avg", "min", "max")):
            self._init_zero(desc, arr)
        elif name.endswith(("running_var", "moving_var")):
            self._init_one(desc, arr)
        else:
            self._init_default(desc, arr)
        if self._verbose and self._print_func is not None:
            self._print_func("Initialized %s as %s" % (desc, self.dumps()))

    @staticmethod
    def _fill(arr, value):
        with torch.no_grad():
            arr._data.fill_(value)

    @staticmethod
    def _set(arr, value):
        """Copy host values (any dtype, ``arr``'s size) into ``arr``."""
        t = arr._data
        with torch.no_grad():
            t.copy_(torch.as_tensor(np.asarray(value)).reshape(t.shape))

    def _init_zero(self, _, arr):
        self._fill(arr, 0.0)

    def _init_one(self, _, arr):
        self._fill(arr, 1.0)

    _init_bias = _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    def _init_default(self, desc, arr):
        raise MXNetError("Unknown initialization pattern for %s" % desc)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._fill(arr, 0.0)

    _init_default = _init_weight


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        self._fill(arr, 1.0)

    _init_default = _init_weight


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        self._fill(arr, float(self.value))

    _init_default = _init_weight


def _uniform_(arr, low, high):
    t = arr._data
    with torch.no_grad():
        t.uniform_(low, high, generator=_random.generator(t.device))


def _normal_(arr, sigma):
    t = arr._data
    with torch.no_grad():
        t.normal_(0.0, sigma, generator=_random.generator(t.device))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        _uniform_(arr, -self.scale, self.scale)

    _init_default = _init_weight


@register
class Normal(Initializer):
    """N(0, sigma^2) weights (VGG's Dense layers take it by name)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _normal_(arr, self.sigma)

    _init_default = _init_weight


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal matrix (rows or columns, whichever
    are fewer) from the SVD of a uniform or normal draw, reshaped to the
    weight's shape."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        t = arr._data
        nout, nin = arr.shape[0], int(np.prod(arr.shape[1:]))
        gen = _random.generator(t.device)
        tmp = torch.empty((nout, nin), device=t.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        with torch.no_grad():
            t.copy_((self.scale * q).reshape(t.shape))

    _init_default = _init_weight


@register
class Xavier(Initializer):
    """Defaults as the JAX package: uniform, 'avg' fan, magnitude 3."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError("Xavier requires ndim >= 2: %s %s"
                             % (desc, shape))
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale
        fan_out = shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _uniform_(arr, -scale, scale)
        elif self.rnd_type == "gaussian":
            _normal_(arr, scale)
        else:
            raise MXNetError("Unknown random type")

    _init_default = _init_weight


@register
class MSRAPrelu(Xavier):
    """Gaussian Xavier at magnitude 2 / (1 + slope^2) (He et al. for a
    PReLU of that slope)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernels for a (c, 1, k, k) deconvolution
    weight."""

    def _init_weight(self, _, arr):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        self._set(arr, weight.astype(np.float32).reshape(shape))

    _init_default = _init_weight


@register
class LSTMBias(Initializer):
    """Zero LSTM biases except the forget gate's, ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        b = np.zeros(arr.shape, dtype=np.float32)
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)

    _init_default = _init_weight


class Load:
    """Values from ``param`` (name -> NDArray or numpy array; ``arg:`` and
    ``aux:`` prefixes dropped), else ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {
            (k[4:] if k.startswith(("arg:", "aux:")) else k): v
            for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise MXNetError("shape mismatch for %s" % name)
            src = src.asnumpy() if hasattr(src, "asnumpy") else src
            Initializer._set(arr, src)
        else:
            if self.default_init is None:
                raise MXNetError("no initializer for %s" % name)
            self.default_init(name, arr)


class Mixed:
    """The initializer of the first pattern (a regular expression) that
    matches the name."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise MXNetError("no matching initializer pattern for %s" % name)


_INIT_ALIASES = {"zeros": "zero", "ones": "one", "gaussian": "normal"}


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    key = name.lower()
    key = _INIT_ALIASES.get(key, key)
    if key not in _INIT_REGISTRY:
        raise MXNetError("unknown initializer %r" % name)
    return _INIT_REGISTRY[key](**kwargs)
