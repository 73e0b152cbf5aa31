"""Weight initializers (parity: mxnet_tpu/initializer.py,
python/mxnet/initializer.py).  Random draws come from the explicit
per-device generator in ``mxnet_tpu_torch.random``."""
from __future__ import annotations

import math

import torch

from .base import MXNetError
from . import random as _random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "create", "register"]

_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """Name descriptor handed to initializers."""

    def __new__(cls, name, attrs=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        return ret


class Initializer:
    """Dispatches on the parameter name's suffix, as the reference does."""

    def __call__(self, desc, arr):
        name = str(desc).lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias") or name.endswith("beta"):
            self._init_zero(desc, arr)
        elif name.endswith("gamma"):
            self._init_one(desc, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(desc, arr)
        else:
            self._init_default(desc, arr)

    @staticmethod
    def _fill(arr, value):
        with torch.no_grad():
            arr._data.fill_(value)

    def _init_zero(self, _, arr):
        self._fill(arr, 0.0)

    def _init_one(self, _, arr):
        self._fill(arr, 1.0)

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
        self.value = value

    def _init_weight(self, _, arr):
        self._fill(arr, float(self.value))

    _init_default = _init_weight


def _uniform_(arr, low, high):
    t = arr._data
    with torch.no_grad():
        t.uniform_(low, high, generator=_random.generator(t.device))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, _, arr):
        _uniform_(arr, -self.scale, self.scale)

    _init_default = _init_weight


@register
class Normal(Initializer):
    """N(0, sigma^2) weights (VGG's Dense layers take it by name)."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, _, arr):
        t = arr._data
        with torch.no_grad():
            t.normal_(0.0, self.sigma, generator=_random.generator(t.device))

    _init_default = _init_weight


@register
class Xavier(Initializer):
    """Defaults as the JAX package: uniform, 'avg' fan, magnitude 3."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
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
            t = arr._data
            with torch.no_grad():
                t.normal_(0.0, scale, generator=_random.generator(t.device))
        else:
            raise MXNetError("Unknown random type")

    _init_default = _init_weight


_INIT_ALIASES = {"zeros": "zero", "ones": "one"}


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    key = name.lower()
    key = _INIT_ALIASES.get(key, key)
    if key not in _INIT_REGISTRY:
        raise MXNetError("initializer %r is not ported" % name)
    return _INIT_REGISTRY[key](**kwargs)
