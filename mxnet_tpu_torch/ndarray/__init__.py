"""mx.nd namespace: NDArray plus the operators the gluon slice calls
(parity: mxnet_tpu/ndarray/__init__.py; each op runs on torch tensors
through ``mxnet_tpu_torch.ops.nn``).  This module is also the ``F`` that
``hybrid_forward`` receives."""
from __future__ import annotations

import torch

from .ndarray import NDArray, array, zeros, ones, apply  # noqa: F401
from ..ops import nn as _nn

__all__ = ["NDArray", "array", "zeros", "ones", "FullyConnected",
           "Convolution", "Pooling", "Activation", "BatchNorm", "Flatten",
           "relu", "log_softmax", "pick", "mean"]


def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    return apply(_nn.fully_connected, data, weight,
                 None if no_bias else bias, flatten=flatten)


def Convolution(data, weight, bias=None, kernel=None, stride=(1, 1),
                dilate=(1, 1), pad=(0, 0), num_filter=None, num_group=1,
                no_bias=False, layout="NCHW"):
    if layout != "NCHW":
        raise ValueError("only the NCHW layout is ported")
    return apply(_nn.convolution, data, weight, None if no_bias else bias,
                 stride=stride, pad=pad, dilate=dilate, num_group=num_group)


def Pooling(data, kernel=(1, 1), pool_type="max", global_pool=False,
            stride=None, pad=(0, 0), pooling_convention="valid"):
    return apply(_nn.pooling, data, kernel=kernel, pool_type=pool_type,
                 global_pool=global_pool, stride=stride, pad=pad,
                 pooling_convention=pooling_convention)


def Activation(data, act_type="relu"):
    return apply(_nn.activation, data, act_type=act_type)


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              axis=1, training=False):
    """``(out, mean, var)``, see ``ops.nn.batch_norm``."""
    if axis != 1:
        raise ValueError("only channel axis 1 is ported")
    return apply(_nn.batch_norm, data, gamma, beta, moving_mean, moving_var,
                 eps=eps, fix_gamma=fix_gamma,
                 use_global_stats=use_global_stats, training=training)


def Flatten(data):
    return apply(lambda t: t.reshape(t.shape[0], -1), data)


def relu(data):
    return apply(torch.relu, data)


def log_softmax(data, axis=-1):
    return apply(_nn.log_softmax, data, axis=axis)


def pick(data, index, axis=-1, keepdims=False):
    return apply(_nn.pick, data, index, axis=axis, keepdims=keepdims)


def mean(data, axis=None, exclude=False, keepdims=False):
    """Mean over ``axis``, or over every other axis with ``exclude``."""
    if axis is None:
        return apply(torch.mean, data)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % data.ndim for a in axes)
    if exclude:
        axes = tuple(i for i in range(data.ndim) if i not in axes)
    if not axes:
        return data
    return apply(torch.mean, data, axes, keepdim=keepdims)
