"""Convolution and pooling layers of the slice (parity:
mxnet_tpu/gluon/nn/conv_layers.py — Conv2D, MaxPool2D, GlobalAvgPool2D)."""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation, _init_by_name

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _pair(v):
    if isinstance(v, int):
        return (v, v)
    return tuple(v)


class Conv2D(HybridBlock):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        kernel_size = _pair(kernel_size)
        self._kwargs = {
            "kernel": kernel_size, "stride": _pair(strides),
            "dilate": _pair(dilation), "pad": _pair(padding),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        self.weight = self.params.get(
            "weight", shape=(channels, in_channels // groups) + kernel_size,
            init=weight_initializer, allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get("bias", shape=(channels,),
                                        init=_init_by_name(bias_initializer),
                                        allow_deferred_init=True)
        else:
            self.bias = None
        if activation is not None:
            self.act = Activation(activation, prefix=activation + "_")
        else:
            self.act = None

    def _infer_param_shapes(self, x, *args):
        self.weight.shape = (self._channels,
                             x.shape[1] // self._kwargs["num_group"]) \
            + self._kwargs["kernel"]

    def hybrid_forward(self, F, x, weight, bias=None):
        act = F.Convolution(x, weight, bias, **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size),
                         None if strides is None else _pair(strides),
                         _pair(padding), ceil_mode, False, "max", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", **kwargs)
