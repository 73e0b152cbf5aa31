"""Advanced activations (parity: mxnet_tpu/gluon/nn/activations.py:19-88):
blocks over the one LeakyReLU family op, whose ``act_type`` selects the
function, plus Swish."""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


_REQUIRED = object()


def _slope_block(cls_name, act_type, default_slope, check=None,
                 show_repr=False):
    """A HybridBlock class whose forward is the LeakyReLU-family op with a
    fixed ``act_type`` and a stored slope; ``default_slope=_REQUIRED``
    makes alpha mandatory (the reference's LeakyReLU signature)."""

    def __init__(self, alpha=default_slope, **kwargs):
        if alpha is _REQUIRED:
            raise TypeError("%s requires the alpha (slope) argument"
                            % cls_name)
        if check:
            check(alpha)
        HybridBlock.__init__(self, **kwargs)
        self._slope = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type=act_type, slope=self._slope)

    ns = {"__init__": __init__, "hybrid_forward": hybrid_forward}
    if show_repr:
        ns["__repr__"] = lambda self: "%s(%s)" % (cls_name, self._slope)
    return type(cls_name, (HybridBlock,), ns)


def _require_nonneg(alpha):
    if alpha < 0:
        raise ValueError("LeakyReLU slope must be >= 0, got %s" % alpha)


LeakyReLU = _slope_block("LeakyReLU", "leaky", _REQUIRED,
                         check=_require_nonneg, show_repr=True)
ELU = _slope_block("ELU", "elu", 1.0)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class PReLU(HybridBlock):
    """Leaky ReLU whose slope is a learned parameter (one value)."""

    def __init__(self, alpha_initializer=None, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer

        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=alpha_initializer or initializer.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class Swish(HybridBlock):
    """x * sigmoid(beta x)."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
