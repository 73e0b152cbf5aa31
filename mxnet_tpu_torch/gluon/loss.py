"""Gluon losses (parity: mxnet_tpu/gluon/loss.py:68-305; reference
python/mxnet/gluon/loss.py).

The ``Loss`` base class owns the weighting, ``sample_weight`` and batch
reduction (``_finalize``); each loss states its per-element formula over
``F``.  ``CTCLoss`` runs the ``CTCLoss`` op with blank label 'last', as
the JAX loss does.
"""
from __future__ import annotations

import math

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]

_EPS = 1e-12


def _softplus_neg_abs(F, z):
    # log(1 + exp(-|z|)): the numerically-safe half of log-sigmoid.
    return F.Activation(-F.abs(z), act_type="softrelu")


def _match(F, ref, like):
    # Shape a label/target tensor to the prediction's layout.
    return ref.reshape(like.shape)


class Loss(HybridBlock):
    """Base class: computes per-element loss, then weights and reduces.

    Subclasses implement :meth:`hybrid_forward` and hand their raw
    per-element tensor to :meth:`_finalize`, which applies (in order)
    the optional ``sample_weight`` mask, the scalar ``weight``, and a
    mean over every axis except ``batch_axis``.
    """

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (
            type(self).__name__, self._batch_axis, self._weight)

    def _finalize(self, F, raw, sample_weight, scale=None, reduce=True):
        """``sample_weight`` (broadcast), then ``scale`` (default the
        loss's ``weight``), then, unless ``reduce`` is False, the mean
        over every axis except ``batch_axis``."""
        if sample_weight is not None:
            raw = F.broadcast_mul(raw, sample_weight)
        scale = self._weight if scale is None else scale
        if scale is not None:
            raw = raw * scale
        if not reduce:
            return raw
        return F.mean(raw, axis=self._batch_axis, exclude=True)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """0.5 * weight * (pred - label)^2, mean over non-batch axes."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        diff = pred - _match(F, label, pred)
        return self._finalize(F, F.square(diff), sample_weight,
                              scale=self._weight / 2)


class L1Loss(Loss):
    """|pred - label|, mean over non-batch axes."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        return self._finalize(F, F.abs(pred - _match(F, label, pred)),
                              sample_weight)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """BCE on logits (default) or on probabilities (``from_sigmoid=True``)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _match(F, label, pred)
        if self._from_sigmoid:
            log_p = F.log(pred + _EPS)
            log_1mp = F.log(1. - pred + _EPS)
            if pos_weight is None:
                raw = -(label * log_p + (1. - label) * log_1mp)
            else:
                raw = -(F.broadcast_mul(label * log_p, pos_weight)
                        + (1. - label) * log_1mp)
        else:
            # max(z,0) - z*y + log(1+exp(-|z|)) — the standard stable form.
            tail = _softplus_neg_abs(F, pred)
            if pos_weight is None:
                raw = F.relu(pred) - pred * label + tail
            else:
                boosted = 1 + F.broadcast_mul(pos_weight - 1, label)
                raw = pred - pred * label + boosted * (tail + F.relu(-pred))
        return self._finalize(F, raw, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax-CE on logits; sparse (class-index) or dense labels."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits else \
            F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            raw = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            raw = -F.sum(logp * _match(F, label, logp), axis=self._axis,
                         keepdims=True)
        return self._finalize(F, raw, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """KL(label || softmax(pred)); pred is log-prob when ``from_logits``."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logq = pred if self._from_logits else \
            F.log_softmax(pred, axis=self._axis)
        raw = label * (F.log(label + _EPS) - logq)
        return self._finalize(F, raw, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification over the fused CTC op."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError("layout must be NTC or TNC, got %s" % layout)
        if label_layout not in ("NT", "TN"):
            raise ValueError("label_layout must be NT or TN, got %s"
                             % label_layout)
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.index("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._label_layout == "TN":
            label = F.swapaxes(label, dim1=0, dim2=1)
        raw = F.CTCLoss(pred, label,
                        data_lengths=pred_lengths,
                        label_lengths=label_lengths,
                        use_data_lengths=pred_lengths is not None,
                        use_label_lengths=label_lengths is not None,
                        blank_label="last")
        return self._finalize(F, raw, sample_weight, reduce=False)


class HuberLoss(Loss):
    """Quadratic within ``rho`` of the target, linear beyond it."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        err = F.abs(pred - _match(F, label, pred))
        quad = F.square(err) * (0.5 / self._rho)
        lin = err - 0.5 * self._rho
        return self._finalize(F, F.where(err > self._rho, lin, quad),
                              sample_weight)


class HingeLoss(Loss):
    """max(0, margin - pred*label) for signed labels."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        gap = F.relu(self._margin - pred * _match(F, label, pred))
        return self._finalize(F, gap, sample_weight)


class SquaredHingeLoss(Loss):
    """max(0, margin - pred*label)^2 for signed labels."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        gap = F.relu(self._margin - pred * _match(F, label, pred))
        return self._finalize(F, F.square(gap), sample_weight)


class LogisticLoss(Loss):
    """log(1 + exp(-pred*label)); labels signed (±1) or binary (0/1)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format must be signed or binary, got %s"
                             % label_format)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _match(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) * 0.5        # map {-1,1} -> {0,1}
        raw = F.relu(pred) - pred * label + _softplus_neg_abs(F, pred)
        return self._finalize(F, raw, sample_weight)


class TripletLoss(Loss):
    """max(0, margin + d(anchor,pos)^2 - d(anchor,neg)^2)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative):
        d_pos = F.square(_match(F, positive, pred) - pred)
        d_neg = F.square(_match(F, negative, pred) - pred)
        gap = F.sum(d_pos - d_neg, axis=self._batch_axis, exclude=True)
        return self._finalize(F, F.relu(gap + self._margin), None,
                              reduce=False)


class PoissonNLLLoss(Loss):
    """Poisson negative log likelihood; mean over ALL elements."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = _match(F, target, pred)
        if self._from_logits:
            raw = F.exp(pred) - target * pred
        else:
            raw = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            # Stirling correction for targets > 1.
            stirling = (target * F.log(target) - target
                        + 0.5 * F.log(2 * math.pi * target))
            raw = raw + stirling * (target > 1)
        raw = self._finalize(F, raw, sample_weight, reduce=False)
        return F.mean(raw)


class CosineEmbeddingLoss(Loss):
    """1 - cos(a,b) when label==1, else max(0, cos(a,b) - margin)."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        a = _match(F, input1, input2)
        dot = F.sum(a * input2, axis=-1).reshape((-1, 1))
        norms = (F.norm(a, axis=-1) * F.norm(input2, axis=-1)).reshape((-1, 1))
        cos = dot / F.broadcast_maximum(norms, norms * 0 + _EPS)
        label = label.reshape((-1, 1))
        raw = F.where(label == 1, 1 - cos, F.relu(cos - self._margin))
        return self._finalize(F, raw, sample_weight, reduce=False)
