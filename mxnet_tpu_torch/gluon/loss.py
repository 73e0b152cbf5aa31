"""Gluon losses of the slice (parity: mxnet_tpu/gluon/loss.py Loss,
SoftmaxCrossEntropyLoss)."""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


class Loss(HybridBlock):
    """Per-element loss, then ``sample_weight``, ``weight`` and a mean over
    every axis except ``batch_axis`` (one value per sample)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _finalize(self, F, raw, sample_weight):
        if sample_weight is not None:
            raw = raw * sample_weight
        if self._weight is not None:
            raw = raw * self._weight
        return F.mean(raw, axis=self._batch_axis, exclude=True)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy on logits; sparse (class-index) labels only."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if not sparse_label:
            raise NotImplementedError("dense labels are not ported yet")
        self._axis = axis
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits else \
            F.log_softmax(pred, axis=self._axis)
        raw = -F.pick(logp, label, axis=self._axis, keepdims=True)
        return self._finalize(F, raw, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
