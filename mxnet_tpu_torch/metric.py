"""Evaluation metrics (parity: mxnet_tpu/metric.py:19-493; the reference
python/mxnet/metric.py:68-1662).  Each ``update`` copies each label and
prediction to the host once (a tensor on the card: one device-to-host
copy) and computes in numpy, as the JAX module does."""
from __future__ import annotations

import math

import numpy

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "check_label_shapes"]

_METRIC_REGISTRY = {}


def register(*names):
    """Class decorator: register a metric under ``names`` (default its
    lower-cased class name) for ``create``."""
    def _reg(klass):
        for n in names or (klass.__name__.lower(),):
            _METRIC_REGISTRY[n.lower()] = klass
        return klass

    return _reg


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if not shape:
        lshape, pshape = len(labels), len(preds)
    else:
        lshape, pshape = labels.shape, preds.shape
    if lshape != pshape:
        raise ValueError("Shape of labels %s does not match shape of "
                         "predictions %s" % (lshape, pshape))
    if wrap:
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
    return labels, preds


def _as_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) if isinstance(m, str) else m
                        for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str) else metric)

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, numpy.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


@register("acc", "accuracy")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            pred_np = _as_np(pred_label)
            label_np = _as_np(label)
            # reference: argmax whenever pred and label shapes differ
            # (python/mxnet/metric.py Accuracy.update)
            if pred_np.shape != label_np.shape:
                pred_np = numpy.argmax(pred_np, axis=self.axis)
            label_np = label_np.astype("int32").flat
            pred_np = pred_np.astype("int32").flat
            n = min(len(label_np), len(pred_np))
            self.sum_metric += (numpy.asarray(pred_np[:n]) ==
                                numpy.asarray(label_np[:n])).sum()
            self.num_inst += n


@register("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            pred_np = _as_np(pred_label)
            label_np = _as_np(label).astype("int32")
            sorted_pred = numpy.argsort(pred_np.astype("float32"), axis=-1)
            num_samples = pred_np.shape[0]
            num_classes = pred_np.shape[-1] if pred_np.ndim > 1 else 1
            top_k = min(num_classes, self.top_k)
            for j in range(top_k):
                self.sum_metric += (
                    sorted_pred[:, num_classes - 1 - j].flat ==
                    label_np.flat).sum()
            self.num_inst += num_samples


@register("f1")
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        super().reset()
        self.reset_stats()

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            pred_np = _as_np(pred)
            label_np = _as_np(label).astype("int32")
            if pred_np.ndim > 1:
                pred_np = numpy.argmax(pred_np, axis=-1)
            pred_np = pred_np.astype("int32").reshape(-1)
            label_np = label_np.reshape(-1)
            self._tp += float(((pred_np == 1) & (label_np == 1)).sum())
            self._fp += float(((pred_np == 1) & (label_np == 0)).sum())
            self._fn += float(((pred_np == 0) & (label_np == 1)).sum())
            prec = self._tp / max(self._tp + self._fp, 1e-12)
            rec = self._tp / max(self._tp + self._fn, 1e-12)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register("mcc")
class MCC(EvalMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self._stats = [0.0, 0.0, 0.0, 0.0]  # tp, fp, fn, tn

    def reset(self):
        super().reset()
        self._stats = [0.0, 0.0, 0.0, 0.0]

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            pred_np = _as_np(pred)
            if pred_np.ndim > 1:
                pred_np = numpy.argmax(pred_np, axis=-1)
            pred_np = pred_np.astype("int32").reshape(-1)
            label_np = _as_np(label).astype("int32").reshape(-1)
            self._stats[0] += float(((pred_np == 1) & (label_np == 1)).sum())
            self._stats[1] += float(((pred_np == 1) & (label_np == 0)).sum())
            self._stats[2] += float(((pred_np == 0) & (label_np == 1)).sum())
            self._stats[3] += float(((pred_np == 0) & (label_np == 0)).sum())
            tp, fp, fn, tn = self._stats
            denom = math.sqrt(max((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn),
                                  1e-12))
            self.sum_metric = (tp * tn - fp * fn) / denom
            self.num_inst = 1


@register("perplexity")
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label_np = _as_np(label).astype("int32").reshape(-1)
            pred_np = _as_np(pred).reshape(len(label_np), -1)
            probs = pred_np[numpy.arange(len(label_np)), label_np]
            if self.ignore_label is not None:
                ignore = (label_np == self.ignore_label)
                probs = numpy.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += len(label_np)
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _as_np(label)
            pred_np = _as_np(pred)
            if label_np.ndim == 1:
                label_np = label_np.reshape(label_np.shape[0], 1)
            if pred_np.ndim == 1:
                pred_np = pred_np.reshape(pred_np.shape[0], 1)
            self.sum_metric += numpy.abs(label_np - pred_np).mean()
            self.num_inst += 1


@register("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _as_np(label)
            pred_np = _as_np(pred)
            if label_np.ndim == 1:
                label_np = label_np.reshape(label_np.shape[0], 1)
            if pred_np.ndim == 1:
                pred_np = pred_np.reshape(pred_np.shape[0], 1)
            self.sum_metric += ((label_np - pred_np) ** 2.0).mean()
            self.num_inst += 1


@register("rmse")
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register("ce", "cross-entropy")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _as_np(label).ravel().astype("int32")
            pred_np = _as_np(pred)
            assert label_np.shape[0] == pred_np.shape[0]
            prob = pred_np[numpy.arange(label_np.shape[0]), label_np]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label_np.shape[0]


@register("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names, eps=eps)
        self.eps = eps


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label_np = _as_np(label).ravel()
            pred_np = _as_np(pred).ravel()
            self.sum_metric += numpy.corrcoef(pred_np, label_np)[0, 1]
            self.num_inst += 1


@register("pcc")
class PCC(EvalMetric):
    """Multiclass Matthews/Pearson correlation from a growing KxK
    confusion matrix (reference: python/mxnet/metric.py:1480 PCC).

    For K=2 this equals MCC; for K>2 the minimum is distribution-
    dependent in (-1, 0] while the maximum stays +1."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        self.k = 2
        super().__init__(name, output_names, label_names)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.lcm = numpy.zeros((self.k, self.k))

    def _grow(self, inc):
        self.lcm = numpy.pad(self.lcm, ((0, inc), (0, inc)), "constant")
        self.k += inc

    @staticmethod
    def _calc_mcc(cmat):
        n = cmat.sum()
        x = cmat.sum(axis=1)
        y = cmat.sum(axis=0)
        cov_xx = numpy.sum(x * (n - x))
        cov_yy = numpy.sum(y * (n - y))
        if cov_xx == 0 or cov_yy == 0:
            return float("nan")
        i = cmat.diagonal()
        cov_xy = numpy.sum(i * n - x * y)
        return cov_xy / (cov_xx * cov_yy) ** 0.5

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            pred_np = _as_np(pred)
            if pred_np.ndim > 1:
                pred_np = numpy.argmax(pred_np, axis=-1)
            pred_np = pred_np.astype("int32").reshape(-1)
            label_np = _as_np(label).astype("int32").reshape(-1)
            n = int(max(pred_np.max(), label_np.max())) + 1
            if n > self.k:
                self._grow(n - self.k)
            numpy.add.at(self.lcm, (label_np, pred_np), 1)
            self.num_inst += pred_np.shape[0]

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self._calc_mcc(self.lcm))


@register("loss")
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            pred_np = _as_np(pred)
            self.sum_metric += pred_np.sum()
            self.num_inst += pred_np.size


class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register("custommetric")
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            label_np = _as_np(label)
            pred_np = _as_np(pred)
            reval = self._feval(label_np, pred_np)
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, CompositeEvalMetric):
        return metric
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str) and metric.lower() in _METRIC_REGISTRY:
        return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
    raise MXNetError("metric %r not registered" % (metric,))
