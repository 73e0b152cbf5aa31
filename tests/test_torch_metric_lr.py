"""The port's ``metric`` and ``lr_scheduler`` modules against the JAX
package's on the same seeded numpy inputs: every registered metric (and
CompositeEvalMetric, CustomMetric, ``np``, ``create``), fed NDArrays of
each package, gives the same name and value (rtol 1e-6); the four
schedulers give the same rate at every update count, warmup included."""
import math

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _r(seed):
    return np.random.RandomState(seed)


def _classify(seed, n=12, k=4):
    p = _r(seed).rand(n, k).astype(np.float32)
    return _r(seed + 1).randint(0, k, n).astype(np.float32), \
        p / p.sum(axis=1, keepdims=True)


def _binary(seed, n=16):
    p = _r(seed).rand(n, 2).astype(np.float32)
    return _r(seed + 1).randint(0, 2, n).astype(np.float32), \
        p / p.sum(axis=1, keepdims=True)


def _regress(seed, n=10):
    return _r(seed).randn(n).astype(np.float32), \
        _r(seed + 1).randn(n, 1).astype(np.float32)


METRICS = [
    ("acc", {}, _classify),
    ("accuracy", {"axis": 1}, _classify),
    ("top_k_accuracy", {"top_k": 2}, _classify),
    ("f1", {}, _binary),
    ("mcc", {}, _binary),
    ("pcc", {}, _classify),
    ("perplexity", {}, _classify),
    ("perplexity", {"ignore_label": 1}, _classify),
    ("mae", {}, _regress),
    ("mse", {}, _regress),
    ("rmse", {}, _regress),
    ("ce", {}, _classify),
    ("nll_loss", {}, _classify),
    ("pearsonr", {}, _regress),
    ("loss", {}, _regress),
]


def _feed(pkg, metric, make, wrap):
    for seed in (0, 5):
        label, pred = make(seed)
        metric.update([wrap(label)], [wrap(pred)])
    return metric.get()


def _pair(name, kw, make):
    t = _feed(tmx, tmx.metric.create(name, **kw), make,
              lambda v: tmx.nd.array(v, ctx=tmx.cpu()))
    j = _feed(jmx, jmx.metric.create(name, **kw), make, jmx.nd.array)
    return t, j


def _same(t, j):
    assert t[0] == j[0]
    np.testing.assert_allclose(np.asarray(t[1], np.float64),
                               np.asarray(j[1], np.float64), rtol=1e-6)


@pytest.mark.parametrize("name, kw, make", METRICS,
                         ids=["%s-%d" % (m[0], i)
                              for i, m in enumerate(METRICS)])
def test_metric_matches_jax(name, kw, make):
    t, j = _pair(name, kw, make)
    _same(t, j)
    assert np.isfinite(t[1])


def test_every_registered_jax_metric_is_ported():
    assert sorted(tmx.metric._METRIC_REGISTRY) == \
        sorted(jmx.metric._METRIC_REGISTRY)


def test_composite_custom_and_np_metrics_match_jax():
    def feval(label, pred):
        return float(np.abs(label - pred.argmax(axis=1)).sum()), len(label)

    res = []
    for pkg, wrap in ((tmx, lambda v: tmx.nd.array(v, ctx=tmx.cpu())),
                      (jmx, jmx.nd.array)):
        comp = pkg.metric.create(["acc", "ce"])
        comp.add(pkg.metric.np(feval, name="dist"))
        comp.add(pkg.metric.CustomMetric(lambda l, p: float(p.max()),
                                         name="pmax"))
        label, pred = _classify(3)
        comp.update([wrap(label)], [wrap(pred)])
        comp.update_dict({"y": wrap(label)}, {"out": wrap(pred)})
        res.append(comp.get())
        comp.reset()
        assert math.isnan(comp.get()[1][0])
    assert res[0][0] == res[1][0]
    np.testing.assert_allclose(res[0][1], res[1][1], rtol=1e-6)


def test_metric_create_rejects_an_unknown_name():
    with pytest.raises(tmx.base.MXNetError):
        tmx.metric.create("no_such_metric")


SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.5, stop_factor_lr=1e-3,
                             base_lr=0.1)),
    ("FactorScheduler", dict(step=2, factor=0.9, base_lr=0.1,
                             warmup_steps=4, warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[3, 7, 11], factor=0.3,
                                  base_lr=0.2)),
    ("MultiFactorScheduler", dict(step=[5], factor=0.5, base_lr=0.2,
                                  warmup_steps=3, warmup_mode="constant",
                                  warmup_begin_lr=0.05)),
    ("PolyScheduler", dict(max_update=12, base_lr=0.1, pwr=2,
                           final_lr=0.001)),
    ("PolyScheduler", dict(max_update=12, base_lr=0.1, pwr=1,
                           warmup_steps=3)),
    ("CosineScheduler", dict(max_update=15, base_lr=0.1, final_lr=0.01)),
    ("CosineScheduler", dict(max_update=15, base_lr=0.1, warmup_steps=5,
                             warmup_begin_lr=0.02)),
]


@pytest.mark.parametrize("cls, kw", SCHEDULERS,
                         ids=["%s-%d" % (s[0], i)
                              for i, s in enumerate(SCHEDULERS)])
def test_scheduler_matches_jax(cls, kw):
    t = getattr(tmx.lr_scheduler, cls)(**kw)
    j = getattr(jmx.lr_scheduler, cls)(**kw)
    got = [t(n) for n in range(20)]
    want = [j(n) for n in range(20)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert len(set(got)) > 1


@pytest.mark.parametrize("cls, kw", [
    ("FactorScheduler", dict(step=0)),
    ("FactorScheduler", dict(step=2, factor=1.5)),
    ("MultiFactorScheduler", dict(step=[3, 2])),
    ("PolyScheduler", dict(max_update=0)),
    ("CosineScheduler", dict(max_update=5, base_lr=0.01,
                             warmup_begin_lr=0.1)),
])
def test_scheduler_rejects_what_jax_rejects(cls, kw):
    with pytest.raises(ValueError):
        getattr(jmx.lr_scheduler, cls)(**kw)
    with pytest.raises(ValueError):
        getattr(tmx.lr_scheduler, cls)(**kw)
