"""Parity of the port's dtype policies with the JAX package's, on CPU.

The port's ``dtype_policy`` against ``mxnet_tpu.dtype_policy`` function by
function: the registry and ``resolve_policy`` under
``MXNET_DTYPE_POLICY``, ``policy_tag``, the compute dtype of every
parameter of resnet50_v1 (trainable and moving stats) under each
built-in, the dynamic loss-scale state over a scripted sequence of
~3000 finite and overflowed steps (exactly equal at every step), and
``harmonize``.  Dtypes are compared by name.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu import dtype_policy as jdtp
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.name import NameManager as JNameManager

from mxnet_tpu_torch import dtype_policy as tdtp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.name import NameManager as TNameManager

BUILTINS = ("f32", "bf16_mixed", "bf16_pure")


def _name(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


def test_builtins_registered_alike():
    assert set(BUILTINS) <= set(tdtp.list_policies())
    assert set(BUILTINS) <= set(jdtp.list_policies())
    for name in BUILTINS:
        t, j = tdtp.get_policy(name), jdtp.get_policy(name)
        assert (_name(t.compute_dtype), _name(t.param_dtype),
                t.loss_scaling) == (_name(j.compute_dtype),
                                    _name(j.param_dtype), j.loss_scaling)
        assert [(r.name, r.pattern, _name(r.dtype)) for r in t.rules] == \
            [(r.name, r.pattern, _name(r.dtype)) for r in j.rules]
        assert (None if t.cast_outputs is None else
                _name(t.cast_outputs)) == \
            (None if j.cast_outputs is None else _name(j.cast_outputs))


@pytest.mark.parametrize("env", [None, "", "f32", "bf16_mixed", "bf16_pure"])
def test_resolve_policy_under_env(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("MXNET_DTYPE_POLICY", raising=False)
    else:
        monkeypatch.setenv("MXNET_DTYPE_POLICY", env)
    t, j = tdtp.resolve_policy(None), jdtp.resolve_policy(None)
    assert (t is None) == (j is None)
    if j is not None:
        assert t.name == j.name == env
    assert tdtp.policy_tag(t) == jdtp.policy_tag(j)


def test_resolve_policy_explicit_and_unknown(monkeypatch):
    for spec in ("f32", "", False, "off", "none"):
        assert tdtp.resolve_policy(spec) is None
        assert jdtp.resolve_policy(spec) is None
    assert tdtp.resolve_policy(tdtp.get_policy("f32")) is None
    pure = tdtp.get_policy("bf16_pure")
    assert tdtp.resolve_policy(pure) is pure
    monkeypatch.setenv("MXNET_DTYPE_POLICY", "bogus")
    with pytest.raises(MXNetError, match="unknown dtype policy"):
        tdtp.resolve_policy(None)
    with pytest.raises(JMXNetError, match="unknown dtype policy"):
        jdtp.resolve_policy(None)
    with pytest.raises(MXNetError, match="must be a DtypePolicy"):
        tdtp.resolve_policy(3)


@pytest.mark.parametrize("name", BUILTINS + (None,))
def test_policy_tag(name):
    t = None if name is None else tdtp.get_policy(name)
    j = None if name is None else jdtp.get_policy(name)
    assert tdtp.policy_tag(t) == jdtp.policy_tag(j) == (name or "f32")


def test_register_policy_rejects_duplicates():
    with pytest.raises(MXNetError, match="already registered"):
        tdtp.register_policy(tdtp.DtypePolicy("bf16_mixed", "bfloat16"))
    with pytest.raises(MXNetError, match="takes a DtypePolicy"):
        tdtp.register_policy("bf16_mixed")


@pytest.fixture(scope="module")
def resnet50_params():
    """(name, shape) of every resnet50_v1 parameter in both packages."""
    with JNameManager():
        jnet = jvision.resnet50_v1(classes=1000)
    with TNameManager():
        tnet = tvision.resnet50_v1(classes=1000)
    jp = [(n, tuple(p.shape or ())) for n, p in
          jnet.collect_params().items()]
    tp = [(n, tuple(p.shape or ())) for n, p in
          tnet.collect_params().items()]
    return jp, tp


@pytest.mark.parametrize("policy", BUILTINS)
def test_resnet50_compute_dtype_per_parameter(resnet50_params, policy):
    jp, tp = resnet50_params
    assert [n for n, _ in tp] == [n for n, _ in jp]
    assert len(jp) == 299  # 193 trainable + 2 moving stats x 53 BatchNorms
    t, j = tdtp.get_policy(policy), jdtp.get_policy(policy)
    tdt = {n: _name(t.param_cast_dtype(n, s)) for n, s in tp}
    jdt = {n: _name(j.param_cast_dtype(n, s)) for n, s in jp}
    assert tdt == jdt
    assert {n: t.rule_name(n, s) for n, s in tp} == \
        {n: j.rule_name(n, s) for n, s in jp}
    if policy == "bf16_mixed":
        # BatchNorm's gamma/beta and moving stats stay f32; every conv
        # and the dense head compute in bf16
        f32 = sorted(n for n, d in jdt.items() if d == "float32")
        assert len(f32) == 4 * 53
        assert all("batchnorm" in n for n in f32)
        assert all("batchnorm" not in n for n, d in jdt.items()
                   if d == "bfloat16")


def test_cast_rule_rank_filters_and_describe():
    pairs = [(tdtp.CastRule("r", r"_w$", "float32", rank=2),
              jdtp.CastRule("r", r"_w$", "float32", rank=2)),
             (tdtp.CastRule("m", r"_w$", "float32", min_rank=3),
              jdtp.CastRule("m", r"_w$", "float32", min_rank=3))]
    for t, j in pairs:
        for name, shape in (("a_w", (2, 2)), ("a_w", (2,)),
                            ("a_w", (2, 2, 2)), ("a_w", None),
                            ("a_x", (2, 2))):
            assert t.matches(name, shape) == j.matches(name, shape)
    t = tdtp.get_policy("bf16_mixed")
    desc = t.describe([("batchnorm0_gamma", (8,)), ("dense0_weight", (4, 8))])
    assert "norm_f32" in desc and "bfloat16" in desc


def _scripted_keeps():
    """~3000 steps: long finite streaks, single overflows, and a run of
    25 overflows in a row that takes the scale to its floor."""
    keep = np.ones(3000, bool)
    keep[[0, 7, 8, 1999, 2001, 2600]] = False
    keep[100:125] = False
    rng = np.random.RandomState(0)
    keep[2700:] = rng.rand(300) > 0.05
    return keep


@pytest.mark.parametrize("interval", [2000, 3])
def test_loss_scale_sequence_matches_jax_exactly(interval):
    kw = {"init": 65536.0, "growth_interval": interval, "backoff": 0.5,
          "max_scale": 2.0 ** 24}
    tcfg, jcfg = tdtp.LossScaleConfig(**kw), jdtp.LossScaleConfig(**kw)
    jupdate = jax.jit(lambda s, k: jdtp.loss_scale_update(s, k, jcfg))
    ts = tdtp.init_loss_scale(tcfg)
    js = jnp.asarray(jdtp.init_loss_scale(jcfg))
    assert ts.tolist() == np.asarray(js).tolist() == [65536.0, 0.0]
    seen = set()
    for keep in _scripted_keeps():
        ts = tdtp.loss_scale_update(ts, torch.tensor(bool(keep)), tcfg)
        js = jupdate(js, jnp.bool_(keep))
        assert ts.dtype == torch.float32
        assert ts.tolist() == np.asarray(js).tolist()
        seen.add(float(ts[0]))
    # the sequence reached the floor, and with interval 3 the cap
    assert 1.0 in seen
    if interval == 3:
        assert 2.0 ** 24 in seen


def test_loss_scale_config_defaults_from_env(monkeypatch):
    t, j = tdtp.LossScaleConfig(), jdtp.LossScaleConfig()
    assert (t.init, t.growth_interval, t.backoff, t.max_scale) == \
        (j.init, j.growth_interval, j.backoff, j.max_scale) == \
        (65536.0, 2000, 0.5, 2.0 ** 24)
    monkeypatch.setenv("MXNET_LOSS_SCALE", "1024")
    monkeypatch.setenv("MXNET_LOSS_SCALE_GROWTH_INTERVAL", "7")
    assert (tdtp.LossScaleConfig().init,
            tdtp.LossScaleConfig().growth_interval) == (1024.0, 7)
    with pytest.raises(MXNetError, match="invalid loss-scale config"):
        tdtp.LossScaleConfig(backoff=1.5)


def test_harmonize_follows_weight_only_in_scope():
    x = torch.ones(2, 2)
    w = torch.ones(2, 2, dtype=torch.bfloat16)
    jx = jnp.ones((2, 2), jnp.float32)
    jw = jnp.ones((2, 2), jnp.bfloat16)
    assert tdtp.current_policy() is None
    assert tdtp.harmonize(x, w) is x  # no scope: the identity
    assert jdtp.harmonize(jx, jw).dtype == jnp.float32
    mixed = tdtp.get_policy("bf16_mixed")
    with tdtp.scope(mixed), jdtp.scope(jdtp.get_policy("bf16_mixed")):
        assert tdtp.current_policy() is mixed
        assert _name(tdtp.harmonize(x, w).dtype) == \
            _name(jdtp.harmonize(jx, jw).dtype) == "bfloat16"
        # non-float weights never harmonize
        i8 = torch.ones(2, 2, dtype=torch.int8)
        assert tdtp.harmonize(x, i8) is x
        assert jdtp.harmonize(jx, jnp.ones((2, 2), jnp.int8)).dtype == \
            jnp.float32
    assert tdtp.current_policy() is None
    with tdtp.scope(None):
        assert tdtp.harmonize(x, w) is x


def test_cast_compute_and_cast_output():
    mixed = tdtp.get_policy("bf16_mixed")
    w = torch.ones(4, 3)
    assert mixed.cast_compute("dense0_weight", w).dtype == torch.bfloat16
    assert mixed.cast_compute("batchnorm0_gamma", w) is w
    assert mixed.cast_compute("idx", torch.ones(3, dtype=torch.int64)) \
        .dtype == torch.int64
    assert mixed.cast_output(w.bfloat16()).dtype == torch.float32
    assert tdtp.get_policy("bf16_pure").cast_output(w.bfloat16()).dtype == \
        torch.bfloat16
