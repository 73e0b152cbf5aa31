"""Activation rematerialization in the port's ShardedTrainer, held to
remat off and to the JAX package's trainer with the same policy, on CPU.

The small bottleneck ResNet of ``test_torch_sharded_trainer.py``
(ResNetV1(BottleneckV1, [1,1,1,1], [16,32,64,128,256], classes=10),
batch 4, 3x32x32) with a Dropout appended to its features trains 3 sgd
steps (lr 3e-5, momentum 0.9, wd 1e-4: the rate at which the two
packages' f32 runs agree, as that file's docstring explains):

- in the port, every policy gives losses, parameters and moving stats
  bit-equal to remat off, with the Dropout at rate 0.5: a recomputed
  region draws the same mask (``remat.py`` rewinds the framework
  generator) and pushes no moving stat twice;
- against the JAX package, each policy's losses agree at rtol 1e-5 and
  the parameters and moving stats within 1e-4 of each tensor's largest
  magnitude plus 1e-5 (that file's tolerance).  The two packages draw
  different dropout masks (JAX keys and ``torch.Generator`` never draw
  the same numbers), so this comparison runs with the Dropout at rate 0.

Remat is not a no-op: an aten-op count of one step under a
``TorchDispatchMode`` shows ``full`` running every convolution twice,
and ``dots_saveable`` each convolution once but its batch norms and
relus more often than remat off.
"""
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu import remat as jremat
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel as tparallel
from mxnet_tpu_torch import remat as tremat
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.name import NameManager as TNameManager

BATCH = 4
STEPS = 3
SGD = {"learning_rate": 3e-5, "momentum": 0.9, "wd": 1e-4}
POLICIES = ["full", "nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable", "everything_saveable",
            "offload_dots"]


def _data():
    rng = np.random.RandomState(0)
    xs = [rng.randn(BATCH, 3, 32, 32).astype(np.float32)
          for _ in range(STEPS)]
    ys = [rng.randint(0, 10, BATCH).astype(np.float32)
          for _ in range(STEPS)]
    return xs, ys


def _build(mx, vision, name_manager, rate):
    with name_manager():
        net = vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                              [16, 32, 64, 128, 256], classes=10)
    net.features.add(mx.gluon.nn.Dropout(rate))
    return net


def _params_agree(tparams, jparams):
    assert len(tparams) == len(jparams)
    for i, (t, j) in enumerate(zip(tparams, jparams)):
        err = np.abs(t - j).max()
        assert err <= 1e-4 * np.abs(j).max() + 1e-5, (i, err)


@pytest.fixture(scope="module")
def setup():
    xs, ys = _data()
    with jax.default_matmul_precision("float32"):
        net = _build(jmx, jvision, JNameManager, 0.0)
        jmx.random.seed(0)
        net.initialize(jmx.init.Xavier())
        net(jmx.nd.array(xs[0]))
        weights = {n: p.data().asnumpy().copy()
                   for n, p in net.collect_params().items()}
    return weights, xs, ys


def _jax_run(weights, xs, ys, policy):
    with jax.default_matmul_precision("float32"):
        net = _build(jmx, jvision, JNameManager, 0.0)
        net.initialize(jmx.init.Xavier())
        net(jmx.nd.array(xs[0]))
        for n, p in net.collect_params().items():
            p.set_data(jmx.nd.array(weights[n]))
        tr = jparallel.ShardedTrainer(
            net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
            optimizer_params=dict(SGD), remat_policy=policy)
        losses = [float(tr.step([jmx.nd.array(x)], jmx.nd.array(y)))
                  for x, y in zip(xs, ys)]
        return losses, [np.asarray(a).copy() for a in tr.param_arrays]


def _trainer(weights, policy, rate, **kw):
    net = _build(tmx, tvision, TNameManager, rate)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    tmx.convert.load_from_numpy(net, weights)
    return tparallel.ShardedTrainer(
        net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params=dict(SGD), remat_policy=policy, **kw)


def _torch_run(weights, xs, ys, policy, rate):
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        tmx.random.seed(3)
        tr = _trainer(weights, policy, rate)
        losses = [float(tr.step([tmx.nd.array(x, ctx=tmx.cpu())],
                                tmx.nd.array(y, ctx=tmx.cpu())))
                  for x, y in zip(xs, ys)]
        return losses, [a.clone() for a in tr.param_arrays]
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.fixture(scope="module")
def remat_off(setup):
    weights, xs, ys = setup
    return _torch_run(weights, xs, ys, None, 0.5)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_bit_equal_to_remat_off(setup, remat_off, policy):
    weights, xs, ys = setup
    losses, params = _torch_run(weights, xs, ys, policy, 0.5)
    assert losses == remat_off[0]
    assert all(torch.equal(a, b) for a, b in zip(params, remat_off[1]))
    # the steps trained and moved the moving stats
    assert not all(np.array_equal(a.numpy(), w)
                   for a, w in zip(params, weights.values()))


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax_trainer(setup, policy):
    weights, xs, ys = setup
    jl, jp = _jax_run(weights, xs, ys, policy)
    tl, tp = _torch_run(weights, xs, ys, policy, 0.0)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _params_agree([a.numpy() for a in tp], jp)


def test_policy_names_match_jax():
    assert tremat.list_policies() == jremat.list_policies()
    assert set(POLICIES) | {"none"} == set(tremat.list_policies())


@pytest.mark.parametrize("mod", [jremat, tremat], ids=["jax", "torch"])
def test_unknown_policy_raises(mod):
    with pytest.raises(ValueError, match="unknown remat_policy"):
        mod.resolve_policy("dots_everywhere")
    assert mod.resolve_policy("none") == (False, None)
    assert mod.resolve_policy("") == (False, None)


def test_unknown_policy_raises_at_each_entry_point(setup):
    weights, _, _ = setup
    with pytest.raises(ValueError):
        _trainer(weights, "dots_everywhere", 0.0)
    net = tmx.gluon.nn.Dense(3, in_units=4)
    with pytest.raises(ValueError):
        net.hybridize(remat_policy="dots_everywhere")
    with pytest.raises(ValueError):
        tmx.mod.Module(tmx.sym.var("data"), remat_policy="dots_everywhere")


def test_env_flag_is_the_default(setup, remat_off, monkeypatch):
    weights, xs, ys = setup
    monkeypatch.setenv("MXNET_REMAT_POLICY", "full")
    tr = _trainer(weights, None, 0.5)
    assert tr._remat and tr._remat_resolved.name == "full"
    assert tr._remat_segments is not None
    losses, params = _torch_run(weights, xs, ys, None, 0.5)
    assert losses == remat_off[0]
    assert all(torch.equal(a, b) for a, b in zip(params, remat_off[1]))
    # an explicit 'none' overrides the flag
    assert not _trainer(weights, "none", 0.5)._remat
    monkeypatch.setenv("MXNET_REMAT_POLICY", "no_such_policy")
    with pytest.raises(ValueError):
        _trainer(weights, None, 0.5)


def test_segments_are_the_outermost_sequential_children(setup):
    weights, _, _ = setup
    net = _build(tmx, tvision, TNameManager, 0.5)
    segs = tremat.segments(net)
    assert segs == list(net.features._children.values())
    assert tremat.segments(tmx.gluon.nn.Dense(2, in_units=2)) is None


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _count_step(weights, xs, ys, policy):
    tr = _trainer(weights, policy, 0.5)
    tr.step([tmx.nd.array(xs[0], ctx=tmx.cpu())],
            tmx.nd.array(ys[0], ctx=tmx.cpu()))
    with _OpCount() as count:
        tr.step([tmx.nd.array(xs[1], ctx=tmx.cpu())],
                tmx.nd.array(ys[1], ctx=tmx.cpu()))
    return count.ops


def test_remat_is_not_a_no_op(setup):
    weights, xs, ys = setup
    off = _count_step(weights, xs, ys, None)
    full = _count_step(weights, xs, ys, "full")
    dots = _count_step(weights, xs, ys, "dots_saveable")
    # the stem, and 3 convolutions and a downsample in each of 4 units
    assert off["convolution"] == 17
    assert full["convolution"] == 2 * off["convolution"]
    assert dots["convolution"] == off["convolution"]
    assert off["convolution_backward"] == dots["convolution_backward"] == \
        full["convolution_backward"]
    for op in ("native_batch_norm", "relu"):
        assert dots[op] > off[op], op
        assert full[op] > off[op], op


@pytest.mark.parametrize("policy", ["none"] + POLICIES)
def test_apply_remat_matches_jax(policy):
    """``apply_remat`` on a plain function: the same value and gradient as
    the JAX package's ``apply_remat`` of the same function, and the
    function itself when the policy is off."""
    rng = np.random.RandomState(4)
    w = rng.randn(6, 5).astype(np.float32)
    xv = rng.randn(3, 6).astype(np.float32)

    def tf(w_, x_):
        return (torch.tanh(x_ @ w_) ** 2).sum()

    def jf(w_, x_):
        return (jax.numpy.tanh(x_ @ w_) ** 2).sum()

    g = tremat.apply_remat(tf, policy)
    assert (g is tf) == (policy == "none")
    wt = torch.tensor(w, requires_grad=True)
    val = g(wt, torch.tensor(xv))
    val.backward()
    with jax.default_matmul_precision("float32"):
        jval, jgrad = jax.value_and_grad(jremat.apply_remat(jf, policy))(
            w, xv)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-6)
