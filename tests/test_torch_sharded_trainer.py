"""Parity of the port's ShardedTrainer with the JAX package's, on CPU.

The small bottleneck ResNet v1 of ``test_torch_resnet_train.py``
(ResNetV1(BottleneckV1, [1,1,1,1], [16,32,64,128,256], classes=10),
batch 4, 3x32x32) trains in both packages from the same numpy weights and
data, through ``parallel.ShardedTrainer``:

(a) f32, 4 steps on 4 batches, sgd (lr 3e-5, momentum 0.9, wd 1e-4, with
    the non-finite guard on) and adam (lr 1e-4, epsilon 1e-3, wd 1e-4):
    losses at rtol 1e-5; params and moving stats within 1e-4 of the
    tensor's largest magnitude plus 1e-5 (the argument of
    ``test_torch_resnet_train.py``: XLA and torch sum in different orders,
    and near-zero elements cannot carry an elementwise rtol);
(b) ``step_many`` of 3 steps: bit for bit equal to 3 ``step`` calls in the
    port, and within (a)'s tolerance of the JAX package's ``step_many``;
(c) the non-finite guard: a NaN batch under ``on_nonfinite="skip"``
    leaves every buffer as it was and counts one skip in both packages;
    ``"raise"`` raises ``NonfiniteError`` in the step, and under
    ``async_metrics`` at the next ``step`` or ``drain``;
(d) ``bf16_mixed``: the output dtype of every Conv2D, Dense and BatchNorm
    block equals the JAX package's (hooks on the same blocks; the JAX
    hooks fire while its step is traced), the losses of the kept steps
    agree within the bf16 tolerance below, and an inf in the batch at
    step 2 backs the loss scale off to the same ``[scale, good_steps]``
    as the JAX package's, with one skip and the state unchanged;
(e) the constructor's errors.

Why these learning rates.  The net is ill-conditioned at this size: its
last stage normalizes over 4 values per channel (1x1 maps, batch 4), and
its first conv's gradients reach ~25 against weights of ~0.1.  At lr
1e-3 the f32 sgd losses of either package leave a float64 run of the
port by more than 1e-5 within four steps, and at lr 3e-5 both stay
within it (``test_f32_sgd_tracks_float64_only_at_small_rates``), so rtol
1e-5 between the packages holds only at such rates.
Adam's default epsilon 1e-8 turns the f32 noise of the gradients of the
bottleneck convs' biases (each feeds a BatchNorm, so its exact gradient is
0) into full steps of random sign; epsilon 1e-3 is far above that noise
and far below the other gradients.  The update rules themselves are held
to the JAX package's at larger rates and with weight decay on random
tensors (``test_sgd_update_rule_matches_jax``,
``test_adam_update_rule_matches_jax``).

bf16 tolerance: rtol 0.1 on the losses.  The port rounds each op's result
to bf16 as cuDNN does on the card; XLA on the CPU keeps elementwise chains
in f32 (excess precision), so the JAX package's bf16 losses sit much
closer to its f32 ones than the port's do.  Over the steps here the two
packages' bf16 losses are a few percent apart, as far as the JAX
package's own bf16 and f32 losses are from each other.
"""
import inspect

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.checkpoint import NonfiniteError as JNonfiniteError
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.name import NameManager as JNameManager
from mxnet_tpu.parallel import train as jtrain

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import parallel as tparallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import NonfiniteError
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.name import NameManager as TNameManager
from mxnet_tpu_torch.parallel import train as ttrain

BATCH = 4
STEPS = 4
K = 3
SGD = {"learning_rate": 3e-5, "momentum": 0.9, "wd": 1e-4}
ADAM = {"learning_rate": 1e-4, "epsilon": 1e-3, "wd": 1e-4}
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 0.1
HOOKED = ("Conv2D", "Dense", "BatchNorm")


def _data():
    rng = np.random.RandomState(0)
    xs = [rng.randn(BATCH, 3, 32, 32).astype(np.float32)
          for _ in range(STEPS)]
    ys = [rng.randint(0, 10, BATCH).astype(np.float32) for _ in range(STEPS)]
    return xs, ys


def _poisoned(x, value):
    out = x.copy()
    out[0, 0, 0, 0] = value
    return out


def _build(vision, name_manager):
    with name_manager():
        return vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                               [16, 32, 64, 128, 256], classes=10)


def _hook_dtypes(net, seen, name_of):
    """Record the first output dtype of every Conv2D/Dense/BatchNorm."""
    def hook(block, args, out):
        seen.setdefault(block.name, name_of(out._data.dtype))

    def walk(block):
        for child in block._children.values():
            walk(child)
        if type(block).__name__ in HOOKED:
            block.register_forward_hook(hook)
    walk(net)


# ---------------------------------------------------------------------------
# the JAX package's runs
# ---------------------------------------------------------------------------

def _jnet(weights, x0):
    net = _build(jvision, JNameManager)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(x0))  # finish deferred shapes
    for n, p in net.collect_params().items():
        p.set_data(jmx.nd.array(weights[n]))
    return net


def _loss_fn(mx, heads):
    """SoftmaxCrossEntropyLoss that records the dtype of the logits it is
    given."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def fn(out, label):
        heads.append(str(out._data.dtype).split(".")[-1])
        return loss_fn(out, label)
    return fn


def _jtrainer(weights, x0, optimizer, params, heads=None, **kw):
    net = _jnet(weights, x0)
    tr = jparallel.ShardedTrainer(net, _loss_fn(jmx, [] if heads is None
                                                else heads),
                                  optimizer=optimizer,
                                  optimizer_params=dict(params), **kw)
    return net, tr


def _jstate(tr):
    """Params, moving stats and optimizer state (not the loss scale,
    which backs off on the step the guard discards)."""
    opt = tr.opt_state
    if isinstance(opt, dict) and "loss_scale" in opt:
        opt = opt["base"]
    return [np.asarray(a).copy() for a in tr.param_arrays] + \
        [np.asarray(a).copy() for a in jax.tree_util.tree_leaves(opt)]


def _jstep(tr, x, y):
    return float(tr.step([jmx.nd.array(x)], jmx.nd.array(y)))


def _jax_runs(weights, xs, ys):
    out = {}
    # (a) + (c): sgd with the guard on, then a NaN batch
    _, tr = _jtrainer(weights, xs[0], "sgd", SGD, on_nonfinite="skip")
    out["sgd_losses"] = [_jstep(tr, x, y) for x, y in zip(xs, ys)]
    out["sgd_params"] = [np.asarray(a).copy() for a in tr.param_arrays]
    before = _jstate(tr)
    out["nan_loss"] = _jstep(tr, _poisoned(xs[0], np.nan), ys[0])
    out["nan_unchanged"] = all(np.array_equal(a, b)
                               for a, b in zip(before, _jstate(tr)))
    out["nan_skipped"] = tr.skipped_steps
    # (a): adam, default guard
    _, tr = _jtrainer(weights, xs[0], "adam", ADAM)
    out["adam_losses"] = [_jstep(tr, x, y) for x, y in zip(xs, ys)]
    out["adam_params"] = [np.asarray(a).copy() for a in tr.param_arrays]
    # (b): step_many
    _, tr = _jtrainer(weights, xs[0], "sgd", SGD, on_nonfinite="skip",
                      steps_per_call=K)
    losses = tr.step_many([([jmx.nd.array(x)], jmx.nd.array(y))
                           for x, y in zip(xs[:K], ys[:K])])
    out["many_losses"] = np.asarray(losses).tolist()
    out["many_params"] = [np.asarray(a).copy() for a in tr.param_arrays]
    # (d): bf16_mixed with an inf at step 2
    heads = []
    net, tr = _jtrainer(weights, xs[0], "sgd", SGD, heads=heads,
                        dtype_policy="bf16_mixed")
    seen = {}
    _hook_dtypes(net, seen, lambda d: np.dtype(d).name)
    bf16 = {"losses": [], "scale": []}
    for step, (x, y) in enumerate(_bf16_batches(xs, ys)):
        if step == 1:
            before = _jstate(tr)
        loss = _jstep(tr, x, y)
        if step == 1:
            bf16["inf_unchanged"] = all(
                np.array_equal(a, b) for a, b in zip(before, _jstate(tr)))
            bf16["inf_skipped"] = tr.skipped_steps
        else:
            bf16["losses"].append(loss)
        bf16["scale"].append(np.asarray(tr.opt_state["loss_scale"]).tolist())
    bf16["dtypes"] = seen
    bf16["logits"] = heads[0]
    bf16["master"] = sorted({np.dtype(a.dtype).name
                             for a in tr.param_arrays})
    out["bf16"] = bf16
    return out


def _bf16_batches(xs, ys):
    """Four steps: a batch, the same batch with an inf, two more."""
    return [(xs[0], ys[0]), (_poisoned(xs[0], np.inf), ys[0]),
            (xs[1], ys[1]), (xs[2], ys[2])]


# ---------------------------------------------------------------------------
# the port's runs
# ---------------------------------------------------------------------------

def _tnet(weights):
    net = _build(tvision, TNameManager)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    tmx.convert.load_from_numpy(net, weights)
    return net


def _ttrainer(weights, optimizer, params, heads=None, **kw):
    net = _tnet(weights)
    tr = tparallel.ShardedTrainer(net, _loss_fn(tmx, [] if heads is None
                                                else heads),
                                  optimizer=optimizer,
                                  optimizer_params=dict(params), **kw)
    return net, tr


def _nd(a):
    return tmx.nd.array(a, ctx=tmx.cpu())


def _tstep(tr, x, y):
    return float(tr.step([_nd(x)], _nd(y)))


def _tstate(tr):
    """As ``_jstate``: every state tensor but the loss scale."""
    scale = tr.opt_state.get("loss_scale")
    return [t.clone() for t in tr.state_tensors() if t is not scale]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def _torch_runs(weights, xs, ys):
    out = {}
    _, tr = _ttrainer(weights, "sgd", SGD, on_nonfinite="skip")
    out["sgd_losses"] = [_tstep(tr, x, y) for x, y in zip(xs, ys)]
    out["sgd_params"] = [a.numpy().copy() for a in tr.param_arrays]
    before = _tstate(tr)
    out["nan_loss"] = _tstep(tr, _poisoned(xs[0], np.nan), ys[0])
    out["nan_unchanged"] = _same(before, _tstate(tr))
    out["nan_skipped"] = tr.skipped_steps
    _, tr = _ttrainer(weights, "adam", ADAM)
    out["adam_losses"] = [_tstep(tr, x, y) for x, y in zip(xs, ys)]
    out["adam_params"] = [a.numpy().copy() for a in tr.param_arrays]
    # (b): step_many against K steps of a twin trainer
    _, tr = _ttrainer(weights, "sgd", SGD, on_nonfinite="skip",
                      steps_per_call=K)
    losses = tr.step_many([([_nd(x)], _nd(y))
                           for x, y in zip(xs[:K], ys[:K])])
    out["many_losses"] = losses.tolist()
    out["many_params"] = [a.numpy().copy() for a in tr.param_arrays]
    _, twin = _ttrainer(weights, "sgd", SGD, on_nonfinite="skip")
    one_by_one = torch.stack([twin.step([_nd(x)], _nd(y))
                              for x, y in zip(xs[:K], ys[:K])])
    out["many_bit_equal"] = (torch.equal(losses, one_by_one)
                             and _same(tr.state_tensors(),
                                       twin.state_tensors())
                             and tr.global_step == twin.global_step == K)
    heads = []
    net, tr = _ttrainer(weights, "sgd", SGD, heads=heads,
                        dtype_policy="bf16_mixed")
    seen = {}
    _hook_dtypes(net, seen, lambda d: str(d).split(".")[-1])
    bf16 = {"losses": [], "scale": []}
    for step, (x, y) in enumerate(_bf16_batches(xs, ys)):
        if step == 1:
            before = _tstate(tr)
        loss = _tstep(tr, x, y)
        if step == 1:
            bf16["inf_unchanged"] = _same(before, _tstate(tr))
            bf16["inf_skipped"] = tr.skipped_steps
        else:
            bf16["losses"].append(loss)
        bf16["scale"].append(tr.opt_state["loss_scale"].tolist())
    bf16["dtypes"] = seen
    bf16["logits"] = heads[0]
    bf16["master"] = sorted({str(a.dtype).split(".")[-1]
                             for a in tr.param_arrays})
    bf16["state_dtypes"] = sorted({str(a.dtype).split(".")[-1]
                                   for a in tr.state_tensors()})
    out["bf16"] = bf16
    return out


@pytest.fixture(scope="module")
def runs():
    xs, ys = _data()
    with jax.default_matmul_precision("float32"):
        net = _build(jvision, JNameManager)
        jmx.random.seed(0)
        net.initialize(jmx.init.Xavier())
        net(jmx.nd.array(xs[0]))
        weights = {n: p.data().asnumpy().copy()
                   for n, p in net.collect_params().items()}
        jout = _jax_runs(weights, xs, ys)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        tout = _torch_runs(weights, xs, ys)
    finally:
        torch.set_float32_matmul_precision(prev)
    return {"jax": jout, "torch": tout, "weights": weights}


def _f64_losses(weights, xs, ys, params):
    """The port's sgd losses with every parameter and input in float64:
    the reference the f32 runs of both packages are measured against."""
    net = _tnet(weights)
    for p in net.collect_params().values():
        d = p.data()
        d._data = d._data.detach().double()
    tr = tparallel.ShardedTrainer(net, _loss_fn(tmx, []), optimizer="sgd",
                                  optimizer_params=dict(params))
    return [float(tr.step([torch.tensor(x, dtype=torch.float64)],
                          torch.tensor(y))) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("lr, within", [(SGD["learning_rate"], True),
                                        (1e-3, False)])
def test_f32_sgd_tracks_float64_only_at_small_rates(runs, lr, within):
    """Why (a) runs sgd at lr 3e-5: there both packages' f32 losses stay
    within 1e-5 of a float64 run over the four steps; at lr 1e-3 both
    leave it by more (the net is ill-conditioned, see the module doc)."""
    xs, ys = _data()
    params = dict(SGD, learning_rate=lr)
    ref = np.array(_f64_losses(runs["weights"], xs, ys, params))
    if lr == SGD["learning_rate"]:
        f32 = {"jax": runs["jax"]["sgd_losses"],
               "torch": runs["torch"]["sgd_losses"]}
    else:
        with jax.default_matmul_precision("float32"):
            _, jtr = _jtrainer(runs["weights"], xs[0], "sgd", params)
            jl = [_jstep(jtr, x, y) for x, y in zip(xs, ys)]
        _, ttr = _ttrainer(runs["weights"], "sgd", params)
        f32 = {"jax": jl, "torch": [_tstep(ttr, x, y)
                                    for x, y in zip(xs, ys)]}
    for package, losses in f32.items():
        drift = np.max(np.abs(np.array(losses) - ref) / np.abs(ref))
        assert (drift <= LOSS_RTOL) == within, (package, drift)


def _params_agree(tparams, jparams):
    assert len(tparams) == len(jparams)
    for i, (t, j) in enumerate(zip(tparams, jparams)):
        err = np.abs(t - j).max()
        assert err <= 1e-4 * np.abs(j).max() + 1e-5, (i, err)


# ---------------------------------------------------------------------------
# (a) f32 sgd and adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_f32_losses_match_jax(runs, opt):
    np.testing.assert_allclose(runs["torch"][opt + "_losses"],
                               runs["jax"][opt + "_losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_f32_params_and_moving_stats_match_jax(runs, opt):
    _params_agree(runs["torch"][opt + "_params"], runs["jax"][opt + "_params"])


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_training_moved_every_trained_parameter(runs, opt):
    """The steps really trained: every weight, gamma and moving stat left
    its starting value."""
    names = list(runs["weights"])
    for n, after in zip(names, runs["torch"][opt + "_params"]):
        if not n.endswith("_bias") and not n.endswith("_beta"):
            assert not np.array_equal(after, runs["weights"][n]), n


def _rand_lists(seed, n=3):
    rng = np.random.RandomState(seed)
    shapes = [(5, 4), (7,), (2, 3, 3)]
    return [[rng.randn(*s).astype(np.float32) for s in shapes[:n]]
            for _ in range(4)]


@pytest.mark.parametrize("momentum, wd", [(0.0, 0.0), (0.9, 0.0),
                                          (0.9, 0.01), (0.0, 0.05)])
def test_sgd_update_rule_matches_jax(momentum, wd):
    import jax.numpy as jnp

    params, grads, mom, _ = _rand_lists(1)
    jstate = {"mom": None if momentum == 0.0 else
              [jnp.asarray(m) for m in mom]}
    tstate = {"mom": None if momentum == 0.0 else
              [torch.tensor(m) for m in mom]}
    jp, js = jtrain._sgd_update([jnp.asarray(p) for p in params],
                                [jnp.asarray(g) for g in grads], jstate,
                                0.1, momentum, wd)
    tp, ts = ttrain._sgd_update([torch.tensor(p) for p in params],
                                [torch.tensor(g) for g in grads], tstate,
                                0.1, momentum, wd)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    if momentum:
        for a, b in zip(ts["mom"], js["mom"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_update_rule_matches_jax(wd):
    """Three Adam steps from zero state (the bias correction moves with
    ``t``) on random tensors."""
    import jax.numpy as jnp

    params, g1, g2, g3 = _rand_lists(2)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.tensor(p) for p in params]
    js = jtrain.adam_init(jp)
    ts = ttrain.adam_init(tp)
    for g in (g1, g2, g3):
        jp, js = jtrain._adam_update(jp, [jnp.asarray(x) for x in g], js,
                                     0.01, 0.9, 0.999, 1e-8, wd)
        tp, ts = ttrain._adam_update(tp, [torch.tensor(x) for x in g], ts,
                                     0.01, 0.9, 0.999, 1e-8, wd)
    assert int(ts["t"]) == int(js["t"]) == 3
    for name, t, j in (("p", tp, jp), ("m", ts["m"], js["m"]),
                       ("v", ts["v"], js["v"])):
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# (b) step_many
# ---------------------------------------------------------------------------

def test_step_many_is_bit_equal_to_steps(runs):
    assert runs["torch"]["many_bit_equal"]


def test_step_many_matches_jax_step_many(runs):
    np.testing.assert_allclose(runs["torch"]["many_losses"],
                               runs["jax"]["many_losses"], rtol=LOSS_RTOL)
    _params_agree(runs["torch"]["many_params"], runs["jax"]["many_params"])


def test_step_many_needs_k_batches():
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(tmx.init.One(), ctx=tmx.cpu())
    tr = tparallel.ShardedTrainer(net, lambda o, l: o, steps_per_call=2)
    with pytest.raises(MXNetError, match="exactly steps_per_call=2"):
        tr.step_many([([_nd(np.ones((1, 3), np.float32))],
                       _nd(np.zeros(1, np.float32)))])


# ---------------------------------------------------------------------------
# (c) the non-finite guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("package", ["jax", "torch"])
def test_skip_leaves_every_buffer_unchanged(runs, package):
    out = runs[package]
    assert not np.isfinite(out["nan_loss"])
    assert out["nan_unchanged"]
    assert out["nan_skipped"] == 1


def _dense_trainer(mx, ctx=None, **kw):
    net = mx.gluon.nn.Dense(2, in_units=3)
    if ctx is None:
        net.initialize(mx.init.One())
    else:
        net.initialize(mx.init.One(), ctx=ctx)
    return mx.parallel.ShardedTrainer(
        net, lambda o, l: (o * o).mean(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.1}, **kw)


def _dense_batches(mx, ctx=None):
    good = np.ones((2, 3), np.float32)
    bad = good.copy()
    bad[0, 0] = np.nan
    y = np.zeros(2, np.float32)
    kw = {} if ctx is None else {"ctx": ctx}
    return [([mx.nd.array(a, **kw)], mx.nd.array(y, **kw))
            for a in (good, bad)]


@pytest.mark.parametrize("mx, error", [(jmx, JNonfiniteError),
                                       (tmx, NonfiniteError)])
def test_raise_policy_raises_in_the_step(mx, error):
    ctx = tmx.cpu() if mx is tmx else None
    tr = _dense_trainer(mx, ctx, on_nonfinite="raise")
    good, bad = _dense_batches(mx, ctx)
    tr.step(*good)
    with pytest.raises(error):
        tr.step(*bad)


@pytest.mark.parametrize("mx, error", [(jmx, JNonfiniteError),
                                       (tmx, NonfiniteError)])
def test_raise_policy_under_async_raises_at_next_step_or_drain(mx, error):
    ctx = tmx.cpu() if mx is tmx else None
    tr = _dense_trainer(mx, ctx, on_nonfinite="raise", async_metrics=True)
    good, bad = _dense_batches(mx, ctx)
    tr.step(*bad)  # the fetch is asynchronous: no raise here
    with pytest.raises(error):
        tr.step(*good)
        tr.drain()
    tr.close()


def test_async_metrics_skip_counts_after_drain():
    tr = _dense_trainer(tmx, tmx.cpu(), on_nonfinite="skip",
                        async_metrics=True)
    good, bad = _dense_batches(tmx, tmx.cpu())
    before = _tstate(tr)
    tr.step(*bad)
    tr.drain()
    assert tr.skipped_steps == 1
    assert _same(before, _tstate(tr))
    tr.step(*good)
    tr.close()
    assert tr.global_step == 2 and tr.skipped_steps == 1


def test_hot_path_has_no_host_sync():
    """No host read of a device value in the dispatch path, and under
    async metrics the synchronous consumer is never called."""
    hot = [ttrain.ShardedTrainer._step_inner,
           ttrain.ShardedTrainer._step_many_inner,
           ttrain.ShardedTrainer._dispatch_commit,
           ttrain.ShardedTrainer._step_core,
           ttrain.ShardedTrainer._forward_loss,
           ttrain.ShardedTrainer._new_fixed,
           ttrain.ShardedTrainer._flush_metrics,
           ttrain._MetricFetcher.submit]
    for fn in hot:
        src = inspect.getsource(fn)
        for needle in ("np.asarray", "float(", ".item(", ".cpu(",
                       ".numpy(", ".tolist(", "synchronize("):
            assert needle not in src, (fn.__name__, needle)
    tr = _dense_trainer(tmx, tmx.cpu(), async_metrics=True)

    def boom(*a, **kw):
        raise AssertionError("sync metric consumer on the async path")

    tr._consume_metrics_sync = boom
    good, _ = _dense_batches(tmx, tmx.cpu())
    for _ in range(3):
        tr.step(*good)
    tr.close()
    assert tr.global_step == 3


# ---------------------------------------------------------------------------
# (d) bf16_mixed
# ---------------------------------------------------------------------------

def test_bf16_mixed_dtype_of_every_block_matches_jax(runs):
    jd, td = runs["jax"]["bf16"]["dtypes"], runs["torch"]["bf16"]["dtypes"]
    assert len(jd) == 35  # 17 convs, 17 BatchNorms, the head's Dense
    assert td == jd
    # conv and dense compute in bf16, BatchNorm's outputs are f32 (f32
    # gamma/beta under norm_f32)
    assert {v for k, v in jd.items() if "batchnorm" in k} == {"float32"}
    assert {v for k, v in jd.items() if "batchnorm" not in k} == \
        {"bfloat16"}
    # the head's bf16 logits reach the loss as f32 (cast_outputs)
    assert runs["torch"]["bf16"]["logits"] == \
        runs["jax"]["bf16"]["logits"] == "float32"


def test_bf16_mixed_keeps_master_state_f32(runs):
    assert runs["torch"]["bf16"]["master"] == runs["jax"]["bf16"]["master"] \
        == ["float32"]
    assert runs["torch"]["bf16"]["state_dtypes"] == ["float32"]


def test_bf16_mixed_losses_match_jax(runs):
    np.testing.assert_allclose(runs["torch"]["bf16"]["losses"],
                               runs["jax"]["bf16"]["losses"],
                               rtol=BF16_LOSS_RTOL)


def test_bf16_mixed_overflow_backs_off_like_jax(runs):
    t, j = runs["torch"]["bf16"], runs["jax"]["bf16"]
    assert t["scale"] == j["scale"] == [[65536.0, 1.0], [32768.0, 0.0],
                                        [32768.0, 1.0], [32768.0, 2.0]]
    for out in (t, j):
        assert out["inf_unchanged"]
        assert out["inf_skipped"] == 1


def test_bf16_mixed_tag_and_loss_scale():
    _, tr = _ttrainer(_tnet_weights(), "sgd", SGD,
                      dtype_policy="bf16_mixed")
    assert tr.dtype_policy_tag == "bf16_mixed"
    assert tr.loss_scale() == 65536.0
    _, tr = _ttrainer(_tnet_weights(), "sgd", SGD)
    assert tr.dtype_policy_tag == "f32" and tr.loss_scale() is None


def _tnet_weights():
    net = _build(tvision, TNameManager)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    net(_nd(np.zeros((1, 3, 32, 32), np.float32)))
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def test_sync_to_net_writes_the_trained_params_back():
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(tmx.init.One(), ctx=tmx.cpu())
    tr = tparallel.ShardedTrainer(
        net, lambda o, l: o.mean(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.5})
    tr.step([_nd(np.ones((1, 3), np.float32))], _nd(np.zeros(1, np.float32)))
    # untouched until synced; d mean(o) / d w = 1/2 per weight
    assert np.array_equal(net.weight.data().asnumpy(), np.ones((2, 3)))
    tr.sync_to_net()
    np.testing.assert_allclose(net.weight.data().asnumpy(),
                               np.full((2, 3), 0.75, np.float32))


# ---------------------------------------------------------------------------
# (e) constructor errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw, match", [
    ({"dtype": "bfloat16", "dtype_policy": "bf16_mixed"}, "not both"),
    ({"optimizer": "nag"}, "sgd/adam"),
    ({"steps_per_call": 0}, "steps_per_call must be >= 1"),
    ({"mesh": "dp=2"}, "not ported yet"),
    ({"layout": "fsdp"}, "not ported yet"),
    ({"remat_policy": "full"}, "not ported yet"),
    ({"aot": True}, "not ported yet"),
    ({"distributed": False}, "not ported yet"),
])
def test_constructor_errors(kw, match):
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(tmx.init.One(), ctx=tmx.cpu())
    with pytest.raises(MXNetError, match=match):
        tparallel.ShardedTrainer(net, lambda o, l: o, **kw)


@pytest.mark.parametrize("kw", [
    {"dtype": "bfloat16", "dtype_policy": "bf16_mixed"},
    {"optimizer": "nag"},
    {"steps_per_call": 0},
])
def test_jax_constructor_raises_alike(kw):
    net = jmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(jmx.init.One())
    with pytest.raises(jmx.base.MXNetError):
        jparallel.ShardedTrainer(net, lambda o, l: o, **kw)
