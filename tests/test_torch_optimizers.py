"""The port's optimizers against the JAX package's on CPU: the 13 update
ops, the 15 registered optimizers through ``Updater`` over 3 steps with
weight decay, gradient clipping, rescaling, per-name ``lr_mult`` /
``wd_mult`` and an ``lr_scheduler``, ``multi_precision`` on f16 weights,
a JAX ``get_states()`` blob loaded by the port; then the Trainer's fused
SGD update bit for bit equal to the per-parameter loop, and
``Trainer.save_states`` / ``load_states``.

Same seeded numpy weights and gradients go to both packages; f32
weights and states agree at rtol 1e-5 / atol 1e-6, f16 weights within
one f16 step of them.  SGLD's noise comes from each package's own
generator, so it is held on its deterministic part (the JAX update with
its noise drawn as zeros, against the port's update less its noise,
redrawn from the same seed) and on the noise's mean and spread."""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.random as jrandom
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
NAMES = ["fc_weight", "fc_bias", "bn_gamma"]
SHAPES = [(6, 5), (6,), (6,)]


def _r(seed):
    return np.random.RandomState(seed)


def _weights(seed=0):
    return [_r(seed + i).randn(*s).astype(np.float32)
            for i, s in enumerate(SHAPES)]


def _grads(step):
    return [(_r(100 + 10 * step + i).randn(*s) * 3).astype(np.float32)
            for i, s in enumerate(SHAPES)]


def _to_np(state):
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return [_to_np(s) for s in state]
    return state.asnumpy()


def _run_updater(pkg, name, kw, steps=3, dtype=np.float32, wrap=None):
    kw = dict(kw)
    sched = kw.pop("lr_scheduler", None)
    if sched is not None:
        kw["lr_scheduler"] = getattr(pkg.lr_scheduler, sched[0])(**sched[1])
    opt = pkg.optimizer.create(name, param_idx2name=dict(enumerate(NAMES)),
                               **kw)
    opt.set_lr_mult({"fc_weight": 0.5})
    opt.set_wd_mult({"bn_gamma": 2.0})
    upd = pkg.optimizer.get_updater(opt)
    ws = [wrap(w.astype(dtype)) for w in _weights()]
    for step in range(steps):
        for i, (w, g) in enumerate(zip(ws, _grads(step))):
            upd(i, wrap(g.astype(dtype)), w)
    return [w.asnumpy() for w in ws], \
        {i: _to_np(s) for i, s in upd.states.items()}, upd


def _tw(v):
    return tmx.nd.array(v, ctx=tmx.cpu(), dtype=v.dtype)


def _jw(v):
    return jmx.nd.array(v, dtype=v.dtype)


def _same_states(t, j, rtol=RTOL, atol=ATOL):
    if j is None or isinstance(j, (float, int)):
        assert t is None or t == j
        return
    if isinstance(j, list):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same_states(a, b, rtol, atol)
        return
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


BASE = dict(wd=0.01, clip_gradient=2.0, rescale_grad=0.5,
            learning_rate=0.05)
OPTIMIZERS = [
    ("sgd", dict(BASE)),
    ("sgd", dict(BASE, momentum=0.9,
                 lr_scheduler=("FactorScheduler", dict(step=1, factor=0.5)))),
    ("lbsgd", dict(BASE, momentum=0.8)),
    ("signum", dict(BASE, wd_lh=0.01)),
    ("signum", dict(BASE, momentum=0.0)),
    ("ftml", dict(BASE)),
    ("dcasgd", dict(BASE)),
    ("dcasgd", dict(BASE, momentum=0.9)),
    ("adam", dict(BASE, lr_scheduler=("CosineScheduler",
                                      dict(max_update=10, warmup_steps=1)))),
    ("adagrad", dict(BASE)),
    ("rmsprop", dict(BASE, clip_weights=1.0)),
    ("rmsprop", dict(BASE, centered=True)),
    ("adadelta", dict(BASE)),
    ("ftrl", dict(BASE)),
    ("adamax", dict(BASE)),
    ("nadam", dict(BASE, lr_scheduler=("PolyScheduler",
                                       dict(max_update=6, pwr=2)))),
    ("nag", dict(BASE, momentum=0.9)),
    ("nag", dict(BASE)),
    ("test", dict(BASE)),
]


@pytest.mark.parametrize("name, kw", OPTIMIZERS,
                         ids=["%s-%d" % (n, i) for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_matches_jax_over_three_steps(name, kw):
    tws, tst, _ = _run_updater(tmx, name, kw, wrap=_tw)
    jws, jst, _ = _run_updater(jmx, name, kw, wrap=_jw)
    for t, j in zip(tws, jws):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    assert sorted(tst) == sorted(jst)
    for i in jst:
        _same_states(tst[i], jst[i])


def test_every_registered_jax_optimizer_is_ported():
    from mxnet_tpu.optimizer import optimizer as jopt
    from mxnet_tpu_torch.optimizer import optimizer as topt

    assert sorted(topt._OPT_REGISTRY) == sorted(jopt._OPT_REGISTRY)
    assert len(topt._OPT_REGISTRY) == 15
    assert tmx.optimizer.SignSGD is tmx.optimizer.Signum


def test_sgld_deterministic_part_and_noise_match_jax(monkeypatch):
    kw = dict(BASE)
    tmx.random.seed(11)
    tws, _, _ = _run_updater(tmx, "sgld", kw, steps=1, wrap=_tw)
    # the port's noise: the same draws again from the same seed
    tmx.random.seed(11)
    gen = tmx.random.generator(torch.device("cpu"))
    lrs = [BASE["learning_rate"] * 0.5, BASE["learning_rate"],
           BASE["learning_rate"]]
    noise = [torch.normal(0.0, float(np.sqrt(lr)), s, generator=gen).numpy()
             for lr, s in zip(lrs, SHAPES)]
    monkeypatch.setattr(jrandom, "normal",
                        lambda loc, scale, shape, dtype=None, **k:
                        jmx.nd.zeros(shape))
    jws, _, _ = _run_updater(jmx, "sgld", kw, steps=1, wrap=_jw)
    for t, n, j in zip(tws, noise, jws):
        np.testing.assert_allclose(t - n, j, rtol=RTOL, atol=1e-6)
    # the noise itself: N(0, lr) over a large weight
    tmx.random.seed(12)
    opt = tmx.optimizer.create("sgld", learning_rate=0.04)
    w = tmx.nd.array(np.zeros((200, 200), np.float32), ctx=tmx.cpu())
    opt.update(0, w, tmx.nd.array(np.zeros((200, 200), np.float32),
                                  ctx=tmx.cpu()), None)
    draw = w.asnumpy()
    assert abs(draw.mean()) < 4 * 0.2 / 200
    assert abs(draw.std() - 0.2) < 0.01


UPDATE_OPS = [
    ("sgd_update", 0, {}),
    ("sgd_mom_update", 1, {"momentum": 0.9}),
    ("nag_mom_update", 1, {"momentum": 0.9}),
    ("adam_update", 2, {"beta1": 0.8, "beta2": 0.99}),
    ("signsgd_update", 0, {}),
    ("signum_update", 1, {"momentum": 0.7, "wd_lh": 0.02}),
    ("rmsprop_update", 1, {"gamma1": 0.9, "clip_weights": 0.8}),
    ("rmspropalex_update", 3, {"gamma1": 0.9, "gamma2": 0.8}),
    ("ftrl_update", 2, {"lamda1": 0.01, "beta": 1.0}),
    ("ftml_update", 3, {"beta1": 0.6, "beta2": 0.999, "t": 2}),
    ("adamw_update", 2, {"eta": 0.9}),
]


@pytest.mark.parametrize("op, n_states, extra", UPDATE_OPS,
                         ids=[u[0] for u in UPDATE_OPS])
def test_update_op_matches_jax_in_place(op, n_states, extra):
    clip_key = "clip_grad" if op == "ftml_update" else "clip_gradient"
    attrs = dict(extra, lr=0.05, wd=0.01, rescale_grad=0.5)
    attrs[clip_key] = 1.5
    outs = []
    for pkg, wrap in ((tmx, _tw), (jmx, _jw)):
        w = wrap(_weights()[0])
        states = [wrap(np.abs(_r(50 + k).randn(6, 5)).astype(np.float32)
                       * (0.1 if op != "ftml_update" or k else 0.0))
                  for k in range(n_states)]
        buf = w._data
        for step in range(3):
            getattr(pkg.nd, op)(w, wrap(_grads(step)[0]), *states, **attrs)
        if pkg is tmx:  # updated in place: the same buffers
            assert w._data is buf
        outs.append([w.asnumpy()] + [s.asnumpy() for s in states])
    for t, j in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mom", [0.0, 0.9])
def test_mp_sgd_ops_match_jax(mom):
    op = "mp_sgd_mom_update" if mom else "mp_sgd_update"
    outs = []
    for pkg, wrap in ((tmx, _tw), (jmx, _jw)):
        w32 = _weights()[0]
        w, master = wrap(w32.astype(np.float16)), wrap(w32)
        states = [wrap(np.zeros((6, 5), np.float32))] if mom else []
        for step in range(3):
            getattr(pkg.nd, op)(w, wrap(_grads(step)[0].astype(np.float16)),
                                *states, master, lr=0.05, wd=0.01,
                                momentum=mom, rescale_grad=0.5)
        outs.append([w.asnumpy(), master.asnumpy()]
                    + [s.asnumpy() for s in states])
    assert outs[0][0].dtype == np.float16
    for t, j in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name, kw", [("sgd", dict(BASE)),
                                      ("sgd", dict(BASE, momentum=0.9)),
                                      ("adam", dict(BASE))])
def test_multi_precision_on_f16_weights_matches_jax(name, kw):
    kw = dict(kw, multi_precision=True)
    tws, tst, _ = _run_updater(tmx, name, kw, dtype=np.float16, wrap=_tw)
    jws, jst, _ = _run_updater(jmx, name, kw, dtype=np.float16, wrap=_jw)
    for t, j in zip(tws, jws):
        assert t.dtype == np.float16
        np.testing.assert_allclose(t.astype(np.float32),
                                   j.astype(np.float32), rtol=1e-3,
                                   atol=1e-3)
    for i in jst:  # (inner state, f32 master)
        _same_states(tst[i], jst[i], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name, kw", [("adam", dict(BASE)),
                                      ("sgd", dict(BASE, momentum=0.9)),
                                      ("rmsprop", dict(BASE,
                                                       centered=True))])
def test_a_jax_states_blob_loads_into_the_port(name, kw):
    _, _, jupd = _run_updater(jmx, name, kw, steps=2, wrap=_jw)
    blob = jupd.get_states()
    topt = tmx.optimizer.create(name, param_idx2name=dict(enumerate(NAMES)),
                                **kw)
    topt.set_lr_mult({"fc_weight": 0.5})
    topt.set_wd_mult({"bn_gamma": 2.0})
    # the update counts travel with the optimizer, not the states
    topt._index_update_count = dict(jupd.optimizer._index_update_count)
    topt.num_update = jupd.optimizer.num_update
    tupd = tmx.optimizer.get_updater(topt)
    tupd.set_states(blob)
    jws = [_jw(w) for w in _weights()]
    tws = [_tw(w) for w in _weights()]
    for i in range(3):
        jupd(i, _jw(_grads(7)[i]), jws[i])
        tupd(i, _tw(_grads(7)[i]), tws[i])
    for t, j in zip(tws, jws):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=RTOL,
                                   atol=ATOL)
    # and the port's own blob round-trips through pickle as numpy
    states = pickle.loads(tupd.get_states())
    assert all(isinstance(s, (np.ndarray, tuple)) for s in states.values())


def _mlp(pkg, ctx):
    with pkg.name.NameManager():
        net = pkg.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(8, activation="relu"),
                    pkg.gluon.nn.BatchNorm(), pkg.gluon.nn.Dense(3))
    if ctx is None:
        net.initialize(pkg.init.Xavier())
    else:
        net.initialize(pkg.init.Xavier(), ctx=ctx)
    return net


def _trainer_run(pkg, ctx, opt, kw, weights, steps, trainer_kw=None,
                 hook=None):
    wrap = (lambda v: pkg.nd.array(v, ctx=ctx)) if ctx else pkg.nd.array
    net = _mlp(pkg, ctx)
    x = _r(1).randn(6, 5).astype(np.float32)
    y = _r(2).randint(0, 3, 6).astype(np.float32)
    net(wrap(x))
    if weights is not None:
        for n, p in net.collect_params().items():
            p.set_data(weights[n])
    net.collect_params()[net.prefix + "dense0_weight"].lr_mult = 0.5
    trainer = pkg.gluon.Trainer(net.collect_params(), opt, dict(kw),
                                **(trainer_kw or {}))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for step in range(steps):
        if hook:
            hook(step, trainer)
        with pkg.autograd.record():
            loss = loss_fn(net(wrap(x)), wrap(y))
        loss.backward()
        trainer.step(6)
    return net, trainer, {n: p.data().asnumpy()
                          for n, p in net.collect_params().items()}


class _LoopSGD(tmx.optimizer.SGD):
    """SGD itself, but not the class the Trainer fuses."""


@pytest.mark.parametrize("kw", [dict(learning_rate=0.1),
                                dict(learning_rate=0.1, momentum=0.9,
                                     wd=1e-3, clip_gradient=0.05)],
                         ids=["plain", "momentum_wd_clip"])
def test_fused_sgd_update_is_bit_equal_to_the_loop(kw):
    ctx = tmx.cpu()
    w0 = _trainer_run(tmx, ctx, "sgd", kw, None, 0)[2]
    _, tr_f, fused = _trainer_run(tmx, ctx, "sgd", kw, w0, 4)
    _, tr_l, looped = _trainer_run(tmx, ctx, _LoopSGD(**kw), {}, w0, 4)
    assert tr_f._fused_updates == 4 and tr_l._fused_updates == 0
    for n in fused:
        np.testing.assert_array_equal(fused[n], looped[n], err_msg=n)
    # the momentum buffers are the Updater's states, bit-equal too
    for i, st in tr_l._updaters[0].states.items():
        if st is not None:
            np.testing.assert_array_equal(
                tr_f._updaters[0].states[i].asnumpy(), st.asnumpy())


def test_fused_sgd_replans_when_momentum_or_clip_changes():
    ctx = tmx.cpu()
    w0 = _trainer_run(tmx, ctx, "sgd", {}, None, 0)[2]
    kw = dict(learning_rate=0.1, momentum=0.9)

    def change(step, trainer):
        if step == 2:
            trainer.optimizer.momentum = 0.5
            trainer.optimizer.clip_gradient = 0.01

    _, tr, fused = _trainer_run(tmx, ctx, "sgd", kw, w0, 4, hook=change)
    _, _, looped = _trainer_run(tmx, ctx, _LoopSGD(**kw), {}, w0, 4,
                                hook=change)
    assert tr._fused_key[1:] == (0.5, 0.01)
    for n in fused:
        np.testing.assert_array_equal(fused[n], looped[n], err_msg=n)


def test_fused_sgd_trainer_matches_the_jax_trainer():
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-3)
    jnet, _, jw = _trainer_run(jmx, None, "sgd", kw, None, 0)
    _, _, jw3 = _trainer_run(jmx, None, "sgd", kw, jw, 3)
    _, tr, tw3 = _trainer_run(tmx, tmx.cpu(), "sgd", kw, jw, 3)
    assert tr._fused_updates == 3
    for n in jw3:
        np.testing.assert_allclose(tw3[n], jw3[n], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("opt, kw, trainer_kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9), {}),
    ("adam", dict(learning_rate=0.01), {}),
    ("sgd", dict(learning_rate=0.1, momentum=0.9),
     {"kvstore": "store", "update_on_kvstore": True}),
], ids=["fused_sgd", "adam", "update_on_kvstore"])
def test_save_and_load_states_resume_bit_for_bit(tmp_path, opt, kw,
                                                 trainer_kw):
    ctx = tmx.cpu()
    w0 = _trainer_run(tmx, ctx, "sgd", {}, None, 0)[2]

    def tkw():
        if trainer_kw.get("kvstore") == "store":
            return dict(trainer_kw, kvstore=tmx.kv.create("device"))
        return trainer_kw

    _, _, straight = _trainer_run(tmx, ctx, opt, kw, w0, 4, tkw())
    fname = str(tmp_path / "trainer.states")
    net, tr, mid = _trainer_run(tmx, ctx, opt, kw, w0, 2, tkw())
    tr.save_states(fname)

    def resume(step, trainer):
        if step == 0:
            trainer.load_states(fname)

    _, tr2, resumed = _trainer_run(tmx, ctx, opt, kw, mid, 2, tkw(),
                                   hook=resume)
    assert tr2.optimizer.num_update == 4
    for n in straight:
        np.testing.assert_array_equal(resumed[n], straight[n], err_msg=n)


@pytest.mark.parametrize("size, slices, even", [(8, 4, True), (7, 3, False),
                                                (6, 1, True)])
def test_split_data_matches_jax(size, slices, even):
    x = _r(3).randn(size, 3).astype(np.float32)
    t = tmx.gluon.utils.split_data(tmx.nd.array(x, ctx=tmx.cpu()), slices,
                                   even_split=even)
    j = jmx.gluon.utils.split_data(jmx.nd.array(x), slices, even_split=even)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    with pytest.raises(ValueError):
        tmx.gluon.utils.split_data(tmx.nd.array(x, ctx=tmx.cpu()), 5)
    out = tmx.gluon.utils.split_and_load(x, [tmx.cpu()])
    assert len(out) == 1 and out[0].context == tmx.cpu()
    np.testing.assert_array_equal(out[0].asnumpy(), x)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax(max_norm):
    arrays = [_r(4 + i).randn(*s).astype(np.float32)
              for i, s in enumerate(SHAPES)]
    ta = [tmx.nd.array(a, ctx=tmx.cpu()) for a in arrays]
    ja = [jmx.nd.array(a) for a in arrays]
    tn = tmx.gluon.utils.clip_global_norm(ta, max_norm)
    jn = jmx.gluon.utils.clip_global_norm(ja, max_norm)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6)


def test_clip_global_norm_nonfinite_policy():
    bad = [tmx.nd.array(np.array([np.inf, 1.0], np.float32), ctx=tmx.cpu())]
    with pytest.raises(tmx.checkpoint.NonfiniteError):
        tmx.gluon.utils.clip_global_norm(bad, 1.0, on_nonfinite="raise")
    with pytest.warns(UserWarning):
        norm = tmx.gluon.utils.clip_global_norm(bad, 1.0,
                                                on_nonfinite="skip")
    assert not np.isfinite(norm)
    np.testing.assert_array_equal(bad[0].asnumpy(), [np.inf, 1.0])
