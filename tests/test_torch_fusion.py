"""The port's graph fusion (``ops/fused.py``, ``fusion_cost``,
``symbol/fusion.py`` and the ``fusion=`` argument) held against its own
unfused graphs and against the JAX package on the CPU.

* Each of the five patterns' canonical chain (``bench_builder``) at a
  small shape, bound fused and unfused in the port: outputs, gradients
  and moving stats after a training step, and predict-mode outputs, at
  rtol 1e-5, atol 1e-6 (``layer_norm_fast``, a different rounding: atol
  1e-5); each fused op also against the JAX package's fused op on the
  same values.  ``conv_bn_relu`` runs with and without its activation,
  in training too, against the unfused Convolution -> BatchNorm graph;
  the JAX test of that case compares a sum at an absolute 1e-5 (ROADMAP
  Queue 3), here the loss is a weighted sum and the bound relative.
* ``apply_fusion`` under ``off``, ``default``, ``all`` and a name list
  on a ResNet bottleneck symbol and a LayerNorm/scale chain: the same
  fired (pattern, site) pairs as the JAX package on the same symbol; a
  cost table that suppresses or fires a site; ``fold_batchnorm`` against
  the unfolded graph in predict mode and against the JAX fold.
* A ``CostTable`` written by either package's ``save_table`` and read
  by the other's ``load_table``; ``microbench`` on the CPU.
* ``hybridize(fusion=)``, ``simple_bind(fusion=)``, ``Module(fusion=)``
  and ``ShardedTrainer(fusion=)`` each equal to their unfused selves.
JAX matmuls at ``default_matmul_precision("float32")``, torch at
``"highest"``; the port compiles with ``aot_eager``."""
import json

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu import fusion_cost as jfc
from mxnet_tpu.symbol import fusion as jfusion

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import fusion_cost as tfc
from mxnet_tpu_torch.symbol import fusion as tfusion

RTOL, ATOL = 1e-5, 1e-6
SHAPES = {"conv_bn_relu": (2, 3, 8, 8), "norm_act": (2, 4, 6, 6),
          "act_scale_add": (3, 5), "add_act": (3, 5),
          "layer_norm_fast": (4, 8)}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    monkeypatch.delenv("MXNET_FUSION", raising=False)
    monkeypatch.delenv("MXNET_FUSION_TUNE", raising=False)
    tfc.clear_cost_table()
    jfc.clear_cost_table()
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)
    tfc.clear_cost_table()
    jfc.clear_cost_table()


def _nd(pkg, a):
    a = np.asarray(a, np.float32)
    return pkg.nd.array(a, ctx=tmx.cpu()) if pkg is tmx else pkg.nd.array(a)


def _ctx(pkg):
    return tmx.cpu() if pkg is tmx else jmx.cpu()


def _bind(pkg, sym, feeds, vals, fusion):
    ex = sym.simple_bind(ctx=_ctx(pkg), grad_req="write", fusion=fusion,
                         **feeds)
    for d in (ex.arg_dict, ex.aux_dict):
        for n, a in d.items():
            a[:] = _nd(pkg, vals[n])
    return ex


def _values(sym, feeds, seed=0):
    arg_shapes, _, aux_shapes = sym.infer_shape(**feeds)
    rng = np.random.RandomState(seed)
    names = sym.list_arguments() + sym.list_auxiliary_states()
    return {n: (rng.rand(*s) + 0.5).astype(np.float32) if "var" in n
            else rng.randn(*s).astype(np.float32)
            for n, s in zip(names, list(arg_shapes) + list(aux_shapes))}


def _train_and_predict(ex):
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    grads = {n: g.asnumpy() for n, g in ex.grad_dict.items()}
    aux = {n: a.asnumpy() for n, a in ex.aux_dict.items()}
    pred = ex.forward(is_train=False)[0].asnumpy()
    return out, grads, aux, pred


CASES = [(n, True) for n in SHAPES] + [("conv_bn_relu", False)]


@pytest.mark.parametrize("name,act", CASES)
def test_pattern_parity_against_unfused_and_jax(name, act):
    shape = SHAPES[name]
    res = {}
    for pkg in (tmx, jmx):
        fus = tfusion if pkg is tmx else jfusion
        chain, feeds = fus.get_pattern(name).bench_builder(shape)
        if name == "conv_bn_relu" and not act:
            chain = pkg.sym.BatchNorm(pkg.sym.Convolution(
                pkg.sym.var("data"), kernel=(3, 3),
                num_filter=max(shape[1], 4), pad=(1, 1), no_bias=True,
                name="conv0"), fix_gamma=False, name="bn0")
        _, (out_shape,), _ = chain.infer_shape(**feeds)
        loss = pkg.sym.sum(chain * pkg.sym.var("loss_w"), name="loss")
        feeds = dict(feeds, loss_w=out_shape)
        if pkg is tmx:
            vals = _values(loss, feeds)
        fused, fired = fus.apply_fusion(loss, name)
        assert [f[0] for f in fired] == [name]
        res[pkg] = [_train_and_predict(_bind(pkg, s, feeds, vals, "off"))
                    for s in (loss, fused)]
    atol = 1e-5 if name == "layer_norm_fast" else ATOL
    for run in (res[tmx][1], res[jmx][1]):     # fused: port, then JAX
        ref = res[tmx][0]
        np.testing.assert_allclose(run[0], ref[0], rtol=RTOL, atol=atol)
        for n in ref[1]:
            np.testing.assert_allclose(run[1][n], ref[1][n], rtol=RTOL,
                                       atol=1e-5, err_msg=n)
        for n in ref[2]:
            np.testing.assert_allclose(run[2][n], ref[2][n], rtol=RTOL,
                                       atol=atol, err_msg=n)
        np.testing.assert_allclose(run[3], ref[3], rtol=RTOL, atol=atol)


def _bottleneck(pkg, classes=10, gate=True):
    """A ResNet v1 bottleneck (1x1, 3x3, 1x1 convs with BatchNorm, the
    projected shortcut, the residual add and relu) and a head; plus
    (``gate``) a scaled residual tail (relu -> mul -> add), and a
    LayerNorm."""
    S = pkg.sym
    x = S.var("data")

    def cbr(h, nf, k, name, act=True):
        pad = (k // 2, k // 2)
        h = S.Convolution(h, kernel=(k, k), pad=pad, num_filter=nf,
                          no_bias=True, name=name + "_conv")
        h = S.BatchNorm(h, fix_gamma=False, name=name + "_bn")
        return S.Activation(h, act_type="relu", name=name + "_relu") \
            if act else h

    body = cbr(cbr(cbr(x, 4, 1, "a"), 4, 3, "b"), 8, 1, "c", act=False)
    short = cbr(x, 8, 1, "sc", act=False)
    y = S.Activation(body + short, act_type="relu", name="join")
    if gate:
        y = S.broadcast_add(S.broadcast_mul(S.relu(y, name="r2"),
                                            S.var("gate")), y, name="res")
    y = S.LayerNorm(S.Flatten(y), axis=-1, name="ln")
    return S.FullyConnected(y, num_hidden=classes, name="fc")


@pytest.mark.parametrize("spec", ["off", None, "default", "all",
                                  "norm_act,add_act", "layer_norm_fast"])
def test_apply_fusion_sites_match_jax(spec):
    got = tfusion.apply_fusion(_bottleneck(tmx), spec)
    want = jfusion.apply_fusion(_bottleneck(jmx), spec)
    assert [(p, s) for p, s, _ in got[1]] == [(p, s) for p, s, _ in want[1]]
    assert got[0].list_arguments() == want[0].list_arguments()
    for op in ("_contrib_conv_bn_relu", "_contrib_norm_act",
               "_contrib_add_act", "_contrib_act_scale_add", "BatchNorm",
               "_contrib_layer_norm_fused"):
        assert tfusion.count_ops(got[0], op) == \
            jfusion.count_ops(want[0], op), op
    if spec in (None, "default"):
        assert sorted({p for p, _, _ in got[1]}) == ["act_scale_add",
                                                      "add_act"]


def test_bottleneck_fused_graphs_equal_unfused():
    sym = _bottleneck(tmx)
    feeds = {"data": (2, 3, 6, 6), "gate": (1,)}
    vals = _values(sym, feeds, seed=4)
    res = [_train_and_predict(_bind(tmx, sym, feeds, vals, f))
           for f in ("off", "default", "all")]
    for run in res[1:]:
        np.testing.assert_allclose(run[0], res[0][0], rtol=RTOL, atol=1e-5)
        for n in res[0][1]:
            np.testing.assert_allclose(run[1][n], res[0][1][n], rtol=1e-4,
                                       atol=1e-5, err_msg=n)
        for n in res[0][2]:
            np.testing.assert_allclose(run[2][n], res[0][2][n], rtol=RTOL,
                                       atol=ATOL, err_msg=n)
        np.testing.assert_allclose(run[3], res[0][3], rtol=RTOL, atol=1e-5)


def _table(pkg, key, speedup):
    fc = tfc if pkg is tmx else jfc
    t = fc.CostTable()
    t.add(key, fused_ms=1.0, unfused_ms=speedup)
    return t


def test_cost_table_gates_sites():
    a, b = tmx.sym.var("data"), tmx.sym.var("res")
    loss = tmx.sym.sum(tmx.sym.Activation(a + b, act_type="relu"))
    known = {"data": ((3, 5), np.float32), "res": ((3, 5), np.float32)}
    key = tfc.shape_key("add_act", (3, 5), "float32")
    assert key == jfc.shape_key("add_act", (3, 5), "float32")
    tfc.set_cost_table(_table(tmx, key, 0.5))     # measured slower
    assert tfusion.apply_fusion(loss, "default", known=known)[1] == []
    tfc.set_cost_table(_table(tmx, key, 2.0))
    assert [f[0] for f in tfusion.apply_fusion(
        loss, "default", known=known)[1]] == ["add_act"]
    ln = tmx.sym.LayerNorm(tmx.sym.var("data"), name="ln")
    lkey = tfc.shape_key("layer_norm_fast", (4, 16), "float32", axis=-1)
    tfc.set_cost_table(_table(tmx, lkey, 2.0))    # off by default: fires
    fired = tfusion.apply_fusion(
        ln, None, known={"data": ((4, 16), np.float32)})[1]
    assert fired == [("layer_norm_fast", "ln", lkey)]
    with pytest.raises(ValueError, match="unknown fusion pattern"):
        tfc.resolve_fusion("not_a_pattern")


@pytest.mark.parametrize("writer,reader", [(tfc, jfc), (jfc, tfc)])
def test_cost_table_across_packages(tmp_path, writer, reader):
    t = writer.CostTable(meta={"device": "test"})
    t.add(writer.shape_key("norm_act", (2, 4, 6, 6), "float32"), 1.0, 1.2)
    t.add(writer.shape_key("layer_norm_fast", (4, 8), "bfloat16", axis=1),
          2.0, 1.0)
    path = tmp_path / "table.json"
    writer.save_table(str(path), t)
    back = reader.load_table(str(path))
    assert back.entries == json.loads(path.read_text())["entries"]
    assert back.meta["device"] == "test"
    for k in t.entries:
        assert back.speedup(k) == t.speedup(k)
    assert reader.validate_table(json.loads(path.read_text())) == ([], [])


def test_fold_batchnorm_against_unfolded_and_jax():
    res = {}
    for pkg in (tmx, jmx):
        fus = tfusion if pkg is tmx else jfusion
        sym = _bottleneck(pkg)
        feeds = {"data": (2, 3, 6, 6), "gate": (1,)}
        if pkg is tmx:
            vals = _values(sym, feeds, seed=6)
        args = {n: _nd(pkg, vals[n]) for n in sym.list_arguments()
                if n not in feeds}
        aux = {n: _nd(pkg, vals[n]) for n in sym.list_auxiliary_states()}
        folded, fargs, faux = fus.fold_batchnorm(sym, args, aux)
        assert fus.count_ops(folded, "BatchNorm") == 0
        outs = []
        for s, a, x in ((sym, args, aux), (folded, fargs, faux)):
            ex = s.simple_bind(ctx=_ctx(pkg), grad_req="null", fusion="off",
                               **feeds)
            ex.copy_params_from(a, x)
            ex.arg_dict["data"][:] = _nd(pkg, vals["data"])
            ex.arg_dict["gate"][:] = _nd(pkg, vals["gate"])
            outs.append(ex.forward(is_train=False)[0].asnumpy())
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-4)
        res[pkg] = (outs[1], {n: v.asnumpy() for n, v in fargs.items()})
    np.testing.assert_allclose(res[tmx][0], res[jmx][0], rtol=RTOL,
                               atol=1e-5)
    assert set(res[tmx][1]) == set(res[jmx][1])
    for n in res[jmx][1]:
        np.testing.assert_allclose(res[tmx][1][n], res[jmx][1][n],
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def test_microbench_on_cpu_gives_the_bind_key():
    out = tfusion.microbench("add_act", (8, 16), iters=2, warmup=1,
                             repeats=1, ctx=tmx.cpu())
    assert out["fired"] and out["speedup"] > 0
    assert out["key"] == jfc.shape_key("add_act", (8, 16), "float32")
    assert out["key"] == jfusion.microbench(
        "add_act", (8, 16), iters=2, warmup=1, repeats=1)["key"]


def test_executor_default_fusion_and_reshape():
    a, b = tmx.sym.var("data"), tmx.sym.var("res")
    loss = tmx.sym.sum(tmx.sym.Activation(a + b, act_type="relu"))
    feeds = {"data": (3, 5), "res": (3, 5)}
    off = loss.simple_bind(ctx=tmx.cpu(), fusion="off", **feeds)
    assert off.fusion_fired == []
    dflt = loss.simple_bind(ctx=tmx.cpu(), **feeds)
    assert [f[0] for f in dflt.fusion_fired] == ["add_act"]
    r = dflt.reshape(data=(6, 5), res=(6, 5))
    assert [f[0] for f in r.fusion_fired] == ["add_act"]
    with pytest.raises(ValueError, match="unknown fusion pattern"):
        loss.simple_bind(ctx=tmx.cpu(), fusion="nope", **feeds)


def _ln_net(pkg):
    nn = pkg.gluon.nn
    with pkg.name.NameManager():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(16, in_units=8), nn.LayerNorm(in_channels=16),
                    nn.Dense(4, in_units=16))
    net.initialize(ctx=_ctx(pkg))
    rng = np.random.RandomState(7)
    for _, p in sorted(net.collect_params().items()):
        p.set_data(_nd(pkg, rng.randn(*p.shape) * 0.5))
    return net


@pytest.mark.parametrize("fusion", ["off", "default", "all",
                                    "layer_norm_fast"])
def test_hybridize_fusion_equals_unfused(fusion):
    x = np.random.RandomState(8).rand(4, 8).astype(np.float32)
    net = _ln_net(tmx)
    ref = net(_nd(tmx, x)).asnumpy()
    net.hybridize(fusion=fusion)
    with tmx.autograd.record():
        out = net(_nd(tmx, x))
    out.backward()
    np.testing.assert_allclose(out.asnumpy(), ref, rtol=RTOL, atol=1e-5)
    jnet = _ln_net(jmx)
    jnet.hybridize(fusion=fusion)
    np.testing.assert_allclose(out.asnumpy(), jnet(_nd(jmx, x)).asnumpy(),
                               rtol=RTOL, atol=1e-5)
    with pytest.raises(ValueError, match="unknown fusion pattern"):
        net.hybridize(fusion="typo")


def test_runtime_decision_picks_the_fast_layer_norm():
    key = tfc.shape_key("layer_norm_fast", (4, 16), "float32", axis=-1)
    plan = tfc.resolve_fusion("default")
    assert not tfc.runtime_decision("layer_norm_fast", (4, 16),
                                    torch.float32, axis=-1)   # no plan
    with tfc.scope(plan):
        assert not tfc.runtime_decision("layer_norm_fast", (4, 16),
                                        torch.float32, axis=-1)
    tfc.set_cost_table(_table(tmx, key, 2.0))
    with tfc.scope(tfc.resolve_fusion("default")):
        assert tfc.runtime_decision("layer_norm_fast", (4, 16),
                                    torch.float32, axis=-1)
    assert tfc.current_plan() is None


def _module_run(fusion, sym, vals):
    mod = tmx.mod.Module(sym, context=tmx.cpu(), fusion=fusion,
                         label_names=("softmax_label",))
    mod.bind(data_shapes=[("data", (2, 3, 6, 6))],
             label_shapes=[("softmax_label", (2,))])
    mod.init_params(arg_params={n: _nd(tmx, vals[n]) for n in
                                sym.list_arguments()
                                if n not in ("data", "softmax_label")},
                    aux_params={n: _nd(tmx, vals[n])
                                for n in sym.list_auxiliary_states()})
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    batch = tmx.io.DataBatch([_nd(tmx, vals["data"])],
                             [_nd(tmx, np.array([1, 3]))])
    mod.forward_backward(batch)
    mod.update()
    mod.forward(batch, is_train=False)
    args, aux = mod.get_params()
    return mod.get_outputs()[0].asnumpy(), {n: v.asnumpy()
                                             for n, v in args.items()}


def test_module_fusion_equals_unfused():
    sym = tmx.sym.SoftmaxOutput(_bottleneck(tmx, gate=False),
                                tmx.sym.var("softmax_label"), name="sm")
    vals = _values(sym, {"data": (2, 3, 6, 6), "softmax_label": (2,)},
                   seed=9)
    ref = _module_run("off", sym, vals)
    for fusion in (None, "all"):
        got = _module_run(fusion, sym, vals)
        np.testing.assert_allclose(got[0], ref[0], rtol=RTOL, atol=1e-5)
        for n in ref[1]:
            np.testing.assert_allclose(got[1][n], ref[1][n], rtol=1e-4,
                                       atol=1e-5, err_msg=n)
    with pytest.raises(ValueError, match="unknown fusion pattern"):
        tmx.mod.Module(sym, context=tmx.cpu(), fusion="typo")


def test_sharded_trainer_fusion_equals_unfused():
    from mxnet_tpu_torch import gluon, parallel

    rng = np.random.RandomState(10)
    x = _nd(tmx, rng.rand(8, 8))
    y = _nd(tmx, rng.randint(0, 4, 8))
    runs = {}
    for fusion in (None, "off", "all"):
        net = _ln_net(tmx)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        tr = parallel.ShardedTrainer(net, lambda o, l: loss_fn(o, l),
                                     optimizer="sgd",
                                     optimizer_params={"learning_rate": 0.1},
                                     fusion=fusion)
        runs[fusion] = [float(tr.step([x], y)) for _ in range(4)]
    np.testing.assert_allclose(runs[None], runs["off"], rtol=RTOL)
    np.testing.assert_allclose(runs["all"], runs["off"], rtol=1e-5,
                               atol=1e-6)
    assert runs["off"][-1] < runs["off"][0]
    with pytest.raises(ValueError, match="unknown fusion pattern"):
        parallel.ShardedTrainer(_ln_net(tmx), lambda o, l: o, fusion="typo")
