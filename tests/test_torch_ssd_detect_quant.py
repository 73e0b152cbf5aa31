"""The slice as a whole on the CPU: examples/ssd_detect_quant.py's SSD in
both packages (build_ssd at width 8, 32x32 images, 3 classes, batch 2,
labels of 1-2 objects with padding rows) on the same weights, carried
across by ``convert.params_from_numpy``:

* one training step (MultiBoxTarget, SoftmaxOutput, smooth_l1, MakeLoss)
  bound in an Executor: outputs within 1e-4 + 1e-4 |ref|, every weight's
  gradient within 1e-3 of its norm (floored at 1e-3 of the largest);
* the fp32 MultiBoxDetection graph: the sorted scores within 1e-5; ids
  and boxes equal (boxes within 1e-5) at every row clear of a near tie
  (a CPU score within 1e-5 of a neighbour's: two such rows may trade
  places between the packages);
* quantize_model's int8 graph (11 int8 convolutions): every int8
  activation code of the JAX graph, and the detections at the tolerance
  of one int8 step of a value in [0, 1] (2^-7 > 1/127), with the same
  tie rule;
* the port's examples.quantize_calibrate main() returning 0 (its gate)
  in both calibration modes, and ssd_detect_quant's own flow end to end.

The JAX example builds its training graph at build_ssd's default width;
the test composes the same graph at width 8 from each package's
build_ssd and holds the port's training_symbol(width=8) to it."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.examples import quantize_calibrate as tcal
from mxnet_tpu_torch.examples import ssd_detect_quant as tex

ROOT = Path(__file__).resolve().parents[1]
C, WIDTH, SIDE, BATCH = 3, 8, 32, 2
OUT_TOL, GRAD_REL, DET_TOL, INT8_TOL = 1e-4, 1e-3, 1e-5, 2.0 ** -7


def _load_jax_example(name):
    spec = importlib.util.spec_from_file_location(
        "jax_example_" + name, ROOT / "examples" / (name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jex = _load_jax_example("ssd_detect_quant")


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def _training_symbol(pkg, ex):
    """examples/ssd_detect_quant.py training_symbol at width 8."""
    S = pkg.sym
    with pkg.name.NameManager():
        anchors, cls_preds, loc_preds = ex.build_ssd(C, width=WIDTH)
        loc_t, loc_mask, cls_t = S.contrib.MultiBoxTarget(
            anchors, S.var("label"), cls_preds, overlap_threshold=0.5,
            negative_mining_ratio=3.0, negative_mining_thresh=0.5)
        cls_loss = S.SoftmaxOutput(cls_preds, cls_t, ignore_label=-1,
                                   use_ignore=True, multi_output=True,
                                   normalization="valid", name="cls_prob")
        loc_diff = S.smooth_l1(loc_mask * (loc_preds - loc_t), scalar=1.0)
        loc_loss = S.MakeLoss(S.mean(loc_diff), name="loc_loss")
        return S.Group([cls_loss, loc_loss])


def _detection_symbol(pkg, ex):
    with pkg.name.NameManager():
        anchors, cls_preds, loc_preds = ex.build_ssd(C, width=WIDTH)
        return pkg.sym.contrib.MultiBoxDetection(
            pkg.sym.softmax(cls_preds, axis=1), loc_preds, anchors,
            nms_threshold=0.45, nms_topk=100)


def _inputs():
    rng = np.random.RandomState(21)
    x, _ = jex.synthetic_batch(rng, BATCH, C, SIDE)
    label = np.full((BATCH, 3, 5), -1, np.float32)
    for b in range(BATCH):
        for m in range(2 - b):
            xy = rng.uniform(0, 0.55, 2)
            wh = rng.uniform(0.2, 0.4, 2)
            label[b, m] = [rng.randint(C), *xy, *(xy + wh)]
    return x, label


def _weights(sym, shapes):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(22)
    out = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        fan_in = np.prod(shape[1:]) if len(shape) > 1 else 1
        scale = np.sqrt(2.0 / fan_in) if name.endswith("weight") else 0.1
        out[name] = (rng.randn(*shape) * scale).astype(np.float32)
    return out


def _bind(pkg, sym, arrays, grad=False):
    if pkg is tmx:
        args = tmx.convert.params_from_numpy(arrays, ctx=tmx.cpu())
        grads = {k: tmx.nd.zeros(v.shape, ctx=tmx.cpu())
                 for k, v in args.items()} if grad else None
        return sym.bind(ctx=tmx.cpu(), args=args, args_grad=grads,
                        grad_req="write" if grad else "null")
    args = {k: jmx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()}
    grads = {k: jmx.nd.zeros(v.shape) for k, v in args.items()} \
        if grad else None
    return sym.bind(args=args, args_grad=grads,
                    grad_req="write" if grad else "null")


def _close(got, ref, atol, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref) / (atol + rtol * np.abs(ref))).max())


def test_training_symbol_is_the_examples_graph():
    with tmx.name.NameManager():
        t = json.loads(tex.training_symbol(C, width=WIDTH).tojson())
    assert t == json.loads(_training_symbol(jmx, jex).tojson())
    assert t == json.loads(_training_symbol(tmx, tex).tojson())


def test_one_training_step_matches_jax():
    x, label = _inputs()
    syms = {jmx: _training_symbol(jmx, jex), tmx: _training_symbol(tmx, tex)}
    weights = _weights(syms[jmx], {"data": x.shape, "label": label.shape})
    res = {}
    for pkg, sym in syms.items():
        ex = _bind(pkg, sym, dict(weights, data=x, label=label), grad=True)
        outs = [o.asnumpy() for o in ex.forward(is_train=True)]
        ex.backward()
        res[pkg] = (outs, {k: ex.grad_dict[k].asnumpy() for k in weights})
    (jo, jg), (to, tg) = res[jmx], res[tmx]
    for a, b in zip(jo, to):
        assert _close(b, a, OUT_TOL, OUT_TOL) <= 1.0
    assert np.isfinite(to[1]).all() and to[0].shape == (BATCH, C + 1, 320)
    # each gradient within 1e-3 of its norm, the norm floored at 1e-3 of
    # the largest (loc_head1's is 0 in both: no positive anchor at the
    # coarse scale)
    norms = {k: np.linalg.norm(jg[k]) for k in weights}
    floor = 1e-3 * max(norms.values())
    for k in weights:
        assert np.linalg.norm(tg[k] - jg[k]) <= \
            GRAD_REL * max(norms[k], floor), k


def _rows_match(got, ref, tol):
    """Detections (B, N, 6): sorted scores within ``tol`` row for row; ids
    equal and boxes within ``tol`` at every row clear of a near tie.
    Returns the number of rows compared in full."""
    np.testing.assert_allclose(got[:, :, 1], ref[:, :, 1], atol=tol, rtol=0)
    score = ref[:, :, 1]
    gap = np.full(score.shape, np.inf)
    d = np.abs(np.diff(score, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], d)
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    clear = (gap > tol) | (ref == -1).all(axis=2)
    np.testing.assert_array_equal(got[:, :, 0][clear], ref[:, :, 0][clear])
    np.testing.assert_allclose(got[:, :, 2:][clear], ref[:, :, 2:][clear],
                               atol=tol, rtol=0)
    return int(clear.sum())


def _detections(pkg, ex, weights, x, int8):
    sym = _detection_symbol(pkg, ex)
    if not int8:
        return _bind(pkg, sym, dict(weights, data=x)).forward()[0] \
            .asnumpy(), None
    mod = tq if pkg is tmx else jq
    if pkg is tmx:
        args = tmx.convert.params_from_numpy(weights, ctx=tmx.cpu())
    else:
        args = {k: jmx.nd.array(v) for k, v in weights.items()}
    with pkg.name.NameManager():
        qsym, qargs, _ = mod.quantize_model(sym, args, {}, calib_mode="none")
    qnp = {k: v.asnumpy() for k, v in qargs.items()}
    internals = qsym.get_internals()
    names = [n for n in internals.list_outputs()
             if n.endswith("_data_quantize_output0")]
    group = pkg.sym.Group([internals[n] for n in names] + [qsym])
    outs = _bind(pkg, group, {k: v for k, v in dict(qnp, data=x).items()
                              if k in group.list_arguments()}).forward()
    outs = [o.asnumpy() for o in outs]
    return outs[-1], (outs[:-1], qnp)


def test_fp32_and_int8_detections_match_jax():
    x, _ = _inputs()
    weights = _weights(_detection_symbol(jmx, jex), {"data": x.shape})
    jd, _ = _detections(jmx, jex, weights, x, False)
    td, _ = _detections(tmx, tex, weights, x, False)
    assert td.shape == (BATCH, 320, 6)
    assert _rows_match(td, jd, DET_TOL) > 0.9 * td.shape[0] * td.shape[1]
    jq8, (jcodes, jargs) = _detections(jmx, jex, weights, x, True)
    tq8, (tcodes, targs) = _detections(tmx, tex, weights, x, True)
    assert sum(k.endswith("_weight_quantized") for k in targs) == 11
    for k in jargs:
        np.testing.assert_array_equal(targs[k], jargs[k], err_msg=k)
    assert len(tcodes) == 11
    for a, b in zip(jcodes, tcodes):
        assert b.dtype == np.int8
        np.testing.assert_array_equal(b, a)
    _rows_match(tq8, jq8, INT8_TOL)


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_quantize_calibrate_main_passes_its_gate(mode, capsys):
    assert tcal.main(["--cpu", "--calib-mode", mode]) == 0
    assert "QUANTIZE OK" in capsys.readouterr().out


def test_ssd_detect_quant_flow_on_the_cpu():
    """The port's example end to end at a small size through ImageDetIter:
    finite losses, 11 int8 layers, detections of the expected shape, and
    no kernel launched on the CPU."""
    from mxnet_tpu_torch import kernels

    before = dict(kernels.launch_counts)
    res = tex.run(tex.parse_args(["--cpu", "--batch-size", "2",
                                  "--image-size", "32", "--width", "8",
                                  "--train-steps", "2"]))
    assert np.isfinite(res["loc_loss"]).all() and res["n_q"] == 11
    assert res["det_fp32"].shape == res["det_int8"].shape == (2, 320, 6)
    assert kernels.launch_counts == before
