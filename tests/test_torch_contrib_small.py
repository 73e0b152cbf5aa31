"""The small single-card modules of the port against the JAX package, on
CPU: ``contrib.autograd``, ``contrib.io.DataLoaderIter``,
``contrib.tensorboard``'s JSONL rows, ``contrib.svrg_optimization``,
``contrib.text``, ``contrib.tensorrt``, ``examples.fine_tune``,
``tools.im2rec``, and the config helpers (``describe``,
``warn_unknown``, ``MXNET_SAFE_ACCUMULATION``, ``MXNET_HOME``).

Tolerances: float32 results within rtol 1e-5, atol 1e-6 of the JAX
package's (JAX at ``default_matmul_precision("float32")``, torch at
``"highest"``); the fine-tuned net's first-step gradients within rtol
1e-4 of the JAX package's plus 1e-5 x the largest gradient (a resnet18
backward at 32x32 sums thousands of terms in different orders, and a
conv bias before a BatchNorm has an exact gradient of 0); files
byte-equal.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"), tmx.cpu():
        yield
    torch.set_float32_matmul_precision(prev)


def _nd(pkg, a):
    return pkg.nd.array(a, ctx=tmx.cpu()) if pkg is tmx else pkg.nd.array(a)


def _ctx(pkg):
    return tmx.cpu() if pkg is tmx else jmx.cpu()


# ---------------------------------------------------------------------------
# contrib.autograd, contrib.io, contrib.tensorboard, contrib.tensorrt
# ---------------------------------------------------------------------------

def _legacy_grads(pkg):
    from importlib import import_module

    old = import_module(pkg.__name__ + ".contrib.autograd")
    rng = np.random.RandomState(0)
    a, b = (rng.randn(3, 4).astype(np.float32) for _ in range(2))

    def f(x, y):
        return (x * y + pkg.nd.exp(x) * 0.5).sum()

    grads, loss = old.grad_and_loss(f)(_nd(pkg, a), _nd(pkg, b))
    only = old.grad(f, argnum=1)(_nd(pkg, a), _nd(pkg, b))
    with old.train_section():
        assert pkg.autograd.is_recording() and pkg.autograd.is_training()
    with old.test_section():
        assert not pkg.autograd.is_recording()
    return [g.asnumpy() for g in grads] + [only[0].asnumpy(),
                                           loss.asnumpy()]


def test_contrib_autograd_matches_jax():
    got, want = _legacy_grads(tmx), _legacy_grads(jmx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _loader_batches(pkg):
    from importlib import import_module

    cio = import_module(pkg.__name__ + ".contrib.io")
    rng = np.random.RandomState(3)
    x = rng.rand(10, 4).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    loader = pkg.gluon.data.DataLoader(pkg.gluon.data.ArrayDataset(x, y),
                                       batch_size=4)
    it = cio.DataLoaderIter(loader)
    out = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]
    it.reset()
    assert len(list(it)) == len(out)
    assert it.provide_data[0].shape == (4, 4)
    assert it.provide_label[0].shape == (4,)
    return out


def test_dataloader_iter_matches_jax():
    got, want = _loader_batches(tmx), _loader_batches(jmx)
    assert [b[2] for b in got] == [b[2] for b in want] == [0, 0, 2]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


def _tensorboard_rows(pkg, directory, monkeypatch):
    from importlib import import_module

    tb = import_module(pkg.__name__ + ".contrib.tensorboard")
    bep = import_module(pkg.__name__ + ".module.base_module").BatchEndParam
    cb = tb.LogMetricsCallback(str(directory), prefix="train")
    assert isinstance(cb.summary_writer, tb._JsonlWriter)
    m = pkg.metric.create("acc")
    for i in range(3):
        m.update([_nd(pkg, np.array([0.0, 1.0, float(i % 2)]))],
                 [_nd(pkg, np.array([[0.9, 0.1], [0.2, 0.8], [0.4, 0.6]]))])
        cb(bep(epoch=0, nbatch=i, eval_metric=m))
    cb(bep(epoch=0, nbatch=3, eval_metric=None))
    with open(os.path.join(str(directory), "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_tensorboard_jsonl_rows_match_jax(tmp_path, monkeypatch):
    # no tensorboard package importable: both fall back to the JSONL log
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    got = _tensorboard_rows(tmx, tmp_path / "t", monkeypatch)
    want = _tensorboard_rows(jmx, tmp_path / "j", monkeypatch)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g["tag"], g["step"]) == (w["tag"], w["step"])
        assert g["value"] == pytest.approx(w["value"], rel=1e-6)
        assert isinstance(g["wall_time"], float)


def test_tensorrt_stub():
    trt = tmx.contrib.tensorrt
    assert not trt.get_use_tensorrt()
    trt.set_use_tensorrt(True)
    assert trt.get_use_tensorrt()
    trt.set_use_tensorrt(False)
    assert not trt.get_use_tensorrt()
    with pytest.raises(MXNetError, match="TensorRT"):
        trt.tensorrt_bind(None, None, {})
    assert sorted(trt.__all__) == sorted(jmx.contrib.tensorrt.__all__)


# ---------------------------------------------------------------------------
# contrib.svrg_optimization
# ---------------------------------------------------------------------------

def _svrg(pkg):
    from importlib import import_module

    svrg = import_module(pkg.__name__ + ".contrib.svrg_optimization")
    rng = np.random.RandomState(0)
    x = rng.rand(64, 8).astype(np.float32)
    w_true = rng.rand(8, 1).astype(np.float32)
    y = (x @ w_true).ravel()
    it = pkg.io.NDArrayIter(_nd(pkg, x), _nd(pkg, y), batch_size=16,
                            label_name="lin_label")
    s = pkg.sym
    with pkg.name.NameManager():
        out = s.FullyConnected(s.var("data"), num_hidden=1, name="fc")
        out = s.LinearRegressionOutput(out, s.var("lin_label"), name="lin")
    mod = svrg.SVRGModule(out, data_names=("data",),
                          label_names=("lin_label",), update_freq=2,
                          context=_ctx(pkg))
    init = {"fc_weight": rng.randn(1, 8).astype(np.float32) * 0.1,
            "fc_bias": np.zeros(1, np.float32)}
    mod.fit(it, num_epoch=2, eval_metric="mse",
            arg_params={k: _nd(pkg, v) for k, v in init.items()},
            optimizer_params=(("learning_rate", 0.3),))
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}, init


def test_svrg_two_epochs_match_jax():
    got, init = _svrg(tmx)
    want, _ = _svrg(jmx)
    assert sorted(got) == sorted(want) == ["fc_bias", "fc_weight"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
        assert not np.array_equal(got[k], init[k])


# ---------------------------------------------------------------------------
# contrib.text
# ---------------------------------------------------------------------------

_TEXT = "the cat sat on the mat\nThe dog sat\non the log the end"


def _text(pkg, tmp_path):
    from importlib import import_module

    text = import_module(pkg.__name__ + ".contrib.text")
    counter = text.utils.count_tokens_from_str(_TEXT, to_lower=True)
    vocab = text.Vocabulary(counter, most_freq_count=5, min_freq=1,
                            reserved_tokens=["<pad>"])
    path = os.path.join(str(tmp_path), "emb.txt")
    rng = np.random.RandomState(5)
    with open(path, "w") as f:
        f.write("4 3\n")
        for tok in ("the", "cat", "sat", "zebra"):
            f.write(tok + " " + " ".join("%.6f" % v for v in rng.randn(3))
                    + "\n")
    emb = text.embedding.create("customembedding",
                                pretrained_file_path=path)
    restricted = text.embedding.CustomEmbedding(path, vocabulary=vocab)
    emb.update_token_vectors("cat", _nd(pkg, np.ones((1, 3), np.float32)))
    comp = text.embedding.CompositeEmbedding(vocab, [emb, restricted])
    return {
        "counter": dict(counter),
        "idx_to_token": vocab.idx_to_token,
        "indices": vocab.to_indices(["the", "sat", "unseen", "<pad>"]),
        "tokens": vocab.to_tokens([0, 1, 2]),
        "emb_tokens": emb.idx_to_token,
        "vecs": emb.get_vecs_by_tokens(["the", "cat", "nope", "The"],
                                       lower_case_backup=True).asnumpy(),
        "restricted": restricted.idx_to_vec.asnumpy(),
        "composite": comp.idx_to_vec.asnumpy(),
        "vec_len": emb.vec_len,
        "names": sorted(text.embedding.get_pretrained_file_names()),
    }


def test_vocabulary_and_custom_embedding_match_jax(tmp_path):
    got = _text(tmx, tmp_path)
    want = _text(jmx, tmp_path)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k
    with pytest.raises(FileNotFoundError):
        tmx.contrib.text.embedding.GloVe("glove.6B.50d.txt",
                                         embedding_root=str(tmp_path))


# ---------------------------------------------------------------------------
# examples.fine_tune
# ---------------------------------------------------------------------------

SHAPE = (3, 32, 32)


def _jax_fine_tune_module():
    spec = importlib.util.spec_from_file_location(
        "jax_fine_tune", os.path.join(ROOT, "examples", "fine_tune.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _jax_export(weights, directory):
    """resnet18_v1 with ``weights``, exported by the JAX package (its
    export freezes BatchNorm to the moving stats; the port's writes the
    layer's own setting, ROADMAP "caveats the port does not copy"), so
    both packages graft the same graph."""
    from mxnet_tpu.gluon.model_zoo import vision as jvision

    with jmx.name.NameManager():
        net = jvision.get_model("resnet18_v1", classes=10)
    net.initialize()
    net(jmx.nd.array(np.zeros((1,) + SHAPE, np.float32)))
    for n, p in net.collect_params().items():
        p.set_data(jmx.nd.array(weights[n]))
    prefix = os.path.join(str(directory), "base")
    net.export(prefix)
    return prefix


def _first_step_grads(pkg, ft, prefix, head, batch):
    sym = pkg.sym.load(prefix + "-symbol.json")
    loaded = pkg.nd.load(prefix + "-0000.params")
    args = {k.split(":", 1)[1]: v for k, v in loaded.items()
            if k.startswith("arg:")}
    aux = {k.split(":", 1)[1]: v for k, v in loaded.items()
           if k.startswith("aux:")}
    tuned, backbone = ft.get_fine_tune_model(sym, args, 20)
    assert not any(k.startswith("fc_new") for k in backbone)
    x, y = batch
    it = pkg.io.NDArrayIter(_nd(pkg, x), _nd(pkg, y), batch_size=4,
                            label_name="softmax_label")
    mod = pkg.mod.Module(tuned, context=_ctx(pkg))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(pkg.init.Xavier())
    mod.set_params({**backbone, **{k: _nd(pkg, v) for k, v in head.items()}},
                   aux, allow_missing=True, allow_extra=True)
    mod.forward(next(iter(it)), is_train=True)
    mod.backward()
    grads = {name: gs[0].asnumpy()
             for _i, name, gs, _a in mod._grad_walk()}
    return grads, sorted(backbone)


def test_fine_tune_first_step_gradients_match_jax(tmp_path):
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.examples import fine_tune as tft

    jft = _jax_fine_tune_module()
    with jmx.name.NameManager():
        jnet = jvision.get_model("resnet18_v1", classes=10)
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(np.zeros((1,) + SHAPE, np.float32)))
    weights = {n: p.data().asnumpy() for n, p in
               jnet.collect_params().items()}
    rng = np.random.RandomState(7)
    head = {"fc_new_weight": rng.randn(20, 512).astype(np.float32) * 0.05,
            "fc_new_bias": np.zeros(20, np.float32)}
    batch = (rng.rand(4, *SHAPE).astype(np.float32),
             rng.randint(0, 20, 4).astype(np.float32))
    prefix = _jax_export(weights, tmp_path)
    got, tb = _first_step_grads(tmx, tft, prefix, head, batch)
    want, jb = _first_step_grads(jmx, jft, prefix, head, batch)
    assert tb == jb
    assert sorted(got) == sorted(want)
    assert "fc_new_weight" in got
    scale = max(np.abs(w).max() for w in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)


def test_fine_tune_example_runs_on_cpu():
    from mxnet_tpu_torch.examples import fine_tune

    out = fine_tune.train(["--cpu", "--epochs", "1", "--batch-size", "4",
                           "--train-batches", "2", "--val-batches", "1",
                           "--network", "resnet18_v1"])
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert 0.0 <= out["val_acc"] <= 1.0


# ---------------------------------------------------------------------------
# tools.im2rec
# ---------------------------------------------------------------------------

def _images(root):
    from PIL import Image

    rng = np.random.RandomState(11)
    for cls in ("cats", "dogs"):
        os.makedirs(os.path.join(root, cls))
        for i in range(3):
            a = (rng.rand(20 + 4 * i, 24, 3) * 255).astype(np.uint8)
            Image.fromarray(a).save(os.path.join(root, cls, "%d.png" % i))


def _im2rec(main, prefix, root):
    main(["--list", "--train-ratio", "0.5", prefix, root])
    for part in ("_train", "_val"):
        main([prefix + part, root, "--resize", "16", "--quality", "90"])
    out = {}
    for part in ("_train", "_val"):
        for ext in (".lst", ".rec", ".idx"):
            with open(prefix + part + ext, "rb") as f:
                out[part + ext] = f.read()
    return out


def test_im2rec_bytes_match_jax_tool(tmp_path, monkeypatch):
    from mxnet_tpu_torch.tools import im2rec as tim2rec

    root = str(tmp_path / "img")
    _images(root)
    spec = importlib.util.spec_from_file_location(
        "jax_im2rec", os.path.join(ROOT, "tools", "im2rec.py"))
    jim2rec = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jim2rec)

    def jmain(argv):
        monkeypatch.setattr(sys, "argv", ["im2rec.py"] + argv)
        jim2rec.main()

    got = _im2rec(tim2rec.main, str(tmp_path / "t"), root)
    want = _im2rec(jmain, str(tmp_path / "j"), root)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert got["_train.rec"] and got["_val.rec"]
    rec = tmx.recordio.MXIndexedRecordIO(str(tmp_path / "t_train.idx"),
                                         str(tmp_path / "t_train.rec"), "r")
    header, img = tmx.recordio.unpack_img(rec.read_idx(rec.keys[0]))
    assert min(img.shape[:2]) == 16
    rec.close()


# ---------------------------------------------------------------------------
# config helpers
# ---------------------------------------------------------------------------

def _rows(describe):
    out = {}
    for line in describe().splitlines():
        name, disposition, default = line.split()[:3]
        out[name] = (disposition, default)
    return out


def test_describe_rows_of_the_shared_flags_match_jax():
    got = _rows(tmx.config.describe)
    want = _rows(jmx.config.describe)
    assert len(got) == len(tmx.config.FLAGS)
    # where the two packages' defaults differ on purpose
    differ = {"MXNET_COMPILE_CACHE_DIR": "the port's own cache directory"}
    shared = sorted(set(got) & set(want))
    assert len(shared) >= 70
    # the port keeps only the flags it reads: every one is honored
    assert {d for d, _ in got.values()} == {"honored"}
    for name in shared:
        if name not in differ:
            assert got[name][1] == want[name][1], name
    table = tmx.config.markdown_table().splitlines()
    assert table[0] == jmx.config.markdown_table().splitlines()[0]
    assert len(table) == len(tmx.config.FLAGS) + 2
    for name in ("MXNET_REMAT_POLICY", "MXNET_COMPILE_CACHE",
                 "MXNET_SAFE_ACCUMULATION", "MXNET_HOME"):
        assert name in got and name in want, name


def test_warn_unknown(monkeypatch):
    monkeypatch.setenv("MXNET_NO_SUCH_KNOB", "1")
    monkeypatch.setenv("MXNET_REMAT_POLICY", "")
    with pytest.warns(UserWarning, match="MXNET_NO_SUCH_KNOB"):
        tmx.config.warn_unknown()


def _bf16_sums(pkg):
    x = np.full((4096,), 1.0 / 3.0, np.float32)
    a = _nd(pkg, x).astype("bfloat16")
    return [float(op(a).astype("float32").asnumpy().reshape(-1)[0])
            for op in (pkg.nd.sum, pkg.nd.mean)]


def test_safe_accumulation_on_a_bf16_sum(monkeypatch):
    monkeypatch.setenv("MXNET_SAFE_ACCUMULATION", "1")
    safe, want = _bf16_sums(tmx), _bf16_sums(jmx)
    # bf16(1/3) = 0.333984375; 4096 of them sum to 1368 in f32, which
    # bf16 holds exactly; the mean rounds back to bf16(1/3)
    assert safe == want == [1368.0, 0.333984375]


def test_mxnet_home_is_a_flag(monkeypatch, tmp_path):
    assert tmx.config.FLAGS["MXNET_HOME"][0] == \
        jmx.config.FLAGS["MXNET_HOME"][0]
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    assert tmx.config.get("MXNET_HOME") == str(tmp_path)
