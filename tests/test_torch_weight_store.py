"""The weight store of the port held against the JAX package's on the CPU:
``nd.save``/``nd.load`` in both formats across the two packages,
``save_parameters``/``load_parameters`` of resnet18_v1 (3x32x32), the
model store behind ``get_model(pretrained=True)`` (a local root, a
``file://`` mirror, ``check_sha1`` refusing a corrupted file),
``Parameter``/``ParameterDict``/``Block`` (zero_grad, reset_ctx, cast,
setattr, Constant, the keyword merge of ``get``, hooks, apply, summary,
infer_shape) and the initializers.

Every file written by one package loads in the other with equal values
and dtypes (the JAX package narrows 64-bit data to 32-bit, and so does
the port).  ``Bilinear``, ``LSTMBias``, ``Load`` and ``Mixed`` are held
bit for bit to the JAX ones; ``Orthogonal`` and ``MSRAPrelu`` draw from
each package's own stream and are held to their properties: an
orthonormal matrix times the scale (within 1e-5), and a normal spread of
sqrt(2 / (1 + slope^2) / fan) (within 5% over 65536 draws).
"""
import hashlib
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import model_store, vision as tvision
from mxnet_tpu_torch.gluon import utils as tutils

CPU = tmx.cpu()


def _data(dtype, seed=0):
    rng = np.random.RandomState(seed)
    if dtype in ("int32", "uint8"):
        return rng.randint(0, 200, (3, 4)).astype(dtype)
    return rng.randn(3, 4).astype(dtype)


def _write(pkg, fname, container, dtype, fmt):
    wrap = (lambda a: tmx.nd.array(a, ctx=CPU, dtype=a.dtype)) \
        if pkg is tmx else (lambda a: jmx.nd.array(a, dtype=a.dtype))
    a, b = _data(dtype), _data(dtype, 1)[:2]
    if container == "dict":
        payload, want = {"w": wrap(a), "b.x": wrap(b)}, {"w": a, "b.x": b}
    elif container == "list":
        payload, want = [wrap(a), wrap(b)], [a, b]
    else:
        payload, want = wrap(a), [a]
    pkg.nd.save(str(fname), payload, format=fmt)
    return want


def _read(pkg, fname):
    got = pkg.nd.load(str(fname), ctx=CPU) if pkg is tmx \
        else pkg.nd.load(str(fname))
    if isinstance(got, dict):
        return {k: v.asnumpy() for k, v in got.items()}
    return [v.asnumpy() for v in got]


def _equal(got, want):
    assert type(got) is type(want)
    items = zip(sorted(got), sorted(want)) if isinstance(got, dict) \
        else ((i, i) for i in range(len(want)))
    assert len(got) == len(want)
    for kg, kw in items:
        assert kg == kw
        assert got[kg].dtype == want[kw].dtype, (got[kg].dtype,
                                                 want[kw].dtype)
        np.testing.assert_array_equal(got[kg], want[kw])


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32", "uint8"])
@pytest.mark.parametrize("container", ["dict", "list", "single"])
@pytest.mark.parametrize("fmt", ["npz", "binary"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_saved_arrays_load_in_the_other_package(tmp_path, writer, fmt,
                                                container, dtype):
    src, dst = (tmx, jmx) if writer == "torch" else (jmx, tmx)
    fname = tmp_path / "arrays.params"
    want = _write(src, fname, container, dtype, fmt)
    _equal(_read(dst, fname), want)
    _equal(_read(src, fname), want)


def test_load_narrows_64_bit_like_jax(tmp_path):
    np.savez(tmp_path / "a.npz", **{"mxtpu:v1:0": np.arange(3),
                                    "mxtpu:v1:1": np.ones(2)})
    for pkg in (tmx, jmx):
        _equal(_read(pkg, tmp_path / "a.npz"),
               [np.arange(3, dtype=np.int32), np.ones(2, np.float32)])


def test_binary_loader_reads_v1_and_pre_v1_records(tmp_path):
    import struct

    from mxnet_tpu_torch.ndarray import legacy_io

    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    body = (struct.pack("<QQQ", legacy_io.LIST_MAGIC, 0, 2)
            + struct.pack("<Ii", legacy_io.V1_MAGIC, 2)
            + struct.pack("<2q", 2, 3) + struct.pack("<iii", 1, 0, 0)
            + a.tobytes()
            + struct.pack("<I", 2) + struct.pack("<2I", 3, 2)
            + struct.pack("<iii", 1, 0, 0) + a.T.copy().tobytes()
            + struct.pack("<Q", 0))
    (tmp_path / "old.params").write_bytes(body)
    got = _read(tmx, tmp_path / "old.params")
    _equal(got, [a, a.T.copy()])
    _equal(got, _read(jmx, tmp_path / "old.params"))


# ---------------------------------------------------------------------------
# save_parameters / load_parameters across the packages (resnet18_v1)
# ---------------------------------------------------------------------------

def _port_resnet18(classes=10):
    with tmx.name.NameManager():
        net = tvision.resnet18_v1(classes=classes)
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net(tmx.nd.array(np.zeros((1, 3, 32, 32), np.float32), ctx=CPU))
    return net


def _weights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _save_binary(pkg, net, fname):
    """``net``'s parameters under their structural names in the reference
    binary format, through ``pkg.nd.save``."""
    pkg.nd.save(str(fname), {k: p._reduce() for k, p in
                             net._collect_params_with_prefix().items()},
                format="binary")


def test_resnet18_params_cross_both_packages(tmp_path):
    tmx.random.seed(1)
    src = _port_resnet18()
    want = _weights(src)
    src.save_parameters(str(tmp_path / "port.params"))
    with jmx.name.NameManager():
        jnet = jvision.resnet18_v1(classes=10)
    jnet.load_parameters(str(tmp_path / "port.params"), ctx=jmx.cpu())
    assert set(jnet._collect_params_with_prefix()) == set(want)
    jgot = {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}
    _equal(jgot, want)
    jnet.save_parameters(str(tmp_path / "jax.params"))
    _save_binary(jmx, jnet, tmp_path / "jax_binary.params")
    for fname in ("jax.params", "jax_binary.params"):
        with tmx.name.NameManager():
            net = tvision.resnet18_v1(classes=10)
        net.load_parameters(str(tmp_path / fname), ctx=CPU)
        _equal(_weights(net), want)
        x = tmx.nd.array(np.random.RandomState(2).rand(2, 3, 32, 32)
                         .astype(np.float32), ctx=CPU)
        with tmx.autograd.predict_mode():
            np.testing.assert_array_equal(net(x).asnumpy(),
                                          src(x).asnumpy())
    # a port binary file in the JAX package, and full names
    _save_binary(tmx, src, tmp_path / "port_bin.params")
    src.collect_params().save(str(tmp_path / "full.params"),
                              strip_prefix=src.prefix)
    with jmx.name.NameManager():
        jnet = jvision.resnet18_v1(classes=10)
    jnet.load_parameters(str(tmp_path / "port_bin.params"), ctx=jmx.cpu())
    _equal({k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}, want)
    with tmx.name.NameManager():
        net = tvision.resnet18_v1(classes=10)
    net.collect_params().load(str(tmp_path / "full.params"), ctx=CPU,
                              restore_prefix=net.prefix)
    _equal(_weights(net), want)


def test_load_parameters_checks_names(tmp_path):
    net = _port_resnet18()
    net.save_parameters(str(tmp_path / "a.params"))
    with tmx.name.NameManager():
        other = tvision.resnet18_v1(classes=7)
    with pytest.raises(MXNetError):
        other.load_parameters(str(tmp_path / "a.params"), ctx=CPU)
    small = tmx.gluon.nn.Dense(2, in_units=3)
    with pytest.raises(MXNetError, match="not present"):
        small.load_parameters(str(tmp_path / "a.params"), ctx=CPU,
                              allow_missing=True)


# ---------------------------------------------------------------------------
# model store
# ---------------------------------------------------------------------------

def test_pretrained_from_a_local_root(tmp_path, monkeypatch):
    monkeypatch.delenv("MXNET_GLUON_REPO", raising=False)
    src = _port_resnet18()
    src.save_parameters(str(tmp_path / "resnet18_v1.params"))
    with tmx.name.NameManager():
        net = tvision.get_model("resnet18_v1", pretrained=True, classes=10,
                                root=str(tmp_path), ctx=CPU)
    _equal(_weights(net), _weights(src))
    # and the JAX package reads the same store
    with jmx.name.NameManager():
        jnet = jvision.get_model("resnet18_v1", pretrained=True, classes=10,
                                 root=str(tmp_path), ctx=jmx.cpu())
    _equal({k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()},
           _weights(src))


@pytest.mark.parametrize("fmt", ["npz", "binary"])
def test_pretrained_loads_the_local_file_itself(tmp_path, monkeypatch, fmt):
    """A local file of either format is what get_model reads, unchanged,
    though a mirror is configured."""
    mirror = tmp_path / "mirror"
    mirror.mkdir()
    monkeypatch.setenv("MXNET_GLUON_REPO", "file://%s" % mirror)
    src = _port_resnet18()
    fname = tmp_path / "resnet18_v1.params"
    if fmt == "npz":
        src.save_parameters(str(fname))
    else:
        _save_binary(tmx, src, fname)
    before = fname.read_bytes()
    with tmx.name.NameManager():
        net = tvision.get_model("resnet18_v1", pretrained=True, classes=10,
                                root=str(tmp_path), ctx=CPU)
    assert fname.read_bytes() == before
    assert not list(mirror.iterdir())
    _equal(_weights(net), _weights(src))


def test_pretrained_through_a_file_mirror(tmp_path, monkeypatch):
    mirror, root = tmp_path / "mirror", tmp_path / "root"
    mirror.mkdir()
    src = _port_resnet18()
    _save_binary(tmx, src, mirror / "resnet18_v1.params")
    sha1 = hashlib.sha1((mirror / "resnet18_v1.params").read_bytes())\
        .hexdigest()
    monkeypatch.setenv("MXNET_GLUON_REPO", "file://%s" % mirror)
    monkeypatch.setitem(model_store._model_sha1, "resnet18_v1", sha1)
    with tmx.name.NameManager():
        net = tvision.resnet18_v1(pretrained=True, classes=10,
                                  root=str(root), ctx=CPU)
    assert (root / "resnet18_v1.params").exists()
    assert tutils.check_sha1(str(root / "resnet18_v1.params"), sha1)
    assert model_store.short_hash("resnet18_v1") == sha1[:8]
    _equal(_weights(net), _weights(src))


def test_check_sha1_refuses_a_corrupted_file(tmp_path, monkeypatch):
    mirror, root = tmp_path / "mirror", tmp_path / "root"
    mirror.mkdir()
    good = b"weights" * 100
    sha1 = hashlib.sha1(good).hexdigest()
    (mirror / "resnet18_v1.params").write_bytes(good[:-1] + b"!")
    assert not tutils.check_sha1(str(mirror / "resnet18_v1.params"), sha1)
    monkeypatch.setenv("MXNET_GLUON_REPO", "file://%s" % mirror)
    monkeypatch.setitem(model_store._model_sha1, "resnet18_v1", sha1)
    with pytest.raises(OSError, match="sha1 mismatch"):
        tutils.download("file://%s/resnet18_v1.params" % mirror,
                        path=str(root / "x.params"), sha1_hash=sha1,
                        retries=2)
    assert not (root / "x.params").exists()
    with pytest.raises(OSError, match="sha1 mismatch"):
        model_store.get_model_file("resnet18_v1", root=str(root))
    assert not (root / "resnet18_v1.params").exists()
    # a corrupted local copy is fetched again from the mirror
    (mirror / "resnet18_v1.params").write_bytes(good)
    root.mkdir(exist_ok=True)
    (root / "resnet18_v1.params").write_bytes(b"torn")
    fname = model_store.get_model_file("resnet18_v1", root=str(root))
    assert tutils.check_sha1(fname, sha1)


def test_download_keeps_a_good_file_and_names_it(tmp_path):
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "a.bin").write_bytes(b"abc")
    out = tutils.download("file://%s/m/a.bin" % tmp_path, path=str(tmp_path))
    assert out == str(tmp_path / "a.bin")
    (tmp_path / "m" / "a.bin").write_bytes(b"new")
    assert open(tutils.download("file://%s/m/a.bin" % tmp_path,
                                path=str(tmp_path)), "rb").read() == b"abc"
    assert open(tutils.download("file://%s/m/a.bin" % tmp_path,
                                path=str(tmp_path), overwrite=True),
                "rb").read() == b"new"


# ---------------------------------------------------------------------------
# Parameter, ParameterDict, Block
# ---------------------------------------------------------------------------

def _dense(pkg, ctx):
    with pkg.name.NameManager():
        net = pkg.gluon.nn.Dense(2, in_units=3)
    net.initialize(pkg.init.One(), ctx=ctx)
    x = pkg.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=ctx)
    with pkg.autograd.record():
        y = net(x).sum()
    y.backward()
    return net


def test_parameter_dict_methods_match_jax(tmp_path):
    tnet, jnet = _dense(tmx, CPU), _dense(jmx, jmx.cpu())
    for net in (tnet, jnet):
        params = net.collect_params()
        params.setattr("lr_mult", 0.1)
        assert all(p.lr_mult == 0.1 for p in params.values())
        assert params["dense0_weight"].grad().asnumpy().any()
        params.zero_grad()
        assert not any(p.grad().asnumpy().any() for p in params.values())
    tnet.collect_params().save(str(tmp_path / "t.params"))
    jnet.collect_params().save(str(tmp_path / "j.params"))
    assert sorted(_read(tmx, tmp_path / "j.params")) == \
        sorted(_read(jmx, tmp_path / "t.params"))
    tnet.collect_params().reset_ctx([CPU])
    assert tnet.weight.list_ctx() == [CPU]
    np.testing.assert_array_equal(tnet.weight.data().asnumpy(),
                                  jnet.weight.data().asnumpy())
    assert tnet.weight.grad().shape == (2, 3)


def test_parameter_cast_and_block_cast_keep_batchnorm_f32():
    with tmx.name.NameManager():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Conv2D(4, 3, in_channels=2),
                tmx.gluon.nn.BatchNorm(in_channels=4),
                tmx.gluon.nn.Dense(3, in_units=4 * 4 * 4))
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    x = np.random.RandomState(0).rand(2, 2, 6, 6).astype(np.float32)
    with tmx.autograd.predict_mode():
        ref = net(tmx.nd.array(x, ctx=CPU)).asnumpy()
    net.cast("float16")
    dtypes = {n: p.data().dtype for n, p in net.collect_params().items()}
    assert all(d == (np.float32 if "batchnorm" in n else np.float16)
               for n, d in dtypes.items()), dtypes
    assert all(p.grad().dtype == p.data().dtype
               for p in net.collect_params().values()
               if p.grad_req != "null")
    with tmx.autograd.predict_mode():
        got = net(tmx.nd.array(x, ctx=CPU, dtype="float16")).asnumpy()
    assert got.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32), ref, rtol=5e-2,
                               atol=5e-2)


def test_constant_and_get_merge_match_jax():
    for pkg in (tmx, jmx):
        params = pkg.gluon.ParameterDict("p_")
        c = params.get_constant("c", [[1.0, 2.0]])
        assert c.grad_req == "null" and c.shape == (1, 2)
        assert params.get_constant("c") is c
        with pytest.raises(Exception):
            params.get_constant("missing")
        w = params.get("w", shape=(0, 3))
        assert params.get("w", shape=(4, 0), init="zeros") is w
        assert w.shape == (4, 3)
        c.initialize(ctx=CPU if pkg is tmx else jmx.cpu())
        np.testing.assert_array_equal(c.data().asnumpy(), [[1.0, 2.0]])


def test_block_hooks_apply_and_summary(capsys):
    with tmx.name.NameManager():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(4), tmx.gluon.nn.Dense(2))
    calls = []
    handle = net.register_forward_pre_hook(
        lambda blk, args: calls.append(("pre", args[0].shape)))
    net.register_forward_hook(
        lambda blk, args, out: calls.append(("post", out.shape)))
    net.initialize(tmx.init.One(), ctx=CPU)
    net(tmx.nd.array(np.ones((5, 3), np.float32), ctx=CPU))
    assert calls == [("pre", (5, 3)), ("post", (5, 2))]
    handle.detach()
    seen = []
    assert net.apply(lambda b: seen.append(b.name)) is net
    assert seen[-1] == net.name and len(seen) == 3
    net.summary()
    out = capsys.readouterr().out
    assert "dense0" in out and "16" in out and "10" in out
    with tmx.name.NameManager():
        jnet = jmx.gluon.nn.HybridSequential()
        jnet.add(jmx.gluon.nn.Dense(4), jmx.gluon.nn.Dense(2))
    assert sorted(net._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())


def test_infer_shape_completes_deferred_shapes():
    dense = tmx.gluon.nn.Dense(4)
    dense.infer_shape(tmx.nd.array(np.zeros((2, 7), np.float32), ctx=CPU))
    assert dense.weight.shape == (4, 7)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _init_value(pkg, init, name, shape):
    ctx = CPU if pkg is tmx else jmx.cpu()
    arr = pkg.nd.zeros(shape, ctx=ctx)
    init(pkg.init.InitDesc(name), arr)
    return arr.asnumpy()


@pytest.mark.parametrize("make,name,shape", [
    (lambda pkg: pkg.init.Bilinear(), "up_weight", (2, 1, 4, 4)),
    (lambda pkg: pkg.init.Bilinear(), "up_weight", (1, 1, 3, 5)),
    (lambda pkg: pkg.init.LSTMBias(forget_bias=2.0), "lstm_bias", (16,)),
    (lambda pkg: pkg.init.LSTMBias(), "lstm_i2h_weight", (8,)),
    (lambda pkg: pkg.init.Load(
        {"arg:fc_weight": np.arange(6, dtype=np.float32).reshape(2, 3)},
        default_init=pkg.init.One()), "fc_weight", (2, 3)),
    (lambda pkg: pkg.init.Load({}, default_init=pkg.init.Constant(3.0)),
     "fc_bias", (4,)),
    (lambda pkg: pkg.init.Mixed(["^.*bias$", ".*"],
                                [pkg.init.Constant(2.0), pkg.init.One()]),
     "fc_bias", (3,)),
    (lambda pkg: pkg.init.Mixed(["^.*bias$", ".*"],
                                [pkg.init.Constant(2.0), pkg.init.One()]),
     "fc_weight", (2, 2)),
    (lambda pkg: pkg.init.Zero(), "bn_moving_avg", (3,)),
    (lambda pkg: pkg.init.One(), "q_min", (2,)),
], ids=["bilinear", "bilinear-odd", "lstm-bias", "lstm-weight", "load",
        "load-default", "mixed-bias", "mixed-weight", "moving-avg", "min"])
def test_initializer_matches_jax_exactly(make, name, shape):
    got = _init_value(tmx, make(tmx), name, shape)
    want = _init_value(jmx, make(jmx), name, shape)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_initializer_attr_dispatch_dumps_and_verbosity():
    for pkg in (tmx, jmx):
        init = pkg.init.Constant(0.5)
        assert json.loads(init.dumps()) == ["constant", {"value": 0.5}]
        assert init.set_verbosity(False) is init
        desc = pkg.init.InitDesc(
            "x_weight", attrs={"__init__": pkg.init.Constant(4.0).dumps()})
        arr = pkg.nd.zeros((2,), ctx=CPU) if pkg is tmx \
            else pkg.nd.zeros((2,))
        pkg.init.Uniform()(desc, arr)
        np.testing.assert_array_equal(arr.asnumpy(), [4.0, 4.0])
    assert json.loads(tmx.init.MSRAPrelu(slope=0.1).dumps()) == \
        json.loads(jmx.init.MSRAPrelu(slope=0.1).dumps())


@pytest.mark.parametrize("shape", [(6, 4), (3, 2, 2, 2), (4, 9)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_is_scaled_orthonormal(shape, rand_type):
    tmx.random.seed(0)
    w = _init_value(tmx, tmx.init.Orthogonal(scale=1.5, rand_type=rand_type),
                    "fc_weight", shape)
    m = w.reshape(shape[0], -1) / 1.5
    small = min(m.shape)
    gram = m @ m.T if m.shape[0] == small else m.T @ m
    np.testing.assert_allclose(gram, np.eye(small), atol=1e-5)


def test_msraprelu_spread():
    tmx.random.seed(0)
    shape, slope = (256, 64, 2, 2), 0.25
    w = _init_value(tmx, tmx.init.MSRAPrelu(slope=slope), "conv_weight",
                    shape)
    fan = (64 * 4 + 256 * 4) / 2.0
    want = np.sqrt(2.0 / (1 + slope ** 2) / fan)
    assert abs(w.std() / want - 1) < 0.05
    assert abs(w.mean()) < 0.05 * want
