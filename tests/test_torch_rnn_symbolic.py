"""The port's ``mx.rnn`` held against the JAX package's on the CPU: each
symbolic cell (RNN tanh/relu, LSTM, GRU, a SequentialRNNCell with
Dropout(0) and Residual cells, a BidirectionalCell) unrolled, merged and
per step, bound in an Executor on the same numpy arguments (a seed) and
run forward and backward in both packages (outputs and gradients at
rtol 1e-5, atol 1e-6, gradients 1e-5); the argument names and the
LSTM's forget-bias initializer; ``encode_sentences`` and
``BucketSentenceIter`` batch for batch; and ``save_rnn_checkpoint``
written by either package and read by the other's
``load_rnn_checkpoint``.  JAX matmuls at
``default_matmul_precision("float32")``, torch at ``"highest"``."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
T, N, C, H = 4, 3, 5, 6


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def _nd(pkg, a):
    a = np.asarray(a, np.float32)
    return pkg.nd.array(a, ctx=tmx.cpu()) if pkg is tmx else pkg.nd.array(a)


def _ctx(pkg):
    return tmx.cpu() if pkg is tmx else jmx.cpu()


CELLS = {
    "rnn_tanh": lambda r: r.RNNCell(H, activation="tanh", prefix="rnn_"),
    "rnn_relu": lambda r: r.RNNCell(H, activation="relu", prefix="rnn_"),
    "lstm": lambda r: r.LSTMCell(H, prefix="lstm_"),
    "gru": lambda r: r.GRUCell(H, prefix="gru_"),
    "stack": lambda r: r.SequentialRNNCell().add(
        r.LSTMCell(H, prefix="l0_")).add(r.DropoutCell(0.0)).add(
        r.ResidualCell(r.GRUCell(H, prefix="l1_"))),
}


def _graph(pkg, kind, merge):
    with pkg.name.NameManager():   # output names from fresh counters
        return _build_graph(pkg, kind, merge)


def _build_graph(pkg, kind, merge):
    r = pkg.rnn
    if kind == "bidir":
        cell = r.BidirectionalCell(r.LSTMCell(H, prefix="fl_"),
                                   r.GRUCell(H, prefix="bg_"))
    else:
        cell = CELLS[kind](r)
    data = pkg.sym.var("data")
    outs, states = cell.unroll(T, inputs=data, layout="NTC",
                               merge_outputs=merge)
    outs = [outs] if merge else list(outs)
    return pkg.sym.Group(outs + list(states)), cell


def _run(pkg, sym, values):
    shapes = {"data": (N, T, C)}
    for name in sym.list_arguments():
        if name.endswith(("state", "state_cell")):
            shapes[name] = (N, H)
    ex = sym.simple_bind(ctx=_ctx(pkg), grad_req="write", **shapes)
    for name, arr in ex.arg_dict.items():
        arr[:] = _nd(pkg, values[name])
    outs = ex.forward(is_train=True)
    res = [o.asnumpy() for o in outs]
    rng = np.random.RandomState(5)
    ex.backward([_nd(pkg, rng.randn(*o.shape)) for o in res])
    return res, {n: g.asnumpy() for n, g in ex.grad_dict.items()}


def _values(sym, seed=1):
    rng = np.random.RandomState(seed)
    shapes, _, _ = sym.infer_shape(data=(N, T, C), **{
        n: (N, H) for n in sym.list_arguments()
        if n.endswith(("state", "state_cell"))})
    return {n: (rng.randn(*s) * 0.4).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)}


@pytest.mark.parametrize("kind", sorted(CELLS) + ["bidir"])
@pytest.mark.parametrize("merge", [True, False])
def test_cell_unroll_bound(kind, merge):
    tsym, _ = _graph(tmx, kind, merge)
    jsym, _ = _graph(jmx, kind, merge)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    values = _values(jsym)
    got, got_g = _run(tmx, tsym, values)
    want, want_g = _run(jmx, jsym, values)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert set(got_g) == set(want_g)
    for n in want_g:
        np.testing.assert_allclose(got_g[n], want_g[n], rtol=RTOL,
                                   atol=1e-5, err_msg=n)


def test_lstm_forget_bias_initializer():
    """The h2h bias variable carries LSTMBias as its ``__init__``
    attribute; any initializer then fills it through LSTMBias, zeros
    but the forget gate's forget_bias, in both packages."""
    res = []
    for pkg in (tmx, jmx):
        cell = pkg.rnn.LSTMCell(H, prefix="lstm_", forget_bias=2.0)
        outs, _ = cell.unroll(2, inputs=pkg.sym.var("data"),
                              merge_outputs=True)
        attr = outs.attr_dict()["lstm_h2h_bias"]["__init__"]
        b = pkg.nd.zeros((4 * H,), ctx=_ctx(pkg))
        pkg.init.Xavier()(pkg.init.InitDesc("lstm_h2h_bias",
                                            attrs={"__init__": attr}), b)
        res.append(b.asnumpy())
    expect = np.zeros(4 * H, np.float32)
    expect[H:2 * H] = 2.0
    np.testing.assert_array_equal(res[0], expect)
    np.testing.assert_array_equal(res[1], expect)


def test_encode_sentences():
    sents = [["a", "b", "c"], ["b", "d"], ["e"]]
    for kw in ({}, {"invalid_label": 0, "start_label": 1},
               {"vocab": {"\n": -1, "b": 0}}):
        got = tmx.rnn.encode_sentences(
            sents, **{k: (dict(v) if isinstance(v, dict) else v)
                      for k, v in kw.items()})
        want = jmx.rnn.encode_sentences(
            sents, **{k: (dict(v) if isinstance(v, dict) else v)
                      for k, v in kw.items()})
        assert got == want


def test_bucket_sentence_iter():
    rng = np.random.RandomState(0)
    sents = [list(rng.randint(1, 20, rng.randint(2, 12)))
             for _ in range(90)]
    with tmx.cpu():
        it = tmx.rnn.BucketSentenceIter(sents, 4, buckets=[5, 8, 12],
                                        invalid_label=0)
        got = [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
                b.provide_data) for b in it]
    jit = jmx.rnn.BucketSentenceIter(sents, 4, buckets=[5, 8, 12],
                                     invalid_label=0)
    want = [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
             b.provide_data) for b in jit]
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
    assert it.provide_data == jit.provide_data
    assert it.default_bucket_key == 12
    with pytest.raises(ValueError):
        tmx.rnn.BucketSentenceIter([[1]], 2)


@pytest.mark.parametrize("writer,reader", [(tmx, jmx), (jmx, tmx)])
def test_rnn_checkpoint_across_packages(tmp_path, writer, reader):
    sym, _ = _graph(writer, "lstm", True)
    values = _values(sym, seed=3)
    args = {n: _nd(writer, v) for n, v in values.items() if n != "data"}
    prefix = str(tmp_path / "lm")
    writer.rnn.save_rnn_checkpoint(None, prefix, 2, sym, args, {})
    rsym, rargs, raux = reader.rnn.load_rnn_checkpoint(None, prefix, 2)
    assert rsym.list_arguments() == sym.list_arguments()
    assert set(rargs) == set(args) and raux == {}
    for n in args:
        np.testing.assert_array_equal(rargs[n].asnumpy(),
                                      args[n].asnumpy())
    # the epoch-end callback writes every `period` epochs, under the
    # epoch index it is given (as the JAX package's does)
    cb = writer.rnn.do_rnn_checkpoint(None, prefix + "_cb", period=2)
    for epoch in range(4):
        cb(epoch, sym, args, {})
    written = sorted(p.name for p in tmp_path.glob("lm_cb-*.params"))
    assert written == ["lm_cb-0001.params", "lm_cb-0003.params"]
