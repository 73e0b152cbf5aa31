"""The port's ``gluon.contrib`` held against the JAX package's on the CPU:
the counterparts of tests/test_gluon_contrib.py's 17 cases.  Where the
JAX case checks shapes or properties, the port's case also runs the JAX
block on the same weights (``convert.load_from_numpy``) and inputs (a
numpy seed) and holds the outputs to it at rtol 1e-5, atol 1e-6 (1e-5
for gradients); the dropout cases, whose masks come from each package's
own generator, check the same properties as the JAX cases.  JAX matmuls
at ``default_matmul_precision("float32")``, torch at ``"highest"``."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.base import MXNetError as JMXNetError

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def _nd(pkg, a):
    return pkg.nd.array(a, ctx=tmx.cpu()) if pkg is tmx else pkg.nd.array(a)


def _ctx(pkg):
    return tmx.cpu() if pkg is tmx else jmx.cpu()


def _u(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _pair(make, probe, seed=1):
    """``make(pkg)`` in both packages; the JAX block initialized, run on
    ``probe`` (deferred shapes), its weights drawn from a seed and
    carried into the port's."""
    blocks = {}
    for pkg in (jmx, tmx):
        with pkg.name.NameManager():
            blk = make(pkg)
        blk.initialize(ctx=_ctx(pkg))
        blocks[pkg] = blk
    with jmx.autograd.pause():
        probe(jmx, blocks[jmx])
    rng = np.random.RandomState(seed)
    weights = {}
    for name, p in sorted(blocks[jmx].collect_params().items()):
        v = (rng.randn(*p.data().shape) * 0.3).astype(np.float32)
        p.set_data(jmx.nd.array(v))
        weights[name] = v
    tmx.convert.load_from_numpy(blocks[tmx], weights)
    return blocks[jmx], blocks[tmx]


def _close(a, b, atol=ATOL):
    a = a.asnumpy() if hasattr(a, "asnumpy") else a
    b = b.asnumpy() if hasattr(b, "asnumpy") else b
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol)


CONV = [("Conv1DRNNCell", 1, 1), ("Conv2DRNNCell", 2, 1),
        ("Conv3DRNNCell", 3, 1), ("Conv1DLSTMCell", 1, 4),
        ("Conv2DLSTMCell", 2, 4), ("Conv3DLSTMCell", 3, 4),
        ("Conv1DGRUCell", 1, 3), ("Conv2DGRUCell", 2, 3),
        ("Conv3DGRUCell", 3, 3)]


def _step_twice(pkg, cell, x):
    states = cell.begin_state(batch_size=2, ctx=_ctx(pkg))
    out, new_states = cell(_nd(pkg, x), states)
    out2, new2 = cell(_nd(pkg, x), new_states)
    return out, new_states, out2, new2


@pytest.mark.parametrize("cls,dims,gates", CONV)
def test_conv_cells_step_and_shapes(cls, dims, gates):
    spatial = (8, 7, 6)[:dims]
    in_c, hid = 3, 5
    x = _u((2, in_c) + spatial)

    def make(pkg):
        return getattr(pkg.gluon.contrib.rnn, cls)(
            input_shape=(in_c,) + spatial, hidden_channels=hid,
            i2h_kernel=3, h2h_kernel=3, i2h_pad=1)

    jc, tc = _pair(make, lambda pkg, c: _step_twice(pkg, c, x))
    got, want = _step_twice(tmx, tc, x), _step_twice(jmx, jc, x)
    assert got[0].shape == (2, hid) + spatial
    for s in got[1]:
        assert s.shape == (2, hid) + spatial
    assert tc.i2h_weight.shape[0] == hid * gates
    _close(got[0], want[0])
    _close(got[2], want[2])
    for g, w in zip(got[3], want[3]):
        _close(g, w)


def _conv_lstm(pkg):
    return pkg.gluon.contrib.rnn.Conv2DLSTMCell(
        input_shape=(2, 6, 6), hidden_channels=4, i2h_kernel=3,
        h2h_kernel=3, i2h_pad=1)


def test_conv_lstm_unroll_grad():
    x = _u((3, 5, 2, 6, 6), seed=2)
    jc, tc = _pair(_conv_lstm, lambda pkg, c: c.unroll(
        5, _nd(pkg, x), layout="NTC", merge_outputs=True))
    res = {}
    for pkg, cell in ((jmx, jc), (tmx, tc)):
        with pkg.autograd.record():
            outputs, _ = cell.unroll(5, _nd(pkg, x), layout="NTC",
                                     merge_outputs=True)
            loss = outputs.sum()
        loss.backward()
        res[pkg] = (outputs.asnumpy(), cell.i2h_weight.grad().asnumpy())
    assert res[tmx][0].shape == (3, 5, 4, 6, 6)
    assert np.isfinite(res[tmx][1]).all() and np.abs(res[tmx][1]).sum() > 0
    _close(res[tmx][0], res[jmx][0])
    _close(res[tmx][1], res[jmx][1], atol=1e-5)


def test_conv_cell_i2h_shrinks_without_pad():
    x = _u((2, 2, 10), seed=3)

    def make(pkg):
        return pkg.gluon.contrib.rnn.Conv1DRNNCell(
            input_shape=(2, 10), hidden_channels=3, i2h_kernel=3,
            h2h_kernel=3)

    def run(pkg, c):
        return c(_nd(pkg, x), c.begin_state(batch_size=2, ctx=_ctx(pkg)))[0]

    jc, tc = _pair(make, run)
    out = run(tmx, tc)
    assert out.shape == (2, 3, 8)
    _close(out, run(jmx, jc))


def test_conv_cell_rejects_even_h2h_and_channel_last():
    rnn = tmx.gluon.contrib.rnn
    with pytest.raises(AssertionError):
        rnn.Conv1DRNNCell(input_shape=(2, 8), hidden_channels=3,
                          i2h_kernel=3, h2h_kernel=2)
    with pytest.raises(NotImplementedError):
        rnn.Conv1DRNNCell(input_shape=(8, 2), hidden_channels=3,
                          i2h_kernel=3, h2h_kernel=3, conv_layout="NWC")


def test_variational_dropout_mask_locked_across_steps():
    base = tmx.gluon.rnn.RNNCell(16)
    cell = tmx.gluon.contrib.rnn.VariationalDropoutCell(base,
                                                        drop_inputs=0.5)
    cell.initialize(ctx=tmx.cpu())
    x = tmx.nd.ones((4, 16), ctx=tmx.cpu())
    states = cell.begin_state(batch_size=4, ctx=tmx.cpu())
    with tmx.autograd.record():
        cell(x, states)
        m_first = cell._masks["inputs"].asnumpy()
        cell(x, states)
    m1 = cell._masks["inputs"].asnumpy()
    np.testing.assert_array_equal(m_first, m1)   # one mask a sequence
    cell.reset()
    with tmx.autograd.record():
        cell(x, cell.begin_state(batch_size=4, ctx=tmx.cpu()))
    m2 = cell._masks["inputs"].asnumpy()
    assert m1.shape == (4, 16)
    assert not np.array_equal(m1, m2)
    assert set(np.unique(m1)) <= {0.0, 2.0}


def test_variational_dropout_unroll_masks_per_sequence():
    base = tmx.gluon.rnn.LSTMCell(8)
    cell = tmx.gluon.contrib.rnn.VariationalDropoutCell(
        base, drop_outputs=0.3, drop_states=0.3)
    cell.initialize(ctx=tmx.cpu())
    x = tmx.nd.array(_u((2, 6, 8)), ctx=tmx.cpu())
    with tmx.autograd.record():
        out, states = cell.unroll(6, x, layout="NTC", merge_outputs=True)
    assert out.shape == (2, 6, 8)
    assert len(states) == 2


def _lstmp(pkg):
    return pkg.gluon.contrib.rnn.LSTMPCell(hidden_size=12,
                                           projection_size=5, input_size=7)


def test_lstmp_cell_projection():
    x, seq = _u((4, 7), seed=4), _u((4, 3, 7), seed=5)
    jc, tc = _pair(_lstmp, lambda pkg, c: c(
        _nd(pkg, x), c.begin_state(batch_size=4, ctx=_ctx(pkg))))
    states = tc.begin_state(batch_size=4, ctx=tmx.cpu())
    assert states[0].shape == (4, 5) and states[1].shape == (4, 12)
    out, new_states = tc(_nd(tmx, x), states)
    assert out.shape == (4, 5)
    assert new_states[0].shape == (4, 5) and new_states[1].shape == (4, 12)
    want, _ = jc(_nd(jmx, x), jc.begin_state(batch_size=4))
    _close(out, want)
    grads = {}
    for pkg, cell in ((jmx, jc), (tmx, tc)):
        with pkg.autograd.record():
            outs, _ = cell.unroll(3, _nd(pkg, seq), layout="NTC",
                                  merge_outputs=True)
            outs.sum().backward()
        grads[pkg] = cell.h2r_weight.grad().asnumpy()
    assert np.abs(grads[tmx]).sum() > 0
    _close(grads[tmx], grads[jmx], atol=1e-5)


def test_dynamic_unroll_matches_cell_unroll():
    x = _u((5, 2, 9), seed=6)

    def make(pkg):
        return pkg.gluon.rnn.GRUCell(9, input_size=9)

    jc, tc = _pair(make, lambda pkg, c: c.unroll(
        5, _nd(pkg, x), layout="TNC", merge_outputs=True))
    res = {}
    for pkg, cell in ((jmx, jc), (tmx, tc)):
        begin = cell.begin_state(batch_size=2, ctx=_ctx(pkg))
        res[pkg] = (pkg.gluon.contrib.rnn.dynamic_unroll(
            cell, _nd(pkg, x), begin, layout="TNC"),
            cell.unroll(5, _nd(pkg, x), begin_state=begin, layout="TNC",
                        merge_outputs=True))
    (o1, s1), (o2, s2) = res[tmx]
    _close(o1, o2)
    _close(s1[0], s2[0])
    _close(o1, res[jmx][0][0])
    _close(s1[0], res[jmx][0][1][0])


def test_dynamic_unroll_valid_length():
    x = _u((6, 3, 4), seed=7)

    def make(pkg):
        return pkg.gluon.rnn.RNNCell(4, input_size=4)

    jc, tc = _pair(make, lambda pkg, c: c.unroll(
        6, _nd(pkg, x), layout="TNC"))
    vl = np.array([2, 4, 6], np.float32)
    res = {}
    for pkg, cell in ((jmx, jc), (tmx, tc)):
        begin = cell.begin_state(batch_size=3, ctx=_ctx(pkg))
        res[pkg] = pkg.gluon.contrib.rnn.dynamic_unroll(
            cell, _nd(pkg, x), begin, layout="TNC",
            valid_length=_nd(pkg, vl))
    out, states = res[tmx]
    o = out.asnumpy()
    assert (o[2:, 0] == 0).all() and (o[4:, 1] == 0).all()
    begin = tc.begin_state(batch_size=3, ctx=tmx.cpu())
    _, st = tmx.gluon.contrib.rnn.dynamic_unroll(tc, _nd(tmx, x[:2]), begin,
                                                 layout="TNC")
    _close(states[0].asnumpy()[0], st[0].asnumpy()[0])
    _close(out, res[jmx][0])
    _close(states[0], res[jmx][1][0])


def test_pixelshuffle_shapes_and_values():
    c = tmx.gluon.contrib
    z = lambda *s: tmx.nd.zeros(s, ctx=tmx.cpu())  # noqa: E731
    assert c.PixelShuffle1D(2)(z(1, 8, 3)).shape == (1, 4, 6)
    assert c.PixelShuffle2D((2, 3))(z(1, 12, 3, 5)).shape == (1, 2, 6, 15)
    assert c.PixelShuffle3D((2, 3, 4))(z(1, 48, 3, 5, 7)).shape == \
        (1, 2, 6, 15, 28)
    xin = np.arange(4 * 3).reshape(1, 4, 3).astype(np.float32)
    y = c.PixelShuffle1D(2)(_nd(tmx, xin)).asnumpy()
    for ch in range(2):
        for w in range(3):
            for i in range(2):
                assert y[0, ch, w * 2 + i] == xin[0, ch * 2 + i, w]
    for dims, factor in ((1, 2), (2, (2, 3)), (3, (2, 1, 2))):
        shape = (2, 24) + (3, 4, 2)[:dims]
        v = _u(shape, seed=dims)
        cls = "PixelShuffle%dD" % dims
        _close(getattr(c, cls)(factor)(_nd(tmx, v)),
               getattr(jmx.gluon.contrib, cls)(factor)(_nd(jmx, v)))


def test_pixelshuffle_hybridized():
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.contrib.PixelShuffle2D(2))
    net.hybridize()
    v = _u((2, 8, 4, 4), seed=8)
    out = net(_nd(tmx, v))
    assert out.shape == (2, 2, 8, 8)
    _close(out, jmx.gluon.contrib.PixelShuffle2D(2)(_nd(jmx, v)))


def test_sparse_embedding_trains():
    idx = np.array([1, 3, 3, 7], np.float32)

    def make(pkg):
        return pkg.gluon.contrib.SparseEmbedding(50, 8)

    je, te = _pair(make, lambda pkg, e: e(_nd(pkg, idx)))
    res = {}
    for pkg, emb in ((jmx, je), (tmx, te)):
        with pkg.autograd.record():
            out = emb(_nd(pkg, idx))
            (out * 2).sum().backward()
        res[pkg] = (out.asnumpy(), emb.weight.grad().asnumpy())
    out, g = res[tmx]
    assert out.shape == (4, 8) and g.shape == (50, 8)
    assert np.abs(g[[1, 3, 7]]).sum() > 0
    assert np.abs(g[[0, 2, 4]]).sum() == 0
    _close(out, res[jmx][0])
    _close(g, res[jmx][1])


def test_concurrent_layers():
    x = _u((2, 3), seed=9)

    def make(pkg):
        net = pkg.gluon.contrib.HybridConcurrent(axis=1)
        net.add(pkg.gluon.nn.Dense(4, in_units=3),
                pkg.gluon.nn.Dense(6, in_units=3),
                pkg.gluon.contrib.Identity())
        return net

    jn, tn = _pair(make, lambda pkg, n: n(_nd(pkg, x)))
    out = tn(_nd(tmx, x))
    assert out.shape == (2, 4 + 6 + 3)
    _close(out, jn(_nd(jmx, x)))
    assert issubclass(tmx.gluon.contrib.Concurrent,
                      tmx.gluon.contrib.HybridConcurrent)
    bn = tmx.gluon.contrib.SyncBatchNorm(in_channels=3)
    assert isinstance(bn, tmx.gluon.nn.BatchNorm)


def test_interval_sampler():
    s = tmx.gluon.contrib.data.IntervalSampler
    assert list(s(13, interval=3)) == [0, 3, 6, 9, 12, 1, 4, 7, 10, 2, 5,
                                       8, 11]
    assert list(s(13, interval=3, rollover=False)) == [0, 3, 6, 9, 12]
    assert len(s(13, interval=3)) == 13
    j = jmx.gluon.contrib.data.IntervalSampler
    for args in ((13, 3), (10, 4), (5, 5)):
        for roll in (True, False):
            assert list(s(*args, rollover=roll)) == \
                list(j(*args, rollover=roll))
            assert len(s(*args, rollover=roll)) == len(j(*args,
                                                          rollover=roll))


def test_wikitext_local_file(tmp_path):
    text = "hello world\nfoo bar baz\nhello foo\nzeta alpha foo\n"
    (tmp_path / "wiki.train.tokens").write_text(text)
    ds = tmx.gluon.contrib.data.WikiText2(root=str(tmp_path),
                                          segment="train", seq_len=4)
    ref = jmx.gluon.contrib.data.WikiText2(root=str(tmp_path),
                                           segment="train", seq_len=4)
    # 11 tokens + 4 <eos> = 15 -> 3 samples of 4
    assert len(ds) == len(ref) == 3
    d, lab = ds[0]
    assert d.shape == (4,) and lab.shape == (4,)
    flat_d = np.concatenate([ds[i][0].asnumpy() for i in range(len(ds))])
    flat_l = np.concatenate([ds[i][1].asnumpy() for i in range(len(ds))])
    np.testing.assert_array_equal(flat_d[1:], flat_l[:-1])
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i][0].asnumpy(),
                                      ref[i][0].asnumpy())
        np.testing.assert_array_equal(ds[i][1].asnumpy(),
                                      ref[i][1].asnumpy())
    assert ds.vocabulary.idx_to_token == ref.vocabulary.idx_to_token
    assert ds.vocabulary.to_indices("<eos>") in flat_d
    assert ds.frequencies == ref.frequencies


def test_wikitext_missing_file_error(tmp_path):
    with pytest.raises(MXNetError, match="token file"):
        tmx.gluon.contrib.data.WikiText2(root=str(tmp_path / "nope"))
    with pytest.raises(JMXNetError, match="token file"):
        jmx.gluon.contrib.data.WikiText2(root=str(tmp_path / "nope"))


def test_variational_dropout_identity_at_inference():
    x = np.ones((4, 16), np.float32)

    def make(pkg):
        base = pkg.gluon.rnn.RNNCell(16, input_size=16)
        return pkg.gluon.contrib.rnn.VariationalDropoutCell(
            base, drop_inputs=0.5, drop_outputs=0.5)

    def run(pkg, c):
        c.reset()
        return c(_nd(pkg, x), c.begin_state(batch_size=4, ctx=_ctx(pkg)))[0]

    jc, tc = _pair(make, run)
    o1, o2 = run(tmx, tc), run(tmx, tc)
    np.testing.assert_array_equal(o1.asnumpy(), o2.asnumpy())
    _close(o1, run(jmx, jc))
