"""The port's ``gluon.rnn`` held against the JAX package's on the CPU:
the cells' ``unroll`` (merged and per-step outputs, ``valid_length``),
the modifier cells (Zoneout at rate 0, Residual,
Bidirectional with ragged lengths), SequentialRNNCell with a
DropoutCell, the fused RNN/LSTM/GRU layers (one and two layers, one and
two directions, ``TNC`` and ``NTC``) against the JAX layers and against
their own ``_unfuse()`` cell stacks, ``begin_state``/``state_info``, and
a hybridized block over an LSTM against its eager self (forward and
gradients, compiled with ``aot_eager``).  Weights come from the JAX
objects through ``convert.load_from_numpy``; inputs from a numpy seed.
JAX matmuls at ``default_matmul_precision("float32")``, torch at
``"highest"``; rtol 1e-5, atol 1e-6 (gradients: atol 1e-6 x the largest
gradient)."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
T, N, C, H = 5, 3, 4, 6


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


def _x(shape=(N, T, C), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(make, probe, seed=1):
    """The same block built in both packages (``make(pkg)``), the JAX one
    initialized and run once on ``probe`` to finish deferred shapes, its
    weights drawn from a numpy seed and carried into the port's."""
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
        v = (rng.randn(*p.data().shape) * 0.4).astype(np.float32)
        p.set_data(jmx.nd.array(v))
        weights[name] = v
    tmx.convert.load_from_numpy(blocks[tmx], weights)
    return blocks[jmx], blocks[tmx]


def _close(a, b, rtol=RTOL, atol=ATOL):
    a = a.asnumpy() if hasattr(a, "asnumpy") else a
    b = b.asnumpy() if hasattr(b, "asnumpy") else b
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _close_list(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


CELLS = {
    "rnn": lambda pkg: pkg.gluon.rnn.RNNCell(H, activation="tanh",
                                             input_size=C, prefix="rnn_"),
    "rnn_relu": lambda pkg: pkg.gluon.rnn.RNNCell(H, activation="relu",
                                                  input_size=C,
                                                  prefix="rnn_"),
    "lstm": lambda pkg: pkg.gluon.rnn.LSTMCell(H, input_size=C,
                                               prefix="lstm_"),
    "gru": lambda pkg: pkg.gluon.rnn.GRUCell(H, input_size=C,
                                             prefix="gru_"),
}


def _unroll(pkg, cell, x, **kw):
    return cell.unroll(T, _nd(pkg, x), layout="NTC", **kw)


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("ragged", [False, True])
def test_cell_unroll(kind, ragged):
    x = _x()
    jc, tc = _pair(CELLS[kind], lambda pkg, c: _unroll(pkg, c, x))
    kw = {}
    if ragged:
        lengths = np.array([5, 2, 3], np.float32)
        kw = {"valid_length": lengths}
    got = _unroll(tmx, tc, x, merge_outputs=True,
                  **{k: _nd(tmx, v) for k, v in kw.items()})
    want = _unroll(jmx, jc, x, merge_outputs=True,
                   **{k: _nd(jmx, v) for k, v in kw.items()})
    _close(got[0], want[0])
    _close_list(got[1], want[1])
    # per-step outputs
    steps, _ = _unroll(tmx, tc, x, merge_outputs=False,
                       **{k: _nd(tmx, v) for k, v in kw.items()})
    assert len(steps) == T
    _close(np.stack([s.asnumpy() for s in steps], axis=1), want[0])


def test_cell_begin_state_and_state_info():
    cell = tmx.gluon.rnn.LSTMCell(H, input_size=C)
    assert cell.state_info(2) == [{"shape": (2, H), "__layout__": "NC"}] * 2
    states = cell.begin_state(batch_size=2, ctx=tmx.cpu())
    assert [s.shape for s in states] == [(2, H), (2, H)]
    assert all(float(s.abs().sum().asscalar()) == 0 for s in states)
    layer = tmx.gluon.rnn.GRU(H, num_layers=2, bidirectional=True)
    st = layer.begin_state(3, ctx=tmx.cpu())
    assert [s.shape for s in st] == [(4, 3, H)]


def _stack(pkg):
    rnn = pkg.gluon.rnn
    stack = rnn.SequentialRNNCell(prefix="stack_")
    with stack.name_scope():
        stack.add(rnn.LSTMCell(H, input_size=C))
        stack.add(rnn.DropoutCell(0.0))
        stack.add(rnn.ResidualCell(rnn.GRUCell(H, input_size=H)))
    return stack


def _zoneout(pkg):
    return pkg.gluon.rnn.ZoneoutCell(
        pkg.gluon.rnn.LSTMCell(H, input_size=C, prefix="lstm_"),
        zoneout_outputs=0.0, zoneout_states=0.0)


def _bidir(pkg):
    rnn = pkg.gluon.rnn
    return rnn.BidirectionalCell(rnn.LSTMCell(H, input_size=C, prefix="l_"),
                                 rnn.GRUCell(H, input_size=C, prefix="r_"))


@pytest.mark.parametrize("make", [_stack, _zoneout, _bidir],
                         ids=["sequential", "zoneout", "bidirectional"])
@pytest.mark.parametrize("ragged", [False, True])
def test_modifier_cells(make, ragged):
    x = _x(seed=2)
    jc, tc = _pair(make, lambda pkg, c: _unroll(pkg, c, x))
    lengths = np.array([4, 5, 1], np.float32)
    got = _unroll(tmx, tc, x, merge_outputs=True,
                  valid_length=_nd(tmx, lengths) if ragged else None)
    want = _unroll(jmx, jc, x, merge_outputs=True,
                   valid_length=_nd(jmx, lengths) if ragged else None)
    _close(got[0], want[0])
    _close_list(got[1], want[1])


LAYERS = [(kind, layers, bidir) for kind in ("RNN", "LSTM", "GRU")
          for layers in (1, 2) for bidir in (False, True)]


def _layer(kind, layers, bidir, layout="TNC"):
    def make(pkg):
        cls = getattr(pkg.gluon.rnn, kind)
        return cls(H, num_layers=layers, bidirectional=bidir, layout=layout,
                   input_size=C)
    return make


def _states(pkg, layer, seed=4):
    rng = np.random.RandomState(seed)
    return [_nd(pkg, (rng.randn(*info["shape"]) * 0.5).astype(np.float32))
            for info in layer.state_info(N)]


@pytest.mark.parametrize("kind,layers,bidir", LAYERS)
def test_layer_against_jax_and_unfused(kind, layers, bidir):
    x = _x((T, N, C), seed=5)
    jl, tl = _pair(_layer(kind, layers, bidir),
                   lambda pkg, l: l(_nd(pkg, x)))
    got_o, got_s = tl(_nd(tmx, x), _states(tmx, tl))
    want_o, want_s = jl(_nd(jmx, x), _states(jmx, jl))
    _close(got_o, want_o)
    _close_list(got_s, want_s)
    if bidir:
        # a SequentialRNNCell steps its cells one time step at a time,
        # which a BidirectionalCell cannot (in both packages)
        return
    # the layer's parameters drive its _unfuse() stack of cells: the
    # fused op and the cells agree (states from zeros)
    stack = tl._unfuse()
    cells_o, _ = stack.unroll(T, _nd(tmx, x), layout="TNC",
                              merge_outputs=True)
    _close(cells_o, tl(_nd(tmx, x)))


def test_layer_ntc_layout_and_default_states():
    x = _x((N, T, C), seed=6)
    jl, tl = _pair(_layer("LSTM", 2, True, layout="NTC"),
                   lambda pkg, l: l(_nd(pkg, x)))
    got = tl(_nd(tmx, x))
    assert got.shape == (N, T, 2 * H)
    _close(got, jl(_nd(jmx, x)))


def test_layer_parameter_names():
    with tmx.name.NameManager():
        lstm = tmx.gluon.rnn.LSTM(H, num_layers=2, bidirectional=True,
                                  input_size=C)
    names = sorted(lstm.collect_params())
    assert names[0] == "lstm0_l0_h2h_bias"
    assert "lstm0_r1_i2h_weight" in names and len(names) == 16


class _Net:
    """A block over an LSTM, as the word LM's RNNModel: Dense on the
    outputs, the states passed through."""

    @staticmethod
    def make(pkg):
        class Net(pkg.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.rnn = pkg.gluon.rnn.LSTM(H, num_layers=2,
                                                  input_size=C)
                    self.out = pkg.gluon.nn.Dense(3, flatten=False,
                                                  in_units=H)

            def hybrid_forward(self, F, x, *states):
                y, states = self.rnn(x, list(states))
                return self.out(y), states

        return Net()


def _grads(net, x, states, cot):
    with tmx.autograd.record():
        out, new = net(_nd(tmx, x), *states)
        loss = (out * _nd(tmx, cot)).sum() + new[0].sum() + new[1].sum()
    loss.backward()
    return out.asnumpy(), {n: p.grad().asnumpy()
                           for n, p in net.collect_params().items()}


def test_hybridized_lstm_block_against_eager():
    x = _x((T, N, C), seed=7)
    jnet, tnet = _pair(_Net.make,
                       lambda pkg, n: n(_nd(pkg, x),
                                        *n.rnn.begin_state(N)))
    cot = np.random.RandomState(8).randn(T, N, 3).astype(np.float32)
    states = _states(tmx, tnet.rnn)
    eager_out, eager_g = _grads(tnet, x, states, cot)
    tnet.hybridize()
    hyb_out, hyb_g = _grads(tnet, x, states, cot)
    assert len(tnet._cached_op._compiled) == 1
    _close(hyb_out, eager_out)
    scale = max(np.abs(g).max() for g in eager_g.values())
    for name in eager_g:
        _close(hyb_g[name], eager_g[name], atol=ATOL * max(1.0, scale))
    # and the JAX block gives the same outputs
    want, _ = jnet(_nd(jmx, x), *_states(jmx, jnet.rnn))
    _close(hyb_out, want)
