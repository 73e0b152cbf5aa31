"""The port's transformer LM (mxnet_tpu_torch/examples/transformer_lm.py)
held against the JAX package's examples/transformer_lm.py on CPU, with
the JAX LM's weights carried across by name.

At tests/test_generate.py:44's size (vocab 48, d_model 32, 2 heads, 2
layers, max_len 24): parameter names equal letter for letter; forward
logits within rtol 1e-5 / atol 1e-6 of JAX's; prefill logits bit-equal
to the port's own full forward, its K/V within 1e-6 + 1e-6 |ref| of
JAX's (K near 1 differs by up to 9 f32 ulps, 1.07e-6); ring decode
logits within atol 2e-5 / rtol 1e-5 of the full forward with the same
argmax (tests/test_generate.py:92-119); a ring that wraps (cache 8 <
max_len) against JAX's decode_forward step by step at the same bound,
with every untouched cache entry kept bit for bit; ``bf16_mixed`` logits
within atol 0.12 / rtol 0.05 of JAX's with the dtypes of the logits, the
K/V and every block output equal.  Matmul precision is pinned: JAX to
"float32", torch to "highest".
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu import dtype_policy as jdtp
from mxnet_tpu.gluon import block as jblock
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import dtype_policy as tdtp
from mxnet_tpu_torch.examples import transformer_lm as tlm
from mxnet_tpu_torch.gluon import block as tblock
from mxnet_tpu_torch.name import NameManager as TNameManager

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import transformer_lm as jlm  # noqa: E402

VOCAB, D_MODEL, N_HEADS, N_LAYERS, MAX_LEN = 48, 32, 2, 2, 24
DH = D_MODEL // N_HEADS
CFG = dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=N_HEADS,
           n_layers=N_LAYERS, max_len=MAX_LEN)


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def make_pair(seed=0):
    """The JAX LM (Xavier from a seed, deferred shapes finished) and the
    port's LM loaded with its weights, both named from transformerlm0."""
    jmx.random.seed(seed)
    with JNameManager():
        jnet = jlm.TransformerLM(**CFG)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(np.zeros((1, 4), np.float32)))
    weights = {n: p.data().asnumpy()
               for n, p in jnet.collect_params().items()}
    with TNameManager():
        tnet = tlm.TransformerLM(**CFG)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    tmx.convert.load_from_numpy(tnet, weights)
    return jnet, tnet, weights


@pytest.fixture(scope="module")
def pair():
    with jax.default_matmul_precision("float32"):
        return make_pair()


def _tokens(shape, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, shape)


def _tlogits(tnet, tokens):
    return tnet(tmx.nd.array(np.asarray(tokens, np.float32),
                             ctx=tmx.cpu())).asnumpy()


def _jlogits(jnet, tokens):
    return jnet(jmx.nd.array(np.asarray(tokens, np.float32))).asnumpy()


def test_parameter_names_match_letter_for_letter(pair):
    jnet, tnet, weights = pair
    names = sorted(tnet.collect_params().keys())
    assert names == sorted(jnet.collect_params().keys()) == sorted(weights)
    assert "transformerlm0_h0_ln1_gamma" in names
    assert "transformerlm0_h1_ffn_up_bias" in names
    for n, p in tnet.collect_params().items():
        assert p.data().shape == weights[n].shape, n
    assert tnet.config == jnet.config
    assert tnet.flops_per_token(16) == jnet.flops_per_token(16)


def test_forward_logits_match_jax(pair):
    jnet, tnet, _ = pair
    toks = _tokens((2, 10))
    np.testing.assert_allclose(_tlogits(tnet, toks), _jlogits(jnet, toks),
                               rtol=1e-5, atol=1e-6)


def test_prefill_bit_equal_to_own_forward_and_kv_match_jax(pair):
    jnet, tnet, _ = pair
    toks = _tokens((1, 7), seed=1)
    logits_nd, caches = tnet.prefill_forward(
        tmx.nd.array(toks.astype(np.float32), ctx=tmx.cpu()))
    np.testing.assert_array_equal(logits_nd.asnumpy(), _tlogits(tnet, toks))
    _jl, jcaches = jnet.prefill_forward(
        jmx.nd.array(toks.astype(np.float32)))
    assert len(caches) == N_LAYERS
    for (k, v), (jk, jv) in zip(caches, jcaches):
        assert tuple(k.shape) == (1, N_HEADS, 7, DH)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6,
                                   rtol=1e-6)


def _ring(caches, S, n):
    ring = []
    for k, v in caches:
        kr = torch.zeros((1, N_HEADS, S, DH))
        vr = torch.zeros_like(kr)
        kr[:, :, :n] = k
        vr[:, :, :n] = v
        ring.append((kr, vr))
    return ring


def test_decode_logits_match_full_forward(pair):
    _jnet, tnet, _ = pair
    seq = list(_tokens(5, seed=2))
    nxt = int(_tlogits(tnet, [seq])[0, -1].argmax())
    _l, caches = tnet.prefill_forward(
        tmx.nd.array(np.asarray([seq], np.float32), ctx=tmx.cpu()))
    ring = _ring(caches, 16, len(seq))
    for _step in range(6):
        seq.append(nxt)
        logits_nd, ring = tnet.decode_forward(
            torch.tensor([nxt]), ring, torch.tensor([len(seq) - 1]))
        got = logits_nd.asnumpy()[0]
        ref = _tlogits(tnet, [seq])[0, -1]
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
        nxt = int(got.argmax())
        assert nxt == int(ref.argmax())


def test_ring_wraparound_matches_jax_decode_forward(pair):
    """A ring of 8 slots, prompt 6, decoded to max_len: each step's
    logits and caches against JAX's decode_forward fed the same tokens
    (JAX's greedy choices); every cache entry but the written slot keeps
    its value bit for bit."""
    jnet, tnet, _ = pair
    S, n = 8, 6
    prompt = _tokens((1, n), seed=3)
    _l, caches = tnet.prefill_forward(
        tmx.nd.array(prompt.astype(np.float32), ctx=tmx.cpu()))
    _jl, jcaches = jnet.prefill_forward(
        jmx.nd.array(prompt.astype(np.float32)))
    ring = _ring(caches, S, n)
    jring = [(jnp.zeros((1, N_HEADS, S, DH)).at[:, :, :n].set(k),
              jnp.zeros((1, N_HEADS, S, DH)).at[:, :, :n].set(v))
             for k, v in jcaches]
    tok = int(np.asarray(_jl._data)[0, -1].argmax())
    for pos in range(n, MAX_LEN):
        before = [(k.clone(), v.clone()) for k, v in ring]
        logits_nd, ring = tnet.decode_forward(
            torch.tensor([tok]), ring, torch.tensor([pos]))
        jlogits, jring = jnet.decode_forward(
            jnp.asarray([tok], jnp.int32), jring,
            jnp.asarray([pos], jnp.int32))
        want = np.asarray(jlogits._data)
        np.testing.assert_allclose(logits_nd.asnumpy(), want, atol=2e-5,
                                   rtol=1e-5)
        keep = torch.ones(S, dtype=torch.bool)
        keep[pos % S] = False
        for (k, v), (bk, bv), (jk, jv) in zip(ring, before, jring):
            assert torch.equal(k[:, :, keep], bk[:, :, keep])
            assert torch.equal(v[:, :, keep], bv[:, :, keep])
            np.testing.assert_allclose(k.numpy(), np.asarray(jk),
                                       atol=2e-5, rtol=1e-5)
            np.testing.assert_allclose(v.numpy(), np.asarray(jv),
                                       atol=2e-5, rtol=1e-5)
        tok = int(want[0].argmax())


def _policy_prefill(pkg_block, pkg_dtp, net, tokens, wrap, hooks):
    """Prefill under bf16_mixed with each parameter cast by the policy,
    recording each decoder block's output dtype."""
    policy = pkg_dtp.get_policy("bf16_mixed")
    params = list(net.collect_params().values())
    cast = [policy.cast_compute(p.name, p.data()._data) for p in params]
    dtypes = []
    handles = [blk.register_forward_hook(
        lambda b, a, out: dtypes.append(str(out._data.dtype).split(".")[-1]))
        for blk in net._blocks] if hooks else []
    with pkg_dtp.scope(policy), pkg_block.swapped_params(params, cast):
        logits_nd, caches = net.prefill_forward(wrap(tokens))
        full = net(wrap(tokens))
    for h in handles:
        h.detach()
    block_dtypes = list(dtypes)
    logits = policy.cast_output(logits_nd._data)
    return (logits, full._data, caches, block_dtypes,
            str(logits_nd._data.dtype).split(".")[-1])


def test_bf16_mixed_matches_jax_with_exact_dtypes(pair):
    jnet, tnet, _ = pair
    toks = _tokens((2, 9), seed=4).astype(np.float32)
    t = _policy_prefill(tblock, tdtp, tnet, toks,
                        lambda a: tmx.nd.array(a, ctx=tmx.cpu()), True)
    j = _policy_prefill(jblock, jdtp, jnet, toks, jmx.nd.array, True)
    assert t[4] == j[4] == "float32"          # the head stays f32
    assert t[3] == j[3] and set(t[3]) == {"bfloat16"}
    assert str(t[0].dtype).split(".")[-1] == np.dtype(j[0].dtype).name
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=0.12,
                               rtol=0.05)
    np.testing.assert_array_equal(t[0].numpy(), t[1].numpy())
    for (k, v), (jk, jv) in zip(t[2], j[2]):
        assert str(k.dtype).split(".")[-1] == np.dtype(jk.dtype).name \
            == "bfloat16"
        np.testing.assert_allclose(k.float().numpy(),
                                   np.asarray(jk, np.float32), atol=0.12,
                                   rtol=0.05)
        np.testing.assert_allclose(v.float().numpy(),
                                   np.asarray(jv, np.float32), atol=0.12,
                                   rtol=0.05)


def test_lm_loss_matches_jax(pair):
    jnet, tnet, _ = pair
    toks = _tokens((2, 6), seed=5).astype(np.float32)
    labels = _tokens((2, 6), seed=6).astype(np.float32)
    t = tlm.lm_loss_fn(VOCAB)(
        tnet(tmx.nd.array(toks, ctx=tmx.cpu())),
        tmx.nd.array(labels, ctx=tmx.cpu())).asnumpy()
    j = jlm.lm_loss_fn(VOCAB)(jnet(jmx.nd.array(toks)),
                              jmx.nd.array(labels)).asnumpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_layers_match_jax_with_deferred_shapes():
    """LayerNorm, Embedding and Dense(flatten=False, activation) built
    with deferred shapes, finished by the first forward, against JAX."""
    x = np.random.RandomState(7).randn(2, 3, 5).astype(np.float32)
    ids = np.array([[1, 0, 3]], np.float32)
    outs = []
    for mx, nn, wrap in (
            (tmx, tmx.gluon.nn, lambda a: tmx.nd.array(a, ctx=tmx.cpu())),
            (jmx, jmx.gluon.nn, jmx.nd.array)):
        mx.random.seed(1)
        with (TNameManager() if mx is tmx else JNameManager()):
            ln = nn.LayerNorm(prefix="ln_")
            dense = nn.Dense(4, flatten=False, activation="relu",
                             prefix="d_")
            emb = nn.Embedding(4, 6, prefix="e_")
        for blk in (ln, dense, emb):
            if mx is tmx:
                blk.initialize(mx.init.Xavier(), ctx=tmx.cpu())
            else:
                blk.initialize(mx.init.Xavier())
        outs.append((ln, dense, emb, wrap))
    (tln, tdense, temb, twrap), (jln, jdense, jemb, jwrap) = outs
    assert jdense(jwrap(x)).shape == (2, 3, 4)
    for tb, jb in ((tln, jln), (tdense, jdense), (temb, jemb)):
        tb_in = ids if tb is temb else x
        if tb is not tln:
            tb(twrap(tb_in))
            tmx.convert.load_from_numpy(
                tb, {n: p.data().asnumpy()
                     for n, p in jb.collect_params().items()})
        np.testing.assert_allclose(tb(twrap(tb_in)).asnumpy(),
                                   jb(jwrap(tb_in)).asnumpy(),
                                   rtol=1e-5, atol=1e-6)
    assert tln.gamma.shape == (5,) and tdense.weight.shape == (4, 5)


def test_abstract_eval_forward_finishes_deferred_init():
    with TNameManager():
        net = tlm.TransformerLM(**CFG)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    assert net.collect_params()["transformerlm0_h0_ln1_gamma"].shape == (0,)
    out = tblock._abstract_eval_forward(
        net, [tmx.nd.zeros((1, 8), ctx=tmx.cpu())])
    assert out.shape == (1, 8, VOCAB)
    for p in net.collect_params().values():
        assert all(s > 0 for s in p.data().shape), p.name


def test_swapped_params_is_local_to_the_thread(pair):
    """Inside swapped_params the parameters read as the given tensors in
    this thread only; another thread sees the block's own."""
    import threading

    _jnet, tnet, _ = pair
    toks = _tokens((1, 5), seed=8)
    ref = _tlogits(tnet, toks)
    params = list(tnet.collect_params().values())
    zeros = [torch.zeros_like(p.data()._data) for p in params]
    seen = {}
    with tblock.swapped_params(params, zeros):
        inside = _tlogits(tnet, toks)
        worker = threading.Thread(
            target=lambda: seen.update(out=_tlogits(tnet, toks)))
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive()
    assert np.all(inside == 0)
    np.testing.assert_array_equal(seen["out"], ref)
    np.testing.assert_array_equal(_tlogits(tnet, toks), ref)
