"""The port's paged KV-cache engine (mxnet_tpu_torch/generate.py
PagedGenerationEngine and the LM's chunk_forward) held against the JAX
package's mxnet_tpu/generate.py on CPU.

The LM of tests/test_paged_decode.py (vocab 48, d_model 32, 2 heads, 2
layers, max_len 24; the JAX LM's weights carried across by name), engines
with page 4 and prefill chunk 8:

* ``chunk_forward`` logits and chunk K/V within 1e-5 of JAX's, with stale
  entries past each row's start in the cache view;
* greedy tokens equal to JAX's paged engine and to the port's ring
  engine; after one script of admits, decodes and evicts with prefix
  sharing on, the page tables, refcounts, retained LRU, ``_prefix_map``
  (keys and pages) and every live pool entry (within 1e-5) equal JAX's;
* chunked prefill against one chunk (logits within 2e-5, the JAX
  suite's bound); speculative greedy against plain with JAX's drafted
  and accepted counts; speculative sampling bit for bit against plain
  under one seed (port only: the draws are not JAX's);
* prefix attach, refcounts, the retained LRU and reclaim, ``Overloaded``
  for pages and for slots (tests/test_paged_decode.py:210-300); a
  re-attach under pool pressure that never repeats a page in a row;
* a TokenServer over the paged engine with chunked prefill, sharing and
  speculation serving the ring server's greedy tokens; a deadline and a
  cancel while prefilling;
* ``bf16_mixed`` paged logits within 0.12 + 0.05|ref| of the JAX paged
  engine under the policy;
* the position-keyed sampler: integer hashing equal in numpy, torch and
  Python integers, draws that follow the masked softmax and depend on
  (seed, position) only, no key's uniforms a shifted copy of another's.

The mesh case of tests/test_paged_decode.py:104 becomes a check that
``mesh=`` raises "not ported yet".  Matmul precision is pinned: JAX to
"float32", torch to "highest".
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu import generate as jgen

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import generate as tgen
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.examples import transformer_lm as tlm
from mxnet_tpu_torch.name import NameManager as TNameManager

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import transformer_lm as jlm  # noqa: E402

VOCAB, D_MODEL, N_HEADS, N_LAYERS, MAX_LEN = 48, 32, 2, 2, 24
DH = D_MODEL // N_HEADS
CFG = dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=N_HEADS,
           n_layers=N_LAYERS, max_len=MAX_LEN)
PAGED = dict(cache_len=MAX_LEN, page_size=4, prefill_chunk=8)


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


@pytest.fixture(scope="module")
def nets():
    with jax.default_matmul_precision("float32"):
        jmx.random.seed(0)
        with jmx.name.NameManager():
            jnet = jlm.TransformerLM(**CFG)
        jnet.initialize(jmx.init.Xavier())
        jnet(jmx.nd.array(np.zeros((1, 4), np.float32)))
    weights = {n: p.data().asnumpy()
               for n, p in jnet.collect_params().items()}
    with TNameManager():
        tnet = tlm.TransformerLM(**CFG)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    tmx.convert.load_from_numpy(tnet, weights)
    return jnet, tnet


def _greedy(pkg):
    return pkg.SamplingConfig(greedy=True)


def _tpaged(tnet, **kw):
    args = dict(PAGED, slots=2, sampling=_greedy(tgen))
    args.update(kw)
    return tgen.PagedGenerationEngine(tnet, device=tmx.cpu(), **args)


def _jpaged(jnet, **kw):
    args = dict(PAGED, slots=2, sampling=_greedy(jgen))
    args.update(kw)
    with jax.default_matmul_precision("float32"):
        return jgen.PagedGenerationEngine(jnet, **args)


@pytest.fixture(scope="module")
def pair(nets):
    """JAX's and the port's paged engine (3 slots, sharing on), driven
    only in lockstep so that their states stay comparable."""
    jnet, tnet = nets
    return (_jpaged(jnet, slots=3, prefix_share=True),
            _tpaged(tnet, slots=3, prefix_share=True))


@pytest.fixture(scope="module")
def ring(nets):
    return tgen.GenerationEngine(nets[1], slots=3, cache_len=MAX_LEN,
                                 buckets=[8, MAX_LEN], device=tmx.cpu(),
                                 sampling=_greedy(tgen))


def _prompt(n=5, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, n).astype(np.int32)


def _repetitive(n=8):
    return np.tile(_prompt(3, seed=7), 3)[:n].astype(np.int32)


def _gen_tokens(eng, prompt, n):
    slot, tok = eng.admit(prompt)
    out = [tok]
    while len(out) < n:
        got = eng.decode_step()[slot]
        out.extend(got if isinstance(got, list) else [got])
    eng.evict(slot, "length")
    return out[:n]


def _evict_all(eng):
    for s in eng.active_slots():
        eng.evict(s, "length")


# ---------------------------------------------------------------------------
# chunk_forward
# ---------------------------------------------------------------------------

def test_chunk_forward_matches_jax(nets):
    """Two rows at starts 5 and 9 of a 12-position cache view whose
    entries at and past each start are garbage (stale K/V the mask must
    hide): logits and chunk K/V within 1e-5 of JAX's."""
    jnet, tnet = nets
    rng = np.random.RandomState(1)
    B, C, S = 2, 3, 12
    tokens = rng.randint(0, VOCAB, (B, C))
    start = np.asarray([5, 9])
    caches = [(rng.randn(B, N_HEADS, S, DH).astype(np.float32),
               rng.randn(B, N_HEADS, S, DH).astype(np.float32))
              for _ in range(N_LAYERS)]
    with torch.inference_mode():
        logits, chunk = tnet.chunk_forward(
            torch.from_numpy(tokens),
            [(torch.from_numpy(k), torch.from_numpy(v)) for k, v in caches],
            torch.from_numpy(start))
    jlogits, jchunk = jnet.chunk_forward(
        jnp.asarray(tokens, jnp.int32),
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in caches],
        jnp.asarray(start, jnp.int32))
    assert logits.shape == (B, C, VOCAB)
    np.testing.assert_allclose(logits.asnumpy(), np.asarray(jlogits._data),
                               atol=1e-5, rtol=1e-5)
    for (k, v), (jk, jv) in zip(chunk, jchunk):
        assert tuple(k.shape) == (B, N_HEADS, C, DH)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5,
                                   rtol=1e-5)
    # the garbage past each start is masked: changing it changes nothing
    noisy = [(torch.from_numpy(k).clone(), torch.from_numpy(v).clone())
             for k, v in caches]
    for k, v in noisy:
        k[0, :, 5:] += 100.0
        v[1, :, 9:] -= 100.0
    with torch.inference_mode():
        again, _ = tnet.chunk_forward(torch.from_numpy(tokens), noisy,
                                      torch.from_numpy(start))
    assert torch.equal(again._data, logits._data)


def test_chunk_forward_matches_prefill(nets):
    """From an empty cache (start 0) one chunk is the prompt's prefill:
    logits within 1e-5 of the port's own full forward."""
    _jnet, tnet = nets
    tokens = _prompt(7, seed=2)[None].astype(np.int64)
    empty = [(torch.zeros(1, N_HEADS, 4, DH), torch.zeros(1, N_HEADS, 4, DH))
             for _ in range(N_LAYERS)]
    with torch.inference_mode():
        logits, _ = tnet.chunk_forward(torch.from_numpy(tokens), empty,
                                       torch.zeros(1, dtype=torch.int64))
        full = tnet(tmx.nd.array(tokens.astype(np.float32), ctx=tmx.cpu()))
    np.testing.assert_allclose(logits.asnumpy(), full.asnumpy(), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# paged against JAX's paged engine and the ring engine
# ---------------------------------------------------------------------------

def test_paged_greedy_matches_jax_and_ring(pair, ring):
    jeng, teng = pair
    prompt = _prompt(9, seed=3)
    with jax.default_matmul_precision("float32"):
        want = _gen_tokens(jeng, prompt, 10)
    got = _gen_tokens(teng, prompt, 10)
    assert got == want == _gen_tokens(ring, prompt, 10)


def _script(eng):
    """Admits between decode steps, a shared prompt, an eviction that
    retains prefix pages and LIFO reuse; every output."""
    shared = _prompt(9, seed=7)                 # two full shareable pages
    out = []
    out.append(eng.admit(shared))
    out += [eng.decode_step() for _ in range(2)]
    out.append(eng.admit(shared))               # hits both pages
    out.append(eng.last_prefix_hit_tokens)
    out.append(eng.admit(_prompt(6, seed=2)))
    out += [eng.decode_step() for _ in range(3)]
    eng.evict(0, "eos")
    out.append(eng.decode_step())
    out.append(eng.admit(_prompt(13, seed=4)))  # the freed slot, LIFO
    out += [eng.decode_step() for _ in range(2)]
    eng.evict(1, "length")
    out.append(eng.decode_step())
    out.append(eng.occupancy())
    out.append([eng.position(s) for s in range(eng.slots)])
    return out


def _live_entries(eng, pool):
    """Pool entries at every written position of each active slot, and
    every page registered in the prefix map."""
    pool = np.asarray(pool, np.float32)
    rows = []
    for s in eng.active_slots():
        for p in range(eng.position(s)):
            pg = int(eng._page_table[s, p // eng.page_size])
            assert pg != 0
            rows.append(pool[:, pg, :, p % eng.page_size])
    for pg in sorted(eng._prefix_map.values()):
        rows.append(pool[:, int(pg)])
    return rows


def test_script_state_and_pools_match_jax(pair):
    jeng, teng = pair
    with jax.default_matmul_precision("float32"):
        want = _script(jeng)
    assert _script(teng) == want
    np.testing.assert_array_equal(teng._page_table, jeng._page_table)
    np.testing.assert_array_equal(teng._page_ref, jeng._page_ref)
    assert teng._prefix_map == jeng._prefix_map
    assert list(teng._reclaim.items()) == list(jeng._reclaim.items())
    assert list(teng._free_pages) == list(jeng._free_pages)
    assert list(teng._free) == list(jeng._free)
    for tpool, jpool in ((teng._pool_k, jeng._pool_k),
                         (teng._pool_v, jeng._pool_v)):
        got, ref = _live_entries(teng, tpool.numpy()), \
            _live_entries(jeng, jpool)
        assert len(got) == len(ref) > 20
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5)
    _evict_all(jeng)
    _evict_all(teng)
    np.testing.assert_array_equal(teng._page_ref, jeng._page_ref)
    assert teng.pages_in_use() == jeng.pages_in_use() == 0


def test_prefix_map_keys_equal_jax_hashes():
    toks = _prompt(13, seed=5)
    assert tgen._prefix_page_hashes(toks.astype(np.int64), 4, 3) == \
        jgen._prefix_page_hashes(toks, 4, 3)
    for hist, n, k in (([1, 2, 3, 1, 2], 2, 3), ([5, 5, 5, 5], 1, 2),
                       ([1, 2, 3], 2, 4), (list(_repetitive(8)), 3, 4)):
        assert tgen._ngram_draft(hist, n, k) == jgen._ngram_draft(hist, n, k)


def test_chunked_prefill_matches_single_chunk(nets):
    """A 10-token prompt in chunks of 3 against one chunk of 16: the same
    first token, decode tokens and decode logits within 2e-5."""
    tnet = nets[1]
    chunked = _tpaged(tnet, prefill_chunk=3)
    single = _tpaged(tnet, prefill_chunk=16)
    prompt = _prompt(10, seed=4)
    c_slot, c_tok = chunked.admit(prompt)
    assert chunked._chunks_run == 4
    s_slot, s_tok = single.admit(prompt)
    assert single._chunks_run == 1
    np.testing.assert_allclose(chunked.last_logits[0, 0],
                               single.last_logits[0, 9], atol=2e-5, rtol=0)
    assert c_tok == s_tok
    for _ in range(5):
        assert chunked.decode_step()[c_slot] == single.decode_step()[s_slot]
        np.testing.assert_allclose(chunked.last_logits[c_slot],
                                   single.last_logits[s_slot], atol=2e-5,
                                   rtol=0)


def test_spec_greedy_matches_plain_and_jax_counts(nets):
    jnet, tnet = nets
    spec = _tpaged(tnet, spec_k=3, spec_ngram=2)
    plain = _tpaged(tnet, spec_k=0)
    prompt = _repetitive(8)
    a = _gen_tokens(spec, prompt, 15)
    assert a == _gen_tokens(plain, prompt, 15)
    jspec = _jpaged(jnet, spec_k=3, spec_ngram=2)
    with jax.default_matmul_precision("float32"):
        assert _gen_tokens(jspec, prompt, 15) == a
    assert spec._spec_accepted > 0, "no draft verified"
    assert (spec._spec_drafted, spec._spec_accepted, spec._spec_steps) == \
        (jspec._spec_drafted, jspec._spec_accepted, jspec._spec_steps)
    assert spec.spec_accept_rate() == jspec.spec_accept_rate()
    assert spec.spec_accepted_per_step() == jspec.spec_accepted_per_step()


def test_spec_sampling_matches_plain_under_seed(nets):
    """Sampled decode with drafts that verify: the position-keyed draws
    make the speculative tokens the plain engine's, bit for bit."""
    tnet = nets[1]
    scfg = tgen.SamplingConfig(greedy=False, top_k=2, temperature=0.5)
    spec = _tpaged(tnet, spec_k=3, spec_ngram=1, sampling=scfg)
    plain = _tpaged(tnet, spec_k=0, sampling=scfg)
    prompt = _repetitive(8)
    tmx.random.seed(11)
    a = _gen_tokens(spec, prompt, 15)
    tmx.random.seed(11)
    b = _gen_tokens(plain, prompt, 15)
    assert a == b and all(0 <= t < VOCAB for t in a)
    assert spec._spec_accepted > 0, "no sampled draft verified"
    tmx.random.seed(12)
    assert _gen_tokens(plain, prompt, 15) != b, "the seed is not used"


# ---------------------------------------------------------------------------
# prefix sharing, Overloaded
# ---------------------------------------------------------------------------

def test_prefix_attach_refcount_and_eviction(nets):
    e = _tpaged(nets[1], slots=3, prefix_share=True)
    prompt = _prompt(9, seed=7)        # 2 full shareable pages (8 tokens)
    s1, t1 = e.admit(prompt)
    assert e.last_prefix_hit_tokens == 0, "a cold admit cannot hit"
    shared = [int(p) for p in e._page_table[s1][:2]]
    s2, t2 = e.admit(prompt)
    assert e.last_prefix_hit_tokens == 8 and t2 == t1
    assert [int(p) for p in e._page_table[s2][:2]] == shared
    assert all(e._page_ref[p] == 2 for p in shared)
    steps = {s: [] for s in (s1, s2)}
    for _ in range(4):
        out = e.decode_step()
        for s in steps:
            steps[s].extend(out[s])
    assert steps[s1] == steps[s2]
    e.evict(s2, "eos")
    assert all(e._page_ref[p] == 1 for p in shared)
    e.evict(s1, "eos")
    assert all(e._page_ref[p] == 0 for p in shared)
    assert set(shared) <= set(e._reclaim)
    assert e.occupancy()["prefix_cached_pages"] >= 2
    s3, _t3 = e.admit(prompt)
    assert e.last_prefix_hit_tokens == 8, "retained pages must re-attach"
    assert [int(p) for p in e._page_table[s3][:2]] == shared
    e.evict(s3, "eos")
    held = []
    with pytest.raises(tgen.Overloaded) as ei:
        for i in range(e.slots + 1):
            held.append(e.admit(_prompt(9, seed=20 + i))[0])
    assert ei.value.reason in ("slots", "pages")
    assert not (set(shared) & set(e._reclaim)), \
        "pool pressure must reclaim retained prefix pages"
    for s in held:
        e.evict(s, "length")
    assert e.prefix_hit_rate() == pytest.approx(16 / 48)


def _reattach_script(eng):
    """A(P1) and B(P2) fill both slots and are evicted, C keeps a slot
    live and takes 6 of the 8 free pages, then P1 comes again: it
    attaches P1's 2 retained pages and needs 4 more from 2 free pages
    and the reclaim LRU, whose oldest entries are P1's own pages.
    Returns the slot row of the repeat and its tokens to position 21."""
    p1, p2, p3 = (_prompt(9, seed=s) for s in (31, 32, 33))
    a, _ = eng.admit(p1)
    b, _ = eng.admit(p2)
    eng.evict(a, "eos")
    eng.evict(b, "eos")
    c, _ = eng.admit(p3)
    s, tok = eng.admit(p1)
    row = [int(p) for p in eng._page_table[s]]
    out = [tok]
    for _ in range(12):
        out.extend(eng.decode_step()[s])
    eng.evict(s, "length")
    eng.evict(c, "length")
    return row, out


def test_prefix_reattach_under_pressure_never_repeats_a_page(nets):
    # defaults: sharing on, the auto pool (2 x 6 + 1 pages)
    share = _tpaged(nets[1], slots=2, num_pages=None, prefix_share=True)
    assert share.num_pages == 13
    row, toks = _reattach_script(share)
    assert share.last_prefix_hit_tokens == 8
    assert 0 not in row and len(set(row)) == len(row), row
    _row, want = _reattach_script(
        _tpaged(nets[1], slots=2, num_pages=None, prefix_share=False))
    assert toks == want
    assert share._page_ref.sum() == 0 and len(share._free_pages) + len(
        share._reclaim) == share.num_pages - 1


def test_paged_overloaded_pages(nets):
    e = _tpaged(nets[1], slots=2, cache_len=4, prefill_chunk=4,
                num_pages=2, prefix_share=False)
    s1, _ = e.admit(_prompt(3, seed=1))
    assert e.free_slots() == 1
    with pytest.raises(tgen.Overloaded) as ei:
        e.admit(_prompt(3, seed=2))
    assert ei.value.reason == "pages"
    assert len(e._free_pages) == 0, "a failed admission must roll back"
    e.evict(s1, "length")
    assert len(e._free_pages) == 1


def test_paged_overloaded_slots(nets):
    e = _tpaged(nets[1], slots=2, cache_len=4, prefill_chunk=4,
                num_pages=3, prefix_share=False)
    s1, _ = e.admit(_prompt(3, seed=1))
    s2, _ = e.admit(_prompt(3, seed=2))
    with pytest.raises(tgen.Overloaded) as ei:
        e.admit(_prompt(3, seed=3))
    assert ei.value.reason == "slots"
    e.evict(s2, "eos")
    s3, _ = e.admit(_prompt(3, seed=4))
    assert s3 == s2, "the evicted lane is reused (LIFO)"
    for s in (s1, s3):
        e.evict(s, "length")


def test_capacity_and_prompt_checks(nets):
    e = _tpaged(nets[1], slots=1, cache_len=8, prefill_chunk=4)
    with pytest.raises(MXNetError, match="paged cache capacity"):
        e.admit(np.zeros(9, np.int32))
    for bad in ([], [3, VOCAB], [-1, 2]):
        with pytest.raises(MXNetError):
            e.admit(bad)
    slot, _tok = e.admit(_prompt(5, seed=6))
    while not e.at_capacity(slot):
        e.decode_step()
    assert e.position(slot) == 8
    with pytest.raises(MXNetError, match="capacity"):
        e.decode_step()
    e.evict(slot, "length")
    assert e.free_slots() == 1 and e.pages_in_use() == 0


def test_engine_surface(nets):
    tnet = nets[1]
    e = _tpaged(tnet, slots=2, num_pages=20, spec_k=2)
    assert (e.cache_len, e.page_size, e.num_pages, e.pages_per_slot,
            e.prefill_chunk, e.spec_k) == (24, 4, 20, 6, 8, 2)
    assert e.prewarm() == [{"label": "generate", "status": "disabled"}]
    assert e.bucket_for(9) == 16 and e.incremental
    assert e.dtype_policy_tag == "f32" and e.cache_dtype == torch.float32
    assert e.device == torch.device("cpu")
    assert e._pool_k.shape == (N_LAYERS, 20, N_HEADS, 4, DH)
    auto = _tpaged(tnet, slots=3, cache_len=10)
    assert (auto.pages_per_slot, auto.num_pages, auto.cache_len) == \
        (3, 10, 12)
    occ = e.occupancy()
    assert occ["pages_total"] == 19 and occ["pending_prefill"] == 0
    assert e.spec_accept_rate() is None and e.prefix_hit_rate() is None
    with pytest.raises(MXNetError, match="cannot back even one slot"):
        _tpaged(tnet, num_pages=6)
    for kw in ({"mesh": "dp=2,tp=2"}, {"layout": "fsdp_tp"},
               {"aot": "/x"}, {"aot_spec": "lm"}):
        with pytest.raises(MXNetError, match="not ported yet"):
            _tpaged(tnet, **kw)
    with pytest.raises(MXNetError, match="chunk protocol"):
        tgen.PagedGenerationEngine(tmx.gluon.nn.Dense(2), device=tmx.cpu())


def test_incremental_admission_and_round_robin(nets):
    """admit_incremental claims a slot and its pages; prefill_step runs
    one chunk a call, round-robin, and hands back the first token."""
    e = _tpaged(nets[1], slots=2, prefill_chunk=3)
    a = e.admit_incremental(_prompt(7, seed=1))
    b = e.admit_incremental(_prompt(2, seed=2))
    assert e.pending_prefill() == 2 and e.active_slots() == []
    assert e.occupancy()["active_slots"] == 2
    assert e.pages_in_use() == 2 * e.pages_per_slot
    done = []
    while e.pending_prefill():
        res = e.prefill_step()
        if res is not None:
            done.append(res[0])
    assert done == [b, a] and e._chunks_run == 4
    assert e.decode_step().keys() == {a, b}
    e.evict(a, "length")
    e.evict(b, "length")


# ---------------------------------------------------------------------------
# TokenServer over the paged engine
# ---------------------------------------------------------------------------

def _serve(eng, prompts, **kw):
    srv = tgen.TokenServer(eng, **kw)
    try:
        return [srv.generate(p, max_new_tokens=6, timeout=60)
                for p in prompts]
    finally:
        srv.close()


def test_server_paged_levers_match_ring(nets, ring):
    paged = _tpaged(nets[1], slots=2, prefill_chunk=3, spec_k=2,
                    spec_ngram=2, prefix_share=True)
    prompts = [_prompt(9, seed=8), _prompt(5, seed=9), _prompt(9, seed=8),
               _repetitive(8)]
    ref = _serve(ring, prompts, max_new_tokens=6)
    got = _serve(paged, prompts, max_new_tokens=6)
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert [r.finish_reason for r in got] == ["length"] * 4
    assert all(r.ttft_s is not None and r.ttft_s >= 0 for r in got)
    assert paged.prefix_hit_rate() > 0
    assert paged._spec_drafted > 0
    assert paged.free_slots() == 2 and paged.pages_in_use() == 0


def test_server_paged_eos_cuts_speculative_overshoot(nets):
    eng = _tpaged(nets[1], slots=2, spec_k=3, spec_ngram=1)
    plain = _gen_tokens(_tpaged(nets[1], slots=2), _repetitive(8), 8)
    eng.sampling.eos_id = plain[3]
    stop = plain.index(plain[3]) + 1
    try:
        r = _serve(eng, [_repetitive(8)], max_new_tokens=20)[0]
    finally:
        eng.sampling.eos_id = None
    assert r.finish_reason == "eos" and r.tokens == plain[:stop]


def test_server_paged_deadline_and_cancel_mid_prefill(nets, monkeypatch):
    eng = _tpaged(nets[1], slots=2, prefill_chunk=1)
    orig = eng.prefill_step

    def slow(slot=None):
        time.sleep(0.05)
        return orig(slot)

    monkeypatch.setattr(eng, "prefill_step", slow)
    srv = tgen.TokenServer(eng, queue_depth=8)
    try:
        fut = srv.submit(_prompt(20, seed=1), deadline_ms=150)
        with pytest.raises(tgen.DeadlineExceeded) as ei:
            fut.result(timeout=60)
        assert ei.value.stage == "prefill"
        fut2 = srv.submit(_prompt(20, seed=2))
        time.sleep(0.12)
        assert eng.pending_prefill() == 1
        assert fut2.cancel()
        deadline = time.monotonic() + 30
        while eng.free_slots() != eng.slots:
            assert time.monotonic() < deadline, "cancelled slot leaked"
            time.sleep(0.01)
        monkeypatch.undo()
        r = srv.generate(_prompt(4, seed=3), max_new_tokens=2, timeout=60)
        assert r.finish_reason == "length" and len(r.tokens) == 2
    finally:
        srv.close()
    assert eng.pages_in_use() == 0 and eng.pending_prefill() == 0


# ---------------------------------------------------------------------------
# bf16_mixed against the JAX paged engine under the policy
# ---------------------------------------------------------------------------

def test_bf16_mixed_paged_matches_jax(nets):
    jnet, tnet = nets
    teng = _tpaged(tnet, dtype_policy="bf16_mixed")
    jeng = _jpaged(jnet, dtype_policy="bf16_mixed")
    assert teng.cache_dtype == torch.bfloat16
    assert teng.dtype_policy_tag == jeng.dtype_policy_tag == "bf16_mixed"
    prompt = _prompt(10, seed=4)
    with jax.default_matmul_precision("float32"):
        jslot, jtok = jeng.admit(prompt)
    tslot, ttok = teng.admit(prompt)
    assert teng.last_logits.dtype == np.float32
    np.testing.assert_allclose(teng.last_logits, jeng.last_logits,
                               atol=0.12, rtol=0.05)
    assert ttok == jtok
    for _ in range(4):
        with jax.default_matmul_precision("float32"):
            jout = jeng.decode_step()
        tout = teng.decode_step()
        np.testing.assert_allclose(teng.last_logits, jeng.last_logits,
                                   atol=0.12, rtol=0.05)
        assert tout[tslot] == jout[jslot]
    assert teng._pool_k.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the position-keyed sampler
# ---------------------------------------------------------------------------

def _mix32_reference(x):
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def test_mix32_same_bits_in_numpy_torch_and_python():
    xs = np.asarray([0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                     0xFFFFFFFF, 123456789, 0xDEADBEEF], np.int64)
    want = [_mix32_reference(int(x)) for x in xs]
    assert tgen._mix32(xs).tolist() == want
    assert tgen._mix32(torch.from_numpy(xs)).tolist() == want
    assert len(set(tgen._mix32(np.arange(1 << 16)).tolist())) == 1 << 16


def test_sampler_keys_depend_on_seed_and_position_only():
    seeds = np.asarray([7, 7, 9], np.int64)
    wide = tgen._position_keys(seeds, np.asarray([4, 5, 4]), 3)
    narrow = tgen._position_keys(seeds, np.asarray([5, 6, 4]), 1)
    assert wide[0, 1] == narrow[0, 0] == wide[1, 0]
    assert wide[1, 1] == narrow[1, 0]
    assert wide[2, 0] == narrow[2, 0] != wide[0, 0]
    assert len(set(tgen._position_keys([7], [0], 256)[0].tolist())) == 256
    logits = torch.randn(1, 1, VOCAB, generator=torch.Generator().manual_seed(0))
    cfg = tgen.SamplingConfig(greedy=False, top_k=5)
    a = tgen.sample_positions(logits.expand(1, 3, VOCAB),
                              torch.from_numpy(wide[:1]), cfg)
    b = tgen.sample_positions(logits, torch.from_numpy(narrow[:1]), cfg)
    assert a[0, 1] == b[0, 0]
    greedy = tgen.sample_positions(logits, None, tgen.SamplingConfig())
    assert int(greedy) == int(logits.argmax())


def test_sampler_rows_are_not_shifted_windows():
    # keys whose products with V lie 1 apart mod 2**32: a draw of
    # _mix32(key * V + v) would give row b the row a shifted by one index
    V = 47
    ka = 5
    kb = (ka * V + 1) * pow(V, -1, 1 << 32) % (1 << 32)
    assert (kb * V) % (1 << 32) == (ka * V + 1) % (1 << 32)
    u = tgen._uniforms(torch.tensor([[ka], [kb]]), V)
    assert u.shape == (2, V) and bool(((u > 0) & (u < 1)).all())
    assert int((u[1, :-1] == u[0, 1:]).sum()) <= 1
    assert len(set(u.reshape(-1).tolist())) >= 2 * V - 1


def test_sampler_follows_the_masked_softmax():
    logits = torch.tensor([[[2.0, 1.0, 0.5, -1.0, 0.0, 1.5]]])
    cfg = tgen.SamplingConfig(greedy=False, top_k=4, temperature=0.8)
    keys = tgen._position_keys(np.arange(4000), np.zeros(4000, np.int64), 1)
    draws = tgen.sample_positions(logits.expand(4000, 1, 6),
                                  torch.from_numpy(keys), cfg).reshape(-1)
    probs = torch.softmax(tgen.mask_logits(logits[0], cfg), -1)[0]
    freq = torch.bincount(draws, minlength=6).double() / 4000
    assert set(torch.nonzero(freq).reshape(-1).tolist()) <= {0, 1, 2, 5}
    np.testing.assert_allclose(freq.numpy(), probs.double().numpy(),
                               atol=0.03)
