"""2-bit compression in the port held against the JAX package, on CPU.

The JAX side runs its Pallas kernels as its own tests do (interpret mode
on CPU); the port runs its plain PyTorch versions, which is what its
wrappers take for CPU tensors.  Codes compare as integers and residuals
and dequantized values bit for bit (as int32 views), since the
arithmetic (g = grad + res; (g - pos*t) + neg*t in f32) is the same
sequence of IEEE operations in both.  The CUDA kernels themselves are
compared with the plain versions in tests/test_torch_kernels.py, which
imports no jax so that it also runs on a machine with a GPU.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib import compression as jcomp

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import compression as tcomp

T = 0.5


def _inputs(size, seed=0):
    """Gradient and nonzero residual with +-t exactly, values that land on
    +-t after adding the residual, and codes that set bit 31."""
    rng = np.random.RandomState(seed)
    grad = rng.randn(size).astype(np.float32)
    res = (rng.randn(size) * 0.3).astype(np.float32)
    grad[::7] = T
    grad[3::11] = -T
    res[::7] = 0.0
    res[3::11] = 0.0
    grad[5::13] = np.float32(0.25)
    res[5::13] = np.float32(0.25)
    # element 16r + 15 of each code row strongly negative -> code 2 at
    # bit pair 15, i.e. the sign bit of the packed word
    idx = (np.arange(size) // 128) % 16 == 15
    grad[idx] = -2.0
    return grad, res


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("size", [1000, 16384, 100000, 16384 * 3 + 5])
def test_quantize_codes_residuals_dequant_match_jax(size):
    grad, res = _inputs(size)
    jcodes, jres = jcomp.quantize_2bit(grad, res, T)
    jdeq = jcomp.dequantize_2bit(jcodes, size, T)
    tcodes, tres = tcomp.quantize_2bit(torch.from_numpy(grad),
                                       torch.from_numpy(res), T)
    tdeq = tcomp.dequantize_2bit(tcodes, size, T)
    assert tcodes.dtype == torch.int32
    assert np.array_equal(tcodes.numpy(), np.asarray(jcodes))
    assert np.array_equal(_bits(tres.numpy()), _bits(jres))
    assert np.array_equal(_bits(tdeq.numpy()), _bits(jdeq))


def test_sign_bit_code():
    """Code 2 at j = 15 is bit 31: the packed word is negative and both
    packages decode it as -t."""
    grad = np.zeros(16384, np.float32)
    grad[15 * 128] = -1.0            # element (row 15, lane 0)
    tcodes, _ = tcomp.quantize_2bit(torch.from_numpy(grad),
                                    torch.zeros(16384), T)
    jcodes, _ = jcomp.quantize_2bit(grad, np.zeros(16384, np.float32), T)
    assert int(tcodes[0, 0]) == -2 ** 31 == int(np.asarray(jcodes)[0, 0])
    deq = tcomp.dequantize_2bit(tcodes, 16384, T).numpy()
    assert deq[15 * 128] == -T and np.count_nonzero(deq) == 1


def test_error_feedback_accumulates():
    """Mirrors tests/test_compression.py: 5 x 0.2 of signal emits exactly
    two +0.5 steps."""
    gc = tcomp.GradientCompression(type="2bit", threshold=0.5)
    grad = tmx.nd.array(np.full(10, 0.2, np.float32), ctx=tmx.cpu())
    emitted = np.zeros(10, np.float32)
    for _ in range(5):
        emitted += gc.compress_dequantize("k", grad).asnumpy()
    np.testing.assert_allclose(emitted, np.full(10, 1.0), rtol=1e-6)


def _push_pull(mx, ctx, size, threshold, pushes):
    kw = {} if ctx is None else {"ctx": ctx}
    kv = mx.kv.create("local")
    kv.init("w", mx.nd.zeros((size,), **kw))
    kv.set_gradient_compression({"type": "2bit", "threshold": threshold})
    out = mx.nd.zeros((size,), **kw)
    pulled = []
    for workers in pushes:
        kv.push("w", [mx.nd.array(np.full(size, v, np.float32), **kw)
                      for v in workers])
        kv.pull("w", out=out)
        pulled.append(out.asnumpy().copy())
    return pulled


@pytest.mark.parametrize("size, threshold, pushes", [
    # tests/test_compression.py:62 — +0.7 / -0.6 cancel on every push
    (64, 0.5, [(0.7, -0.6)] * 3),
    # tests/test_compression.py:84 — worker 1 emits +1, worker 2 nothing
    (32, 1.0, [(2.5, 0.4)]),
])
def test_kvstore_two_workers_match_jax(size, threshold, pushes):
    tout = _push_pull(tmx, tmx.cpu(), size, threshold, pushes)
    jout = _push_pull(jmx, None, size, threshold, pushes)
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t, j)


# the batched path: every (key, worker) entry of a push in one call
RAGGED = [1, 3, 127, 16385, 16384 * 3 + 5]


def _push_grads(sizes, workers, push, seed=0):
    """Per key, per worker, a flat gradient from a seed; scaled so that
    residuals carry over from push to push."""
    rng = np.random.RandomState(1000 * seed + 10 * push + workers)
    return [[(rng.randn(n) * 0.6).astype(np.float32) for _ in range(workers)]
            for n in sizes]


@pytest.mark.parametrize("workers", [1, 2])
def test_batched_pushes_match_jax_key_by_key(workers):
    """Three pushes of a ragged key set, each one batched call in the port
    and a loop of single-key calls in the JAX package: codes equal as
    integers, residuals and dequantized values bit for bit."""
    keys = [("k%d" % i, w) for i in range(len(RAGGED)) for w in range(workers)]
    sizes = [n for n in RAGGED for _ in range(workers)]
    tgc = tcomp.GradientCompression(threshold=T)
    jgc = jcomp.GradientCompression(threshold=T)
    for push in range(3):
        grads = [g for per_key in _push_grads(RAGGED, workers, push)
                 for g in per_key]
        layout, codes = tgc.quantize_batch(
            keys, [torch.from_numpy(g) for g in grads])
        deq = tcomp.dequantize_batch(layout, codes, T)
        assert layout.sizes == tuple(sizes)
        for e, (key, g) in enumerate(zip(keys, grads)):
            jcodes = jgc.compress(key, g)
            assert np.array_equal(layout.codes(codes, e).numpy(),
                                  np.asarray(jcodes))
            assert np.array_equal(_bits(tgc._residuals[key].numpy()),
                                  _bits(jgc._residuals[key]))
            jdeq = jcomp.dequantize_2bit(jcodes, g.size, T)
            assert np.array_equal(_bits(layout.values(deq, e).numpy()),
                                  _bits(jdeq))


def _recording_store(mx, keys, sizes, kw):
    kv = mx.kv.create("device")
    for k, n in zip(keys, sizes):
        kv.init(k, mx.nd.zeros((n,), **kw))
    kv.set_gradient_compression({"type": "2bit", "threshold": T})
    seen = []
    kv.set_updater(lambda k, agg, stored: seen.append(
        (str(k), agg.asnumpy().copy())))
    return kv, seen


@pytest.mark.parametrize("pushes", [
    # a key repeated in one list: its second occurrence sees the residual
    # its first left (the JAX package's sequential loop)
    [["a", "b", "a"], ["a", "b", "a"]],
    # the key set changes between pushes, residuals carry over
    [["a", "b"], ["b", "c"], ["a", "c", "b"], ["c"]],
])
@pytest.mark.parametrize("workers", [1, 2])
def test_kvstore_push_lists_match_jax(pushes, workers):
    """KVStore.push of a list with compression: each key's aggregate, in
    the order the updater sees them, bit for bit equal to the JAX
    package's."""
    sizes = {"a": 16385, "b": 127, "c": 16384 * 3 + 5}
    out = []
    for mx, kw in ((tmx, {"ctx": tmx.cpu()}), (jmx, {})):
        kv, seen = _recording_store(mx, list(sizes), list(sizes.values()),
                                    kw)
        for p, keys in enumerate(pushes):
            grads = _push_grads([sizes[k] for k in keys], workers, p, seed=1)
            kv.push(keys, [[mx.nd.array(g, **kw) for g in per_key]
                           for per_key in grads])
        out.append(seen)
    assert [k for k, _ in out[0]] == [k for k, _ in out[1]] == \
        [k for keys in pushes for k in keys]
    for (_, t), (_, j) in zip(*out):
        assert np.array_equal(_bits(t), _bits(j))


def test_kvstore_push_of_a_list_equals_pushes_one_at_a_time():
    """One batched push of a list gives each key the aggregate, and leaves
    each (key, worker) the residual, that pushing the keys one at a time
    does."""
    sizes = {"a": 16385, "b": 127, "c": 1, "d": 16384 * 3 + 5}
    results = []
    for batched in (True, False):
        kv, seen = _recording_store(tmx, list(sizes), list(sizes.values()),
                                    {"ctx": tmx.cpu()})
        for p in range(2):
            grads = _push_grads(list(sizes.values()), 2, p, seed=2)
            vals = [[tmx.nd.array(g, ctx=tmx.cpu()) for g in per_key]
                    for per_key in grads]
            if batched:
                kv.push(list(sizes), vals)
            else:
                for k, v in zip(sizes, vals):
                    kv.push(k, v)
        results.append((seen, {k: v.numpy().copy()
                               for k, v in kv._gc._residuals.items()}))
    (bs, br), (ss, sr) = results
    assert [k for k, _ in bs] == [k for k, _ in ss]
    for (_, a), (_, b) in zip(bs, ss):
        assert np.array_equal(_bits(a), _bits(b))
    assert br.keys() == sr.keys()
    for k in br:
        assert np.array_equal(_bits(br[k]), _bits(sr[k]))


def test_batch_layout_offsets():
    """Each entry pads to whole (128, 128) tiles of codes, numbered on from
    the last entry's; residuals and values hold only the real elements, at
    offsets rounded up to 4 floats."""
    layout = tcomp.batch_layout(tuple(RAGGED))
    assert layout.tiles == (1, 1, 1, 2, 4)
    assert layout.first_tile == [0, 1, 2, 3, 5] and layout.n_tiles == 9
    assert layout.code_offsets == [0, 1024, 2048, 3072, 5120]
    assert layout.n_code_words == 9 * 1024
    assert layout.value_offsets == [0, 4, 8, 136, 16524]
    assert layout.n_values == 16524 + 49160
    assert all(o % 4 == 0 for o in layout.value_offsets)
    assert tcomp.batch_layout(tuple(RAGGED)) is layout


def test_entry_table_fields_and_vector_choice():
    """The kernels' entry table (plain Python, built on the host): one row
    of COMPRESSION_FIELDS per entry, then each tile's entry; gradients at
    element offsets 1 and 2 of a shared buffer (not 16-byte aligned) take
    the element-by-element path, offsets 0 and 4 the 16-byte one, and an
    unaligned residual turns it off for every entry."""
    from mxnet_tpu_torch import kernels

    sizes = (1, 3, 127, 16385)
    layout = tcomp.batch_layout(sizes)
    shared = torch.zeros(40000)
    assert shared.data_ptr() % 16 == 0
    starts = (0, 1, 2, 4)
    grads = [shared[s:s + n] for s, n in zip(starts, sizes)]
    arena = torch.zeros(layout.n_values + 4)
    for res, vector in ((arena[:layout.n_values], [1, 0, 0, 1]),
                        (arena[1:layout.n_values + 1], [0, 0, 0, 0])):
        table = kernels.compression_table(layout, grads, res, res)
        width = len(kernels.COMPRESSION_FIELDS)
        rows = table[:len(sizes) * width].reshape(len(sizes), width)
        field = {f: rows[:, i].tolist()
                 for i, f in enumerate(kernels.COMPRESSION_FIELDS)}
        assert field["grad"] == [g.data_ptr() for g in grads]
        assert field["size"] == list(sizes)
        assert field["residual_in"] == field["residual_out"] == \
            field["values"] == layout.value_offsets
        assert field["codes"] == layout.code_offsets
        assert field["first_tile"] == layout.first_tile
        assert field["vector"] == vector
        tiles = table[len(sizes) * width:].view(np.int32)
        assert tiles.tolist() == [0, 1, 2, 3, 3, 0]   # padded to an int64
    # dequantize's table: no addresses, no vector flags
    table = kernels.compression_table(layout)
    assert not table[:len(sizes) * width].reshape(-1, width)[:, [0, 7]].any()
