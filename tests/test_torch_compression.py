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
