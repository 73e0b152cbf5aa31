"""The port's mx.rtc (mxnet_tpu_torch.rtc: PallasModule, CudaModule,
PallasKernel) held against the JAX package's on the CPU: a module of
named kernels (functions on tensors) launched on NDArrays gives what
the same function gives called directly, and what the JAX package's
module gives for the same function written in jax.numpy; CUDA C source
is refused in both.  f32, rtol 1e-5, atol 1e-6."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _axpy(lib):
    return lambda a, x, y: a * x + y


def _split(lib):
    return lambda x: (lib.exp(x), lib.tanh(x) * 2.0)


def _inputs():
    rng = np.random.RandomState(0)
    return [rng.randn(4, 5).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("name", ["CudaModule", "PallasModule"])
def test_kernel_launch_matches_the_function_and_jax(name):
    a, x, y = _inputs()
    mod = getattr(tmx.rtc, name)(kernels={"axpy": _axpy(torch)})
    k = mod.get_kernel("axpy")
    got = k.launch([tmx.nd.array(a), tmx.nd.array(x), tmx.nd.array(y)],
                   tmx.cpu(), (1, 1, 1), (32, 1, 1))
    assert isinstance(got, tmx.nd.NDArray)
    direct = _axpy(torch)(torch.from_numpy(a), torch.from_numpy(x),
                          torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got.asnumpy(), direct)
    jmod = getattr(jmx.rtc, name)(kernels={"axpy": _axpy(jnp)})
    want = jmod.get_kernel("axpy")([jmx.nd.array(a), jmx.nd.array(x),
                                    jmx.nd.array(y)])
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=RTOL,
                               atol=ATOL)


def test_several_outputs_come_back_as_a_list():
    (x, _, _) = _inputs()
    got = tmx.rtc.CudaModule(kernels={"s": _split(torch)}).get_kernel(
        "s")([tmx.nd.array(x)])
    want = jmx.rtc.CudaModule(kernels={"s": _split(jnp)}).get_kernel(
        "s")([jmx.nd.array(x)])
    assert isinstance(got, list) and len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=RTOL,
                                   atol=ATOL)


def test_cuda_source_and_unknown_kernels_are_refused():
    src = "extern \"C\" __global__ void axpy(float *x) {}"
    for mx in (tmx, jmx):
        with pytest.raises(mx.base.MXNetError, match="not available"):
            mx.rtc.CudaModule(src, exports=["axpy"])
        with pytest.raises(mx.base.MXNetError, match="not found"):
            mx.rtc.CudaModule(kernels={}).get_kernel("axpy")
    assert tmx.rtc.CudaModule is tmx.rtc.PallasModule
    assert sorted(tmx.rtc.__all__) == sorted(jmx.rtc.__all__)
    assert issubclass(MXNetError, RuntimeError)
