"""The port's CUDA kernel wrappers.  This file imports no jax, so that on a
machine with a GPU (and without jax) it runs as

    python -m pytest --noconftest -q tests/test_torch_kernels.py

where the `cuda`-marked tests build the kernels and hold them, bit for
bit, against their plain PyTorch versions.  Here on the CPU those skip,
and the tests of the wrappers' CPU-side behaviour run.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.contrib import compression as comp

T = 0.5


def _inputs(size, seed):
    """Gradient and nonzero residual with +-t exactly and codes that set
    bit 31 (code 2 at bit pair 15)."""
    rng = np.random.RandomState(seed)
    grad = (rng.randn(size) * 2.0).astype(np.float32)
    res = (rng.randn(size) * 0.3).astype(np.float32)
    grad[::7] = T
    grad[3::11] = -T
    res[::7] = 0.0
    res[3::11] = 0.0
    grad[(np.arange(size) // 128) % 16 == 15] = -2.0
    return torch.from_numpy(grad), torch.from_numpy(res)


def test_cpu_path_launches_no_kernel():
    kernels.reset_launch_counts()
    grad, res = _inputs(1000, 0)
    codes, _ = comp.quantize_2bit(grad, res, T)
    comp.dequantize_2bit(codes, 1000, T)
    assert kernels.launch_counts == {"quantize_2bit": 0,
                                     "dequantize_2bit": 0}


def test_kernel_wrappers_reject_cpu_tensors():
    """The launching wrappers never fall back: a CPU tensor is refused
    before anything is built."""
    g = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.quantize_2bit(g, g, T)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dequantize_2bit(torch.zeros(8, 128, dtype=torch.int32), T)


def test_padded_layout_rows():
    """Rows pad to whole (128, 128) tiles, at least one tile."""
    assert comp._padded_rows(1) == 128
    assert comp._padded_rows(16384) == 128
    assert comp._padded_rows(16385) == 256
    codes, res = comp.quantize_2bit(torch.zeros(16385), torch.zeros(16385))
    assert codes.shape == (16, 128) and res.shape == (16385,)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1000, 16384, 16384 * 7 + 3])
def test_cuda_kernels_match_plain_versions(size):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels)")
    grad, res = _inputs(size, 1)
    before = dict(kernels.launch_counts)
    codes, new_res = comp.quantize_2bit(grad.cuda(), res.cuda(), T)
    deq = comp.dequantize_2bit(codes, size, T)
    torch.cuda.synchronize()
    assert kernels.launch_counts["quantize_2bit"] == \
        before["quantize_2bit"] + 1
    assert kernels.launch_counts["dequantize_2bit"] == \
        before["dequantize_2bit"] + 1
    rcodes, rres = comp.quantize_2bit(grad, res, T)
    rdeq = comp.dequantize_2bit(rcodes, size, T)
    assert torch.equal(codes.cpu(), rcodes)
    assert torch.equal(new_res.cpu().view(torch.int32),
                       rres.view(torch.int32))
    assert torch.equal(deq.cpu().view(torch.int32), rdeq.view(torch.int32))


@pytest.mark.cuda
def test_cuda_kernels_reject_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels)")
    g = torch.zeros(128, 128, device="cuda")
    with pytest.raises(TypeError):
        kernels.quantize_2bit(g.double(), g, T)
    with pytest.raises(ValueError):
        kernels.quantize_2bit(g.t()[:, :64].contiguous(), g, T)
    with pytest.raises(ValueError):
        kernels.quantize_2bit(torch.zeros(128, 256, device="cuda")[:, ::2],
                              g, T)
