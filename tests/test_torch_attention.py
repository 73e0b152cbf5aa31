"""Flash attention: the port (mxnet_tpu_torch.ops.attention, its plain
version on the CPU) against the JAX package's Pallas kernel
(mxnet_tpu.ops.attention_pallas, interpret mode on the CPU), from the same
numpy inputs.  The cases mirror tests/test_flash_attention.py; JAX is
pinned to float32 matmuls and torch to "highest", so both sides compute
in full f32 and the JAX suite's bounds apply unchanged: 5e-5 on f32
outputs and lse, 5e-4 on gradients, 3e-2 on bf16 outputs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import attention_pallas as jattn
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.parallel import local_attention


@pytest.fixture(autouse=True)
def _highest_precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def _qkv(B=2, T=256, H=2, D=64, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))


def _jax(arrs, dtype=jnp.float32):
    return tuple(jnp.asarray(a).astype(dtype) for a in arrs)


def _torch(arrs, dtype=torch.float32, grad=False):
    return tuple(torch.tensor(a, dtype=dtype, requires_grad=grad)
                 for a in arrs)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_kernel(causal):
    arrs = _qkv()
    o_j, lse_j = jattn.flash_attention_with_lse(*_jax(arrs), causal=causal)
    o_t, lse_t = tattn.flash_attention_with_lse(*_torch(arrs), causal=causal)
    assert o_t.dtype == torch.float32 and lse_t.dtype == torch.float32
    assert o_t.shape == (2, 256, 2, 64) and lse_t.shape == (2, 256, 2)
    assert np.abs(_np(o_t) - _np(o_j)).max() < 5e-5
    assert np.abs(_np(lse_t) - _np(lse_j)).max() < 5e-5
    ref = local_attention(*_torch(arrs), causal=causal)
    assert (o_t - ref).abs().max().item() < 5e-5


def test_flash_uneven_blocks():
    arrs = _qkv()
    o_j = jattn.flash_attention(*_jax(arrs), blk_q=128, blk_k=64)
    o_t = tattn.flash_attention(*_torch(arrs), blk_q=128, blk_k=64)
    assert np.abs(_np(o_t) - _np(o_j)).max() < 5e-5


def test_flash_lse_matches_jax_logsumexp():
    arrs = _qkv(B=1, T=128, H=1, D=64)
    q, k, _ = _jax(arrs)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * (64 ** -0.5)
    ref = jnp.swapaxes(jax.nn.logsumexp(s, axis=-1), 1, 2)
    _, lse_t = tattn.flash_attention_with_lse(*_torch(arrs))
    assert np.abs(_np(lse_t) - _np(ref)).max() < 5e-5


def test_flash_bf16_io():
    arrs = _qkv(B=1, T=128, H=1)
    o_j = jattn.flash_attention(*_jax(arrs, jnp.bfloat16))
    o_t = tattn.flash_attention(*_torch(arrs, torch.bfloat16))
    assert o_t.dtype == torch.bfloat16
    ref = local_attention(*(t.float() for t in _torch(arrs, torch.bfloat16)))
    assert (o_t.float() - ref).abs().max().item() < 3e-2
    assert np.abs(_np(o_t) - _np(o_j)).max() < 3e-2


def test_flash_rejects_ragged_seq():
    arrs = _qkv(T=192)
    with pytest.raises(ValueError, match="multiples"):
        jattn.flash_attention(*_jax(arrs), blk_q=128, blk_k=128)
    with pytest.raises(ValueError, match="multiples"):
        tattn.flash_attention(*_torch(arrs), blk_q=128, blk_k=128)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_match_jax(causal):
    """dq, dk, dv of a loss on both o and lse: the JAX custom_vjp against
    the port's autograd.Function."""
    arrs = _qkv(B=1, T=128, H=2, D=64, seed=3)
    rng = np.random.RandomState(4)
    w_o = rng.randn(1, 128, 2, 64).astype(np.float32)
    w_l = rng.randn(1, 128, 2).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jattn.flash_attention_with_lse(q, k, v, causal=causal)
        return (o * w_o).sum() + (lse * w_l).sum()

    grads_j = jax.grad(jloss, argnums=(0, 1, 2))(*_jax(arrs))
    q, k, v = _torch(arrs, grad=True)
    o, lse = tattn.flash_attention_with_lse(q, k, v, causal=causal)
    ((o * torch.from_numpy(w_o)).sum()
     + (lse * torch.from_numpy(w_l)).sum()).backward()
    for g_t, g_j in zip((q.grad, k.grad, v.grad), grads_j):
        assert np.abs(_np(g_t) - _np(g_j)).max() < 5e-4


def test_flash_cpu_path_launches_no_kernel():
    kernels.reset_launch_counts()
    tattn.flash_attention(*_torch(_qkv(B=1, T=64, H=1, D=16)))
    assert kernels.launch_counts["flash_attention"] == 0
