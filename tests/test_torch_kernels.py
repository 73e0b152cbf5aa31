"""The port's CUDA kernel wrappers.  This file imports no jax, so that on a
machine with a GPU (and without jax) it runs as

    python -m pytest --noconftest -q tests/test_torch_kernels.py

where the `cuda`-marked tests build the kernels and hold them against
their plain PyTorch versions (the compression kernels bit for bit, flash
attention within the JAX suite's bounds).  Without a card those skip,
and the tests of the wrappers' CPU-side behaviour run.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.contrib import compression as comp
from mxnet_tpu_torch.ops import attention as attn

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
                                     "dequantize_2bit": 0,
                                     "flash_attention": 0,
                                     "flash_attention_bf16": 0}


def test_kernel_wrappers_reject_cpu_tensors():
    """The launching wrappers never fall back: a CPU tensor is refused
    before anything is built."""
    g = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.quantize_2bit(g, g, T)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dequantize_2bit(torch.zeros(8, 128, dtype=torch.int32), T)


def test_batch_wrappers_reject_cpu_tensors():
    """The batched launching wrappers refuse CPU tensors too, before
    anything is built: a CPU tensor reaching them never falls back."""
    layout = comp.batch_layout((1000, 3))
    grads = [torch.zeros(1000), torch.zeros(3)]
    res = torch.zeros(layout.n_values)
    codes = torch.zeros(layout.n_code_words, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.quantize_2bit_batch(layout, grads, res, res, codes, T)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dequantize_2bit_batch(layout, codes, res, T)


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


# sizes of the ragged batch and the element offsets of their gradients in
# one shared buffer (no overlap): offsets 1 and 6 are 1 and 2 elements
# past a 16-byte boundary
BATCH_SIZES = (1, 3, 127, 16385, 16384 * 7 + 3)
BATCH_STARTS = (0, 1, 6, 136, 16524)


@pytest.mark.cuda
def test_cuda_batched_kernels_match_plain_batch():
    """One launch of each kernel over a ragged batch whose gradients lie at
    element offsets 0, 1 and 2 of a shared buffer, for two pushes that
    carry the residual arena over (updated in place): codes, arena and
    dequantized values bit for bit equal to the batched plain version on
    the card; the device table sends the misaligned entries down the
    element-by-element path; an unchanged batch uploads no table."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels)")
    layout = comp.batch_layout(BATCH_SIZES)
    arena = torch.zeros(layout.n_values, device="cuda")
    ref_arena = arena.clone()
    shared = torch.empty(BATCH_STARTS[-1] + BATCH_SIZES[-1], device="cuda")
    grads = [shared[s:s + n] for s, n in zip(BATCH_STARTS, BATCH_SIZES)]
    for push in range(2):
        for e, g in enumerate(grads):
            g.copy_(_inputs(g.numel(), 10 * push + e)[0].cuda())
        before = dict(kernels.launch_counts)
        uploads = kernels.table_uploads
        codes = comp.quantize_batch(layout, grads, arena, arena, T)
        deq = comp.dequantize_batch(layout, codes, T)
        torch.cuda.synchronize()
        assert {n: c - before[n] for n, c in kernels.launch_counts.items()} \
            == {"quantize_2bit": 1, "dequantize_2bit": 1,
                "flash_attention": 0, "flash_attention_bf16": 0}
        if push:
            assert kernels.table_uploads == uploads
        table = kernels._device_table(layout, arena.device, grads, arena,
                                      arena).cpu().numpy()
        width = len(kernels.COMPRESSION_FIELDS)
        vector = table[:len(grads) * width].reshape(-1, width)[:, 7]
        assert vector.tolist() == [int(g.data_ptr() % 16 == 0)
                                   for g in grads] == [1, 0, 0, 1, 1]
        rcodes = torch.empty_like(codes)
        comp.quantize_batch_ref(layout, grads, ref_arena, ref_arena, rcodes,
                                T)
        rdeq = torch.zeros_like(deq)
        comp.dequantize_batch_ref(layout, rcodes, rdeq, T)
        assert torch.equal(codes, rcodes)
        assert torch.equal(arena.view(torch.int32),
                           ref_arena.view(torch.int32))
        for e in range(len(grads)):
            assert torch.equal(layout.values(deq, e).view(torch.int32),
                               layout.values(rdeq, e).view(torch.int32))


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


def test_flash_wrapper_rejects_cpu_tensors():
    """The flash wrapper refuses CPU tensors (no fallback) in both input
    types, also at a head dim past the tensor-core kernel's limit (which
    the f32 kernel's wide variant takes on the card)."""
    for dt in (torch.float32, torch.bfloat16):
        for d in (64, 512):
            x = torch.zeros(1, 64, 2, d, dtype=dt)
            with pytest.raises(ValueError, match="CUDA"):
                kernels.flash_attention_fwd(x, x, x, 0.125, False)


def test_bf16_loader_choice():
    """The bf16 kernel stages with 16-byte copies only where every row
    start is 16-byte aligned: not for D 20, a row stride of 130 elements,
    or a view offset by one element."""
    bf = torch.bfloat16
    dense = torch.zeros(2, 64, 2, 64, dtype=bf)
    buf = torch.zeros(2, 64, 2, 128, dtype=bf)
    assert dense.data_ptr() % 16 == 0 and buf.data_ptr() % 16 == 0
    assert kernels.bf16_vector_loads(dense, dense, dense)
    assert kernels.bf16_vector_loads(buf[..., :64], dense, dense)
    assert not kernels.bf16_vector_loads(buf[..., 1:65], dense, dense)
    assert not kernels.bf16_vector_loads(dense, dense[..., :20], dense)
    odd_rows = torch.zeros(2, 64, 2, 130, dtype=bf)[..., :64]
    assert not kernels.bf16_vector_loads(dense, dense, odd_rows)


def test_flash_kernel_routing():
    """f32 at any head dim and bf16 past the tensor-core kernel's limit
    run flash_attention.cu; bf16 up to it runs the tensor-core kernel."""
    for d in (1, 64, 256, 257, 512):
        assert kernels.flash_kernel(torch.float32, d) == "flash_attention"
    for d in (1, 64, 256):
        assert kernels.flash_kernel(torch.bfloat16, d) == \
            "flash_attention_bf16"
    for d in (257, 320, 1024):
        assert kernels.flash_kernel(torch.bfloat16, d) == "flash_attention"


def test_f32_loader_choice():
    """The f32 kernel stages with 16-byte cp.async copies only where every
    row start is 16-byte aligned: D 20 is (80 bytes), D 18, a row stride
    of 66 elements or a view offset by one element is not."""
    dense = torch.zeros(2, 64, 2, 64)
    buf = torch.zeros(2, 64, 2, 128)
    assert kernels.f32_vector_loads(dense, dense, dense)
    assert kernels.f32_vector_loads(buf[..., :64], dense, dense)
    assert kernels.f32_vector_loads(dense[..., :20], dense, dense)
    assert not kernels.f32_vector_loads(buf[..., 1:65], dense, dense)
    assert not kernels.f32_vector_loads(dense, dense[..., :18], dense)
    odd_rows = torch.zeros(2, 64, 2, 66)[..., :64]
    assert not kernels.f32_vector_loads(dense, dense, odd_rows)


# (B, Tq, Tk, H, D, causal, q_off): the JAX suite's shapes, every
# head-dim variant of the kernels (D 257, 320 and 512 on the f32 kernel's
# wide variant, in both types), ragged lengths that are not multiples of
# their query and key tiles, causal with Tq != Tk and Tk not a multiple of
# the key tile; q is the head slice [q_off, q_off + D) of a (B, Tq, H,
# 2D + 8) buffer.  Element-wise loaders: q_off 1 in both types, D 18 and
# D 257 in f32, D 20 in bf16 (a multiple of 4, so f32 takes 16-byte
# copies there); the other cases take the 16-byte loaders.
FLASH_CASES = [(2, 256, 256, 2, 64, False, 0), (2, 256, 256, 2, 64, True, 0),
               (1, 128, 128, 1, 8, True, 0), (2, 64, 64, 3, 16, False, 0),
               (1, 96, 96, 2, 32, True, 0), (1, 256, 256, 2, 128, True, 0),
               (1, 128, 128, 1, 256, False, 0), (2, 100, 77, 2, 48, True, 0),
               (1, 77, 130, 2, 64, False, 0), (1, 128, 96, 2, 20, True, 0),
               (2, 130, 130, 2, 64, False, 1), (1, 130, 200, 2, 64, True, 0),
               (1, 200, 100, 2, 256, True, 1), (1, 64, 64, 1, 257, False, 0),
               (1, 128, 96, 2, 320, True, 0), (2, 130, 130, 2, 512, False, 1),
               (1, 96, 80, 2, 18, True, 0), (1, 100, 64, 3, 40, False, 1)]

# bf16 o against the f32 plain version on the same bf16 values.  The
# kernel rounds each probability P to bf16 before P.V (relative error at
# most 2^-8) and sums l from the f32 P, so before its last rounding o is
# off by at most 2^-8 (P/l).|V| = 2^-8 obar, obar being the plain version
# run on |V|; rounding o to bf16 adds at most 2^-8 |o|.  Hence
# |o - o_plain| <= 2^-8 (|o_plain| + obar) + 5e-5, where 5e-5 (the f32
# bound) covers the f32 arithmetic and the second-order 2^-16 obar.
BF16_REL, F32_ABS = 2.0 ** -8, 5e-5


def _plain_with_obar(q, k, v, scale, causal):
    """The f32 plain version on (B, T, H, D): (o, lse, obar), obar from
    |v| through the same probabilities (one pass, v and |v| side by
    side)."""
    q, k, v = (t.float().transpose(1, 2) for t in (q, k, v))
    o, lse = attn._ref_attention_lse(q, k, torch.cat([v, v.abs()], -1),
                                     scale, causal)
    o, obar = o.transpose(1, 2).chunk(2, dim=-1)
    return o, lse.transpose(1, 2), obar


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_matches_plain_version(case, dtype):
    """Kernel vs plain version on the card, q read through a strided
    view: f32 on the f32 kernel within 5e-5 (o) and 1e-4 (lse); bf16 (on
    the tensor-core kernel up to D 256, on the f32 kernel's wide variant
    above) with o within 3e-2 of the plain version on the same values in
    f32 and within 2^-8 (|o| + obar) + 5e-5 elementwise, lse within
    1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Tq, Tk, H, D, causal, q_off = case
    rng = np.random.RandomState(sum(case))
    dt = getattr(torch, dtype)
    wide = torch.tensor(rng.randn(B, Tq, H, 2 * D + 8).astype(np.float32))
    q = wide.to("cuda", dt)[..., q_off:q_off + D]
    k, v = (torch.tensor(rng.randn(B, Tk, H, D).astype(np.float32)
                         ).to("cuda", dt) for _ in range(2))
    if dtype == "float32":
        assert kernels.f32_vector_loads(q, k, v) == (D % 4 == 0 and q_off == 0)
    else:
        assert kernels.bf16_vector_loads(q, k, v) == \
            (D % 8 == 0 and q_off == 0)
    name = ("flash_attention" if dtype == "float32"
            or D > kernels.FLASH_MAX_HEAD_DIM else "flash_attention_bf16")
    before = dict(kernels.launch_counts)
    o, lse = kernels.flash_attention_fwd(q, k, v, D ** -0.5, causal)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in kernels.launch_counts.items()} == \
        {n: int(n == name) for n in before}
    assert o.dtype == dt and o.shape == (B, Tq, H, D)
    ro, rlse, obar = _plain_with_obar(q, k, v, D ** -0.5, causal)
    diff = (o.float() - ro).abs()
    err_o = diff.max().item()
    err_lse = (lse - rlse).abs().max().item()
    assert err_lse <= 1e-4, err_lse
    if dtype == "float32":
        assert err_o <= 5e-5, err_o
    else:
        share = (diff / (BF16_REL * (ro.abs() + obar) + F32_ABS)).max().item()
        assert err_o <= 3e-2 and share <= 1.0, (err_o, share)


_NCCL_WORKER = r"""
import datetime, functools, json, sys
import torch
import torch.distributed as dist

rank, world, init_file = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method="file://" + init_file,
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from mxnet_tpu_torch import kernels, parallel as par

torch.backends.cuda.matmul.allow_tf32 = False
mesh = par.make_mesh({"sp": world})
gen = torch.Generator(device="cuda")
gen.manual_seed(0)  # the same inputs on every rank
shape = (2, 1024 * world, 8, 64)
q, k, v, w = (torch.randn(shape, generator=gen, device="cuda")
              for _ in range(4))
spec = par.P(None, "sp", None, None)
ring = par.shard_map(functools.partial(par.ring_attention, axis_name="sp",
                                       use_flash=True), mesh, (spec,) * 3,
                     spec)


def ulysses(q, k, v):
    return par.ulysses_attention_sharded(mesh, q, k, v, use_flash=True)


kernels.reset_launch_counts()
outs = {"ring_flash": ring(q, k, v), "ulysses_flash": ulysses(q, k, v)}
torch.cuda.synchronize()
# one launch per ring step, one for Ulysses
assert kernels.launch_counts["flash_attention"] == world + 1, \
    kernels.launch_counts
outs["ring_causal"] = par.ring_attention_sharded(mesh, q, k, v, causal=True)
outs["ulysses_causal"] = par.ulysses_attention_sharded(mesh, q, k, v,
                                                       causal=True)
refs = {False: par.local_attention(q, k, v),
        True: par.local_attention(q, k, v, causal=True)}
errs = {n: (o - refs["causal" in n]).abs().max().item()
        for n, o in outs.items()}
leaves = [t.clone().requires_grad_() for t in (q, k, v)]
(par.local_attention(*leaves) * w).sum().backward()
for name, fn in (("ring_flash", ring), ("ulysses_flash", ulysses)):
    mine = [t.clone().requires_grad_() for t in (q, k, v)]
    (fn(*mine) * w).sum().backward()
    errs[name + "_grad"] = max((a.grad - b.grad).abs().max().item()
                               for a, b in zip(mine, leaves))
print("RANK_OK", json.dumps(errs), flush=True)
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_cuda_sequence_parallel_engines_across_cards(tmp_path):
    """Ring and Ulysses over NCCL on up to four cards: flash and causal
    outputs against local attention on the whole input (5e-5 flash, 1e-4
    ring / 2e-5 Ulysses dense, the JAX suite's bounds), and dq/dk/dv of
    both flash engines against plain autograd within 5e-4."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs (NCCL)")
    world = min(torch.cuda.device_count(), 4)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _NCCL_WORKER, str(r), str(world),
         str(tmp_path / "pg_init")], cwd=str(root), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    limits = {"ring_flash": 5e-5, "ulysses_flash": 5e-5, "ring_causal": 1e-4,
              "ulysses_causal": 2e-5, "ring_flash_grad": 5e-4,
              "ulysses_flash_grad": 5e-4}
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "RANK_OK" in out, err[-3000:]
        errs = json.loads(out.split("RANK_OK", 1)[1].splitlines()[0])
        for name, limit in limits.items():
            assert errs[name] <= limit, (name, errs[name])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_cuda_flash_takes_any_scale(scale, dtype):
    """A negative or zero scale, causal with ragged keys, as the TPU kernel
    takes it: the bf16 kernel keeps its scores unscaled and flips Q's
    sign for a negative scale, and zeroes masked keys itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels)")
    rng = np.random.RandomState(7)
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(rng.randn(1, 100, 2, 64).astype(np.float32)
                            ).to("cuda", dt) for _ in range(3))
    o, lse = kernels.flash_attention_fwd(q, k[:, :70], v[:, :70], scale, True)
    torch.cuda.synchronize()
    ro, rlse, obar = _plain_with_obar(q, k[:, :70], v[:, :70], scale, True)
    diff = (o.float() - ro).abs()
    assert (lse - rlse).abs().max().item() <= 1e-4
    if dtype == "float32":
        assert diff.max().item() <= 5e-5
    else:
        assert (diff / (BF16_REL * (ro.abs() + obar) + F32_ABS)).max() <= 1.0
