"""Sequence parallelism across ranks: the port's ring and Ulysses engines
(mxnet_tpu_torch.parallel over a gloo DeviceMesh, one process per rank)
against the JAX package's engines on the CPU mesh of tests/conftest.py,
from the same numpy inputs.

Each layout is one spawn of torch-only rank processes (subprocesses of
sys.executable, never a fork of this process, which has imported jax)
running all of its cases; the tests read what the ranks saved.  Every
rank returns the global tensor, so every rank's result is checked.
Tolerances are tests/test_parallel.py's: 1e-4 for the ring, rtol 2e-4 /
atol 2e-5 for Ulysses; data movement is compared exactly, gradients
(against jax.grad of the JAX engines) at tests/test_flash_attention.py's
5e-4.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch import parallel as tpar

ROOT = Path(__file__).resolve().parents[1]

LAYOUTS = {"sp4": ({"sp": 4}, None), "dp2sp2": ({"dp": 2, "sp": 2}, "dp"),
           "grad_sp2": ({"sp": 2}, None)}

_WORKER = r"""
import datetime, functools, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, init_file, layout, inputs, out = sys.argv[1:7]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + init_file,
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.parallel import collectives

data = np.load(inputs)
axes = {"sp4": {"sp": 4}, "dp2sp2": {"dp": 2, "sp": 2},
        "grad_sp2": {"sp": 2}}[layout]
ba = "dp" if "dp" in axes else None
mesh = par.make_mesh(axes, "cpu")
spec = par.P(ba, "sp", None, None)
q, k, v = (torch.from_numpy(data[n]) for n in ("q", "k", "v"))
res = {}


def ring_flash(q, k, v, causal=False):
    return par.shard_map(functools.partial(
        par.ring_attention, axis_name="sp", causal=causal, use_flash=True),
        mesh, (spec,) * 3, spec)(q, k, v)


def raised(fn, exc):
    try:
        fn()
    except exc as e:
        return type(e).__name__ + ": " + str(e)
    return "no error"


if layout == "grad_sp2":
    w = torch.from_numpy(data["w"])
    for name, fn in (
            ("ring_flash", ring_flash),
            ("ulysses_flash", lambda q, k, v: par.ulysses_attention_sharded(
                mesh, q, k, v, use_flash=True))):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves) * w).sum().backward()
        for g, t in zip("qkv", leaves):
            res["%s_d%s" % (name, g)] = t.grad.numpy()
else:
    res["ring_plain"] = par.ring_attention_sharded(mesh, q, k, v,
                                                   batch_axis=ba)
    res["ring_causal"] = par.ring_attention_sharded(mesh, q, k, v,
                                                    causal=True,
                                                    batch_axis=ba)
    res["ring_flash"] = ring_flash(q, k, v)
    for causal, flash, name in ((False, False, "plain"),
                                (True, False, "causal"),
                                (False, True, "flash")):
        res["ulysses_" + name] = par.ulysses_attention_sharded(
            mesh, q, k, v, causal=causal, use_flash=flash, batch_axis=ba)
    n_sp = axes["sp"]
    perm = [(i, (i + 1) % n_sp) for i in range(n_sp)]
    res["ppermute"] = par.shard_map(
        lambda x: collectives.ppermute(x, "sp", perm), mesh, (spec,),
        spec)(q)
    res["all_to_all"] = par.shard_map(
        lambda x: collectives.all_to_all(x, "sp", 2, 1), mesh, (spec,),
        par.P(ba, None, "sp", None))(q)
    x3 = q[:, :, :3].contiguous()
    res["err_divisible"] = raised(
        lambda: par.ulysses_attention_sharded(mesh, x3, x3, x3,
                                              batch_axis=ba), ValueError)
    res["err_ring_flash_causal"] = raised(
        lambda: ring_flash(q, k, v, causal=True), NotImplementedError)
    res["err_ulysses_flash_causal"] = raised(
        lambda: par.ulysses_attention_sharded(
            mesh, q, k, v, causal=True, use_flash=True, batch_axis=ba),
        NotImplementedError)
np.savez(out, **{n: (np.asarray(a) if isinstance(a, str)
                     else a.detach().numpy()
                     if isinstance(a, torch.Tensor) else a)
                 for n, a in res.items()})
dist.destroy_process_group()
"""


def _inputs(layout):
    rng = np.random.RandomState(0)
    shape = (1, 16, 2, 8) if layout == "grad_sp2" else (2, 32, 4, 16)
    data = {n: rng.rand(*shape).astype(np.float32) for n in "qkv"}
    data["w"] = rng.randn(*shape).astype(np.float32)
    return data


def _spawn(layout, tmp):
    axes, _ = LAYOUTS[layout]
    world = int(np.prod(list(axes.values())))
    data = _inputs(layout)
    np.savez(tmp / "inputs.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         str(tmp / "pg_init"), layout, str(tmp / "inputs.npz"),
         str(tmp / ("rank%d.npz" % r))],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errors = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=100)
            if p.returncode != 0:
                errors.append("rank %d rc %d:\n%s%s" % (r, p.returncode,
                                                        out, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errors, "\n".join(errors)
    ranks = [dict(np.load(tmp / ("rank%d.npz" % r))) for r in range(world)]
    return data, ranks


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    cache = {}

    def get(layout):
        if layout not in cache:
            cache[layout] = _spawn(layout, tmp_path_factory.mktemp(layout))
        return cache[layout]

    return get


def _jax_reference(case, layout, data):
    """The JAX engine's global output for one case on the CPU mesh."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    axes, ba = LAYOUTS[layout]
    mesh = jpar.make_mesh(axes, jax.devices()[:4])
    q, k, v = (jnp.asarray(data[n]) for n in "qkv")
    spec = JP(ba, "sp", None, None)
    n_sp = axes["sp"]

    def smap(fn, out_spec=spec, n_in=3):
        return jpar.shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                              out_specs=out_spec, check_vma=False)

    if case == "ring_plain":
        return jpar.ring_attention_sharded(mesh, q, k, v, batch_axis=ba)
    if case == "ring_causal":
        return jpar.ring_attention_sharded(mesh, q, k, v, causal=True,
                                           batch_axis=ba)
    if case == "ring_flash":
        return smap(functools.partial(jpar.ring_attention, axis_name="sp",
                                      use_flash=True))(q, k, v)
    if case.startswith("ulysses_"):
        return jpar.ulysses_attention_sharded(
            mesh, data["q"], data["k"], data["v"],
            causal=case == "ulysses_causal",
            use_flash=case == "ulysses_flash", batch_axis=ba)
    if case == "ppermute":
        perm = [(i, (i + 1) % n_sp) for i in range(n_sp)]
        return smap(lambda x: jax.lax.ppermute(x, "sp", perm), n_in=1)(q)
    assert case == "all_to_all"
    return smap(lambda x: jax.lax.all_to_all(x, "sp", 2, 1, tiled=True),
                out_spec=JP(ba, None, "sp", None), n_in=1)(q)


def _jax_flash_grads(engine, data):
    """dq, dk, dv of sum(engine(q, k, v) * w) through the JAX flash engine
    at sp=2 on the CPU mesh."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    mesh = jpar.make_mesh(LAYOUTS["grad_sp2"][0], jax.devices()[:2])
    q, k, v, w = (jnp.asarray(data[n]) for n in "qkvw")
    spec = JP(None, "sp", None, None)
    if engine == "ring_flash":
        fn = jpar.shard_map(functools.partial(
            jpar.ring_attention, axis_name="sp", use_flash=True), mesh=mesh,
            in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    else:
        fn = functools.partial(jpar.ulysses_attention_sharded, mesh,
                               use_flash=True)
    return jax.grad(lambda q, k, v: (fn(q, k, v) * w).sum(),
                    argnums=(0, 1, 2))(q, k, v)


CASES = ["ring_plain", "ring_causal", "ring_flash", "ulysses_plain",
         "ulysses_causal", "ulysses_flash", "ppermute", "all_to_all"]


@pytest.mark.parametrize("layout", ["sp4", "dp2sp2"])
@pytest.mark.parametrize("case", CASES)
def test_engine_matches_jax(spawned, layout, case):
    data, ranks = spawned(layout)
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(_jax_reference(case, layout, data))
    for r, res in enumerate(ranks):
        out = res[case]
        assert out.shape == ref.shape, (r, out.shape, ref.shape)
        if case in ("ppermute", "all_to_all"):
            np.testing.assert_array_equal(out, ref)
        elif case.startswith("ring"):
            np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("layout", ["sp4", "dp2sp2"])
def test_ulysses_rejects_indivisible_heads(spawned, layout):
    _, ranks = spawned(layout)
    for res in ranks:
        msg = str(res["err_divisible"])
        assert msg.startswith("ValueError") and "divisible" in msg, msg


@pytest.mark.parametrize("layout", ["sp4", "dp2sp2"])
@pytest.mark.parametrize("engine", ["ring", "ulysses"])
def test_flash_engine_rejects_causal(spawned, layout, engine):
    _, ranks = spawned(layout)
    for res in ranks:
        msg = str(res["err_%s_flash_causal" % engine])
        assert msg.startswith("NotImplementedError"), msg


@pytest.mark.parametrize("engine", ["ring_flash", "ulysses_flash"])
def test_flash_engine_gradients_match_plain_autograd(spawned, engine):
    """dq, dk, dv through the engine at sp=2 (ppermute's and all_to_all's
    backward across ranks) against jax.grad of the JAX flash engine on
    the CPU mesh, and against single-process plain autograd, each within
    5e-4."""
    data, ranks = spawned("grad_sp2")
    with jax.default_matmul_precision("float32"):
        jax_grads = [np.asarray(g) for g in _jax_flash_grads(engine, data)]
    torch.set_float32_matmul_precision("highest")
    leaves = [torch.tensor(data[n], requires_grad=True) for n in "qkv"]
    (tpar.local_attention(*leaves) * torch.from_numpy(data["w"])
     ).sum().backward()
    for r, res in enumerate(ranks):
        for g, t, ref in zip("qkv", leaves, jax_grads):
            got = res["%s_d%s" % (engine, g)]
            assert got.shape == ref.shape, (r, g, got.shape, ref.shape)
            assert np.abs(got - ref).max() < 5e-4, (r, g, "jax")
            assert np.abs(got - t.grad.numpy()).max() < 5e-4, (r, g)


@pytest.mark.parametrize("spec", ["dp=2,fsdp=2,tp=2", " sp=4 , dp=2 ",
                                  {"sp": 4}, {"ep": "2"}, "", None])
def test_parse_mesh_matches_jax(spec):
    assert tpar.parse_mesh(spec) == jpar.parse_mesh(spec)


def test_mesh_config_matches_jax():
    for kw in ({}, {"dp": 2, "sp": 2}, {"fsdp": 4, "tp": 2}):
        assert tpar.MeshConfig(**kw).axes() == jpar.MeshConfig(**kw).axes()
        assert tpar.parse_mesh(tpar.MeshConfig(**kw)) == \
            jpar.parse_mesh(jpar.MeshConfig(**kw))
    assert tpar.MESH_AXES == jpar.MESH_AXES
    assert tpar.DATA_AXES == jpar.DATA_AXES


@pytest.mark.parametrize("spec", ["xx=2", "dp=0", "dp", "dp=two", 3])
def test_parse_mesh_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError):
        jpar.parse_mesh(spec)
    with pytest.raises(ValueError):
        tpar.parse_mesh(spec)


def test_make_mesh_needs_a_process_group_for_many_ranks():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpar.make_mesh({"sp": 2}, "cpu")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tpar.make_mesh({"sp": 1, "xx": 1}, "cpu")
    assert not dist.is_initialized()


def test_one_rank_cpu_mesh_runs_the_engines():
    """make_mesh of one device starts its own one-rank group; on an axis
    of size 1 the collectives are the identity and the engines (flash
    through the plain version here) equal local attention."""
    import torch.distributed as dist

    data = _inputs("sp4")
    q, k, v = (torch.from_numpy(data[n]) for n in "qkv")
    torch.set_float32_matmul_precision("highest")
    try:
        mesh = tpar.make_mesh({"sp": 1}, "cpu")
        assert tpar.mesh_shape(mesh) == {"sp": 1}
        with pytest.raises(ValueError, match="needs mesh axis"):
            tpar.require_axes(mesh, ("sp", "dp"), who="test")
        spec = tpar.P(None, "sp", None, None)
        ring = tpar.shard_map(functools.partial(
            tpar.ring_attention, axis_name="sp", use_flash=True), mesh,
            (spec,) * 3, spec)
        ref = tpar.local_attention(q, k, v)
        for out in (ring(q, k, v),
                    tpar.ulysses_attention_sharded(mesh, q, k, v,
                                                   use_flash=True)):
            np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                                       atol=2e-5)
        np.testing.assert_allclose(
            tpar.ring_attention_sharded(mesh, q, k, v, causal=True).numpy(),
            tpar.local_attention(q, k, v, causal=True).numpy(), rtol=1e-4,
            atol=1e-4)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_collectives_need_a_bound_axis():
    with pytest.raises(NameError, match="unbound axis name"):
        tpar.collectives.axis_size("sp")
