"""The port's Executor (mxnet_tpu_torch.executor) held against the JAX
package's on the CPU with the same weights: simple_bind and bind,
forward and backward under grad_req write, add and null, BatchNorm's
moving-stat updates in training, reshape, copy_params_from and the
monitor callback.  The compiled path runs with torch.compile's
``aot_eager`` backend (``jit._BACKEND``), which keeps the CPU suite's time
(inductor's code generation adds ~20 s a graph here).  Values come from
numpy with a seed; JAX at ``default_matmul_precision("float32")``, torch
at ``"highest"``; tolerance rtol 1e-5, atol 1e-6 (for gradients, 1e-6
x the largest gradient magnitude, ``_assert_state`` says why)."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def _net(pkg):
    s = pkg.sym
    with pkg.name.NameManager():
        net = s.Convolution(s.var("data"), kernel=(3, 3), num_filter=4,
                            pad=(1, 1), name="conv")
        net = s.BatchNorm(net, fix_gamma=False, momentum=0.8, name="bn")
        net = s.Activation(net, act_type="tanh")
        net = s.FullyConnected(s.Flatten(net), num_hidden=5, name="fc")
        return s.SoftmaxOutput(net, s.var("softmax_label"), name="softmax")


SHAPES = {"data": (4, 2, 6, 6), "softmax_label": (4,)}


def _values(sym, shapes, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for n, shp in zip(sym.list_arguments(), arg_shapes):
        args[n] = (rng.randint(0, 5, shp) if n.endswith("label")
                   else rng.randn(*shp) * 0.5).astype(np.float32)
    aux = {n: (rng.rand(*shp) + 0.5).astype(np.float32)
           for n, shp in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _ctx(pkg):
    return tmx.cpu() if pkg is tmx else jmx.cpu()


def _simple_bind(pkg, grad_req, shapes=SHAPES, seed=0):
    sym = _net(pkg)
    ex = sym.simple_bind(ctx=_ctx(pkg), grad_req=grad_req, **shapes)
    args, aux = _values(sym, shapes, seed)
    for n, v in args.items():
        ex.arg_dict[n][:] = v
    for n, v in aux.items():
        ex.aux_dict[n][:] = v
    return ex


def _state(ex):
    return ([o.asnumpy() for o in ex.outputs],
            {n: g.asnumpy() for n, g in ex.grad_dict.items()},
            {n: a.asnumpy() for n, a in ex.aux_dict.items()})


def _assert_state(got, want):
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert sorted(got[1]) == sorted(want[1])
    # conv_bias feeds a BatchNorm in training, so its exact gradient is 0
    # and both packages give f32 noise there (up to ~1e-6): gradients
    # take an atol of 1e-6 x the step's largest gradient magnitude
    scale = max([np.abs(g).max() for g in want[1].values()] + [1.0])
    for n in want[1]:
        np.testing.assert_allclose(got[1][n], want[1][n], rtol=RTOL,
                                   atol=ATOL * scale, err_msg=n)
    for n in want[2]:
        np.testing.assert_allclose(got[2][n], want[2][n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


@pytest.mark.parametrize("grad_req", ["write", "add", "null", "mixed"])
def test_simple_bind_forward_backward_matches_jax(grad_req):
    req = grad_req if grad_req != "mixed" else {
        "conv_weight": "write", "conv_bias": "null", "bn_gamma": "add",
        "bn_beta": "write", "fc_weight": "add", "fc_bias": "write"}
    states = []
    for pkg in (jmx, tmx):
        ex = _simple_bind(pkg, req)
        for _ in range(2):  # 'add' accumulates the two backward passes
            ex.forward(is_train=True)
            ex.backward()
        states.append(_state(ex))
    _assert_state(states[1], states[0])
    if grad_req == "null":
        assert states[1][1] == {}


def test_bind_and_inference_match_jax():
    outs = []
    for pkg in (jmx, tmx):
        sym = _net(pkg)
        args, aux = _values(sym, SHAPES, seed=1)
        nd = {k: (pkg.nd.array(v, ctx=tmx.cpu()) if pkg is tmx
                  else pkg.nd.array(v)) for k, v in args.items()}
        nx = {k: (pkg.nd.array(v, ctx=tmx.cpu()) if pkg is tmx
                  else pkg.nd.array(v)) for k, v in aux.items()}
        grads = {k: v.zeros_like() for k, v in nd.items()
                 if k != "softmax_label"}
        ex = sym.bind(_ctx(pkg), nd, args_grad=grads, grad_req="write",
                      aux_states=nx)
        # inference normalizes with the moving stats and leaves them
        o1 = ex.forward(is_train=False)[0].asnumpy()
        ex.forward(is_train=True, data=nd["data"] * 2.0)
        ex.backward()
        outs.append((o1, _state(ex)))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=RTOL, atol=ATOL)
    _assert_state(outs[1][1], outs[0][1])


def test_aux_updates_follow_momentum():
    ex = _simple_bind(tmx, "write")
    before = {n: a.asnumpy() for n, a in ex.aux_dict.items()}
    ex.forward(is_train=True)
    after = {n: a.asnumpy() for n, a in ex.aux_dict.items()}
    # conv output's batch mean per channel, momentum 0.8
    conv = tmx.nd.Convolution(
        ex.arg_dict["data"], ex.arg_dict["conv_weight"],
        ex.arg_dict["conv_bias"], kernel=(3, 3), num_filter=4,
        pad=(1, 1)).asnumpy()
    mean = conv.mean(axis=(0, 2, 3))
    np.testing.assert_allclose(after["bn_moving_mean"],
                               0.8 * before["bn_moving_mean"] + 0.2 * mean,
                               rtol=1e-5, atol=1e-6)
    ex.forward(is_train=False)
    np.testing.assert_array_equal(ex.aux_dict["bn_moving_mean"].asnumpy(),
                                  after["bn_moving_mean"])


def test_reshape_and_copy_params_from_match_jax():
    states = []
    for pkg in (jmx, tmx):
        ex = _simple_bind(pkg, "write")
        ex2 = ex.reshape(data=(2, 2, 6, 6), softmax_label=(2,))
        assert ex2.arg_dict["conv_weight"] is ex.arg_dict["conv_weight"]
        src = _simple_bind(pkg, "write", seed=7)
        ex2.copy_params_from(
            {k: v for k, v in src.arg_dict.items()
             if k not in ("data", "softmax_label")}, src.aux_dict)
        rng = np.random.RandomState(3)
        ex2.arg_dict["data"][:] = rng.randn(2, 2, 6, 6).astype(np.float32)
        ex2.arg_dict["softmax_label"][:] = np.array([1, 3], np.float32)
        ex2.forward(is_train=True)
        ex2.backward()
        states.append(_state(ex2))
        with pytest.raises(Exception):
            ex2.copy_params_from({"nope": src.arg_dict["fc_bias"]})
    _assert_state(states[1], states[0])


def test_output_dict_monitor_and_errors():
    ex = _simple_bind(tmx, "write")
    seen = []
    ex.set_monitor_callback(lambda name, arr: seen.append((name, arr.shape)))
    ex.forward(is_train=False)
    assert seen == [("softmax_output", (4, 5))]
    assert list(ex.output_dict) == ["softmax_output"]
    assert [a.shape for a in ex.arg_arrays][:2] == [(4, 2, 6, 6), (4, 2, 3, 3)]
    assert ex.grad_arrays[0] is ex.grad_dict["data"]
    assert "softmax_output" in ex.debug_str()
    with pytest.raises(MXNetError, match="before forward"):
        ex.backward()
    with pytest.raises(MXNetError, match="missing arguments"):
        _net(tmx).bind(tmx.cpu(), {})
    with pytest.raises(MXNetError, match="not ported yet"):
        _net(tmx).simple_bind(ctx=tmx.cpu(), aot="x", **SHAPES)
    # remat_policy is ported (remat.py): an unknown name raises as in the
    # JAX package
    with pytest.raises(ValueError, match="unknown remat_policy"):
        _net(tmx).simple_bind(ctx=tmx.cpu(), remat_policy="x", **SHAPES)


def test_dtype_policy_keeps_data_and_labels():
    from mxnet_tpu_torch.executor import _DATA_INPUT_RE
    for name in ("data", "data0", "softmax_label", "label", "x_data"):
        assert _DATA_INPUT_RE.search(name), name
    for name in ("fc_weight", "bn_gamma", "database_bias"):
        assert not _DATA_INPUT_RE.search(name), name
    ex = _net(tmx).simple_bind(ctx=tmx.cpu(), dtype_policy="bf16_mixed",
                               **SHAPES)
    out = ex.forward(is_train=False)[0]
    assert out.dtype == np.float32 and out.shape == (4, 5)
