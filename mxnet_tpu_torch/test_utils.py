"""Test helpers (parity: mxnet_tpu/test_utils.py; reference
python/mxnet/test_utils.py: assert_almost_equal:474,
check_numeric_gradient:801, check_consistency:1224, rand_ndarray:343,
default_context).

Arrays are made on ``default_context()``: the context set by
``set_default_context``, else the current one (``gpu(0)`` unless a
``with mx.cpu():`` scope is open).  ``check_consistency`` runs one symbol
on each context of its list (the card and the host, say) and compares
outputs and gradients."""
from __future__ import annotations

import numpy as np

from .base import MXNetError
from .context import cpu, current_context
from .ndarray.ndarray import NDArray, array, zeros

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "almost_equal", "same", "rand_shape_2d", "rand_shape_3d",
           "rand_shape_nd", "rand_ndarray", "random_arrays",
           "check_numeric_gradient", "check_consistency", "simple_forward",
           "assert_exception", "list_gpus", "download"]

_default_ctx = None


def default_context():
    return _default_ctx or current_context()


def set_default_context(ctx):
    global _default_ctx
    _default_ctx = ctx


def default_dtype():
    return np.float32


def _as_np(a):
    return a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)


def same(a, b):
    return np.array_equal(_as_np(a), _as_np(b))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    return np.allclose(_as_np(a), _as_np(b), rtol=rtol or 1e-5,
                       atol=atol or 1e-20, equal_nan=equal_nan)


def _dtype_tols(dtype):
    dt = np.dtype(dtype)
    if dt == np.float16:
        return 1e-2, 1e-2
    if dt.name == "bfloat16":
        return 2e-2, 2e-2
    if dt == np.float32:
        return 1e-4, 1e-5
    return 1e-7, 1e-9


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    a_np, b_np = _as_np(a), _as_np(b)
    if rtol is None or atol is None:
        r1, t1 = _dtype_tols(a_np.dtype)
        r2, t2 = _dtype_tols(b_np.dtype)
        rtol = rtol if rtol is not None else max(r1, r2)
        atol = atol if atol is not None else max(t1, t2)
    if not np.allclose(a_np.astype(np.float64), b_np.astype(np.float64),
                       rtol=rtol, atol=atol, equal_nan=equal_nan):
        err = np.abs(a_np.astype(np.float64) - b_np.astype(np.float64))
        rel = err / (np.abs(b_np.astype(np.float64)) + atol)
        raise AssertionError(
            "%s and %s differ: max abs err %g, max rel err %g "
            "(rtol=%g atol=%g)"
            % (names[0], names[1], err.max(), rel.max(), rtol, atol))


def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1),
            np.random.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=num_dim))


def random_arrays(*shapes):
    arrays = [np.array(np.random.randn(), dtype=np.float32) if not s
              else np.random.randn(*s).astype(np.float32) for s in shapes]
    if len(arrays) == 1:
        return arrays[0]
    return arrays


def rand_ndarray(shape, stype="default", density=None, dtype=None,
                 distribution="uniform"):
    """Uniform [-1, 1) values from numpy's global stream, on
    ``default_context()``; for a sparse ``stype`` each element kept with
    probability ``density`` (0.5)."""
    ctx = default_context()
    a = np.random.uniform(-1, 1, size=shape).astype(dtype or np.float32)
    if stype == "default":
        return array(a, ctx=ctx)
    density = 0.5 if density is None else density
    mask = np.random.uniform(size=shape) < density
    a = a * mask
    return array(a, ctx=ctx).tostype(stype)


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    ctx = ctx or default_context()
    shapes = {k: v.shape for k, v in inputs.items()}
    exe = sym.simple_bind(ctx=ctx, grad_req="null", **shapes)
    for k, v in inputs.items():
        exe.arg_dict[k]._rebind(array(v, ctx=ctx)._data)
    exe.forward(is_train=is_train)
    outputs = [o.asnumpy() for o in exe.outputs]
    return outputs[0] if len(outputs) == 1 else outputs


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None, dtype=np.float64):
    """Finite differences vs executor.backward (reference :801)."""
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(arg_names, location))
    location = {k: np.asarray(v.asnumpy() if isinstance(v, NDArray) else v,
                              dtype=np.float64) for k, v in location.items()}
    if grad_nodes is None:
        grad_nodes = list(location)

    args = {k: array(v.astype(np.float32), ctx=ctx)
            for k, v in location.items()}
    grads = {k: zeros(v.shape, ctx=ctx) for k, v in location.items()}
    aux = {}
    if aux_states:
        aux_names = sym.list_auxiliary_states()
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        aux = {k: array(np.asarray(
            v.asnumpy() if isinstance(v, NDArray) else v), ctx=ctx)
            for k, v in aux_states.items()}
    exe = sym.bind(ctx=ctx, args=args, args_grad=grads, aux_states=aux)
    exe.forward(is_train=True)
    exe.backward()
    sym_grads = {k: grads[k].asnumpy() for k in grad_nodes}

    # one executor for every finite-difference evaluation: the shapes
    # never change, so its compiled function is reused
    eval_exe = sym.bind(
        ctx=ctx,
        args={k: array(v.astype(np.float32), ctx=ctx)
              for k, v in location.items()},
        grad_req="null", aux_states={k: v.copy() for k, v in aux.items()})
    aux_host = {k: v.asnumpy() for k, v in aux.items()}

    def eval_at(loc):
        # train-mode forwards update aux (moving stats): every evaluation
        # starts from the same values
        for k, v in aux_host.items():
            eval_exe.aux_dict[k]._rebind(array(v, ctx=ctx)._data)
        feed = {k: array(v.astype(np.float32), ctx=ctx)
                for k, v in loc.items()}
        eval_exe.forward(is_train=use_forward_train, **feed)
        return float(np.sum(eval_exe.outputs[0].asnumpy()))

    for name in grad_nodes:
        base = location[name]
        num_grad = np.zeros_like(base)
        flat = base.reshape(-1)
        ng_flat = num_grad.reshape(-1)
        for i in range(flat.size):
            old = flat[i]
            flat[i] = old + numeric_eps
            fp = eval_at(location)
            flat[i] = old - numeric_eps
            fm = eval_at(location)
            flat[i] = old
            ng_flat[i] = (fp - fm) / (2 * numeric_eps)
        assert_almost_equal(num_grad, sym_grads[name], rtol=rtol,
                            atol=atol or 1e-4,
                            names=("numeric_%s" % name, "symbolic_%s" % name))


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True, ground_truth=None, equal_nan=False,
                      use_uniform=False, rand_type=np.float64):
    """Run the same symbol on a list of context/dtype configs and
    compare outputs and gradients with the first's (reference
    test_utils.py:1224: the card against the host, say)."""
    if tol is None:
        tol = {np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-3,
               np.dtype(np.float64): 1e-5, np.dtype(np.uint8): 0,
               np.dtype(np.int32): 0, np.dtype(np.int64): 0}
    elif isinstance(tol, numbers_types):
        tol = {np.dtype(t): tol for t in (np.float16, np.float32, np.float64,
                                          np.uint8, np.int32, np.int64)}
    syms = sym if isinstance(sym, list) else [sym] * len(ctx_list)
    exe_list = []
    arg_names = syms[0].list_arguments()
    shapes = {k: v for k, v in ctx_list[0].items() if k != "ctx"
              and k.endswith("shape") or isinstance(v, tuple)}

    # build per-ctx executors with identical random inputs
    base_inputs = None
    outputs = []
    gradients = []
    for s, spec in zip(syms, ctx_list):
        ctx = spec.get("ctx", cpu())
        type_dict = spec.get("type_dict", {})
        kw_shapes = {k: v for k, v in spec.items()
                     if isinstance(v, tuple)}
        arg_shapes, _, aux_shapes = s.infer_shape(**kw_shapes)
        if base_inputs is None:
            if use_uniform:
                base_inputs = [np.random.uniform(-0.5, 0.5, size=shp)
                               for shp in arg_shapes]
            else:
                base_inputs = [np.random.normal(size=shp, scale=scale)
                               for shp in arg_shapes]
            base_aux = [np.random.normal(size=shp, scale=scale)
                        for shp in aux_shapes]
        args = {}
        for name, shp, val in zip(s.list_arguments(), arg_shapes, base_inputs):
            dtype = type_dict.get(name, np.float32)
            if arg_params and name in arg_params:
                val = arg_params[name]
            args[name] = array(np.asarray(val).astype(dtype), ctx=ctx)
        aux = {}
        for name, shp, val in zip(s.list_auxiliary_states(), aux_shapes,
                                  base_aux):
            if aux_params and name in aux_params:
                val = aux_params[name]
            aux[name] = array(np.asarray(val).astype(np.float32), ctx=ctx)
        grads = {name: zeros(a.shape, ctx=ctx) for name, a in args.items()} \
            if grad_req != "null" else {}
        exe = s.bind(ctx=ctx, args=args, args_grad=grads, grad_req=grad_req,
                     aux_states=aux)
        exe.forward(is_train=(grad_req != "null"))
        if grad_req != "null":
            exe.backward([array(np.ones(o.shape, dtype=np.float32),
                                ctx=ctx)
                          for o in exe.outputs] if len(exe.outputs) else None)
            gradients.append({k: v.asnumpy() for k, v in grads.items()})
        outputs.append([o.asnumpy() for o in exe.outputs])
        exe_list.append(exe)

    gt = ground_truth
    ref_out = outputs[0] if gt is None else gt
    for i, outs in enumerate(outputs[1:], 1):
        dt = np.dtype(np.float32)
        t = tol.get(dt, 1e-3)
        for o_ref, o in zip(ref_out, outs):
            assert_almost_equal(o, o_ref, rtol=t, atol=t, equal_nan=equal_nan)
    if grad_req != "null":
        for g in gradients[1:]:
            for k in gradients[0]:
                t = tol.get(np.dtype(np.float32), 1e-3)
                assert_almost_equal(g[k], gradients[0][k], rtol=t, atol=t,
                                    equal_nan=equal_nan)
    return exe_list


import numbers as _numbers  # noqa: E402

numbers_types = (_numbers.Number,)


def assert_exception(f, exception_type, *args, **kwargs):
    try:
        f(*args, **kwargs)
    except exception_type:
        return
    raise AssertionError("did not raise %s" % exception_type)


def list_gpus():
    from .context import num_gpus

    return list(range(num_gpus()))


def download(url, fname=None, dirname=None, overwrite=False, retries=5):
    raise MXNetError("network access is unavailable in this environment")


def backend_supports_host_callbacks():
    """True: the port's custom ops run eagerly or as torch custom ops, so
    it has no backend without host callbacks (the JAX package asks of its
    PJRT plugin)."""
    return True
