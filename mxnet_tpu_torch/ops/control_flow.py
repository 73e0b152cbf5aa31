"""Control-flow operators: foreach, while_loop and cond (parity:
mxnet_tpu/ops/control_flow.py; the reference's python/mxnet/ndarray/
contrib.py:136,232,400, symbol/contrib.py:212,375,598 and
src/operator/control_flow.cc).

Eager code runs the loop in Python over taped ops, as the reference's
imperative versions and the JAX package's concrete path do, so
gradients flow through loop-carried state and captured arrays.  In a
compiled graph (a hybridized block, an ``Executor``) the same Python
loop is unrolled by dynamo where the JAX package has ``lax.scan``;
``while_loop`` becomes a masked loop of ``max_iterations`` steps (the
JAX package's masked scan: a step past the end keeps the loop variables
and writes zeros) and ``cond`` a ``torch.where`` over both branches, as
a value the host cannot read must not decide which code runs.
``foreach`` stacks the step outputs on axis 0; ``while_loop`` pads its
stacked outputs with zeros to ``max_iterations`` rows; ``cond`` reads a
one-element predicate.
"""
from __future__ import annotations

import itertools

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["foreach", "while_loop", "cond",
           "sym_foreach", "sym_while_loop", "sym_cond"]

_uid = itertools.count()


# ---------------------------------------------------------------------------
# nested-structure helpers (parity: _flatten/_regroup in python/mxnet/base.py)
# ---------------------------------------------------------------------------


def _flatten(obj):
    """Flatten nested lists/tuples into (leaves, format-template)."""
    if isinstance(obj, (list, tuple)):
        flat, fmt = [], []
        for item in obj:
            f, sub = _flatten(item)
            flat.extend(f)
            fmt.append(sub)
        return flat, fmt
    return [obj], 0


def _regroup(flat, fmt):
    """Inverse of _flatten; returns (structure, leftovers)."""
    if fmt == 0:
        return flat[0], flat[1:]
    out = []
    for sub in fmt:
        item, flat = _regroup(flat, sub)
        out.append(item)
    return out, flat


def _shape(flat, fmt):
    return _regroup(flat, fmt)[0]


def _leaf_count(fmt):
    if fmt == 0:
        return 1
    return sum(_leaf_count(f) for f in fmt)


def _pred(t):
    """A one-element predicate tensor as a boolean scalar tensor."""
    return t.reshape(-1)[0].to(torch.bool)


def _masked_loop(cond_fn, func_fn, cur, max_iter):
    """``max_iter`` steps of ``func_fn`` on the tensors ``cur``: a step
    whose predicate is false keeps ``cur`` and writes zero outputs, and
    once false the predicate stays false.  Returns (stacked outputs,
    final loop tensors)."""
    alive = _pred(cond_fn(cur))
    rows = []
    for _ in range(max_iter):
        outs, new = func_fn(cur)
        rows.append([torch.where(alive, o, torch.zeros_like(o))
                     for o in outs])
        cur = [torch.where(alive, n, c) for n, c in zip(new, cur)]
        alive = alive & _pred(cond_fn(cur))
    return [torch.stack(col) for col in zip(*rows)], cur


# ---------------------------------------------------------------------------
# imperative surface (mx.nd.contrib.*)
# ---------------------------------------------------------------------------


def _check_nd(flat, what):
    from ..ndarray.ndarray import NDArray

    for x in flat:
        if not isinstance(x, NDArray):
            raise MXNetError("%s should be an NDArray or a nested list of "
                             "NDArrays, got %r" % (what, type(x)))


def foreach(body, data, init_states):
    """Run ``body`` over axis 0 of ``data``, threading loop state.

    ``out, states = body(slice, states)``; returns (outputs stacked on
    axis 0, final states).  Parity: ``ndarray/contrib.py:136``."""
    from ..ndarray.ndarray import _invoke_nd, zeros as nd_zeros

    flat_data, data_fmt = _flatten(data)
    flat_states, _ = _flatten(init_states)
    _check_nd(flat_data, "data")
    _check_nd(flat_states, "init_states")
    if not flat_data:
        raise MXNetError("foreach needs at least one data array")
    n = flat_data[0].shape[0]
    if n == 0:
        # the output shapes come from one step on zeros, thrown away
        probe = _shape([nd_zeros(d.shape[1:], ctx=d.context, dtype=d.dtype)
                        for d in flat_data], data_fmt)
        out, _ = body(probe, init_states)
        flat_out, out_fmt = _flatten(out)
        empty = [nd_zeros((0,) + o.shape, ctx=o.context, dtype=o.dtype)
                 for o in flat_out]
        return _shape(empty, out_fmt), init_states
    states = init_states
    rows, out_fmt = [], 0
    for i in range(n):
        out, states = body(_shape([d[i] for d in flat_data], data_fmt),
                           states)
        flat_out, out_fmt = _flatten(out)
        rows.append(flat_out)
    stacked = [_invoke_nd("stack", list(col), {"axis": 0})
               for col in zip(*rows)]
    return _shape(stacked, out_fmt), states


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Run ``func`` while ``cond`` holds, at most ``max_iterations``
    times.  Returns (step outputs stacked and padded with zeros to
    ``max_iterations`` rows, final loop_vars).  Parity:
    ``ndarray/contrib.py:232``."""
    from ..ndarray.ndarray import NDArray, _invoke_nd, zeros as nd_zeros

    if max_iterations is None:
        raise ValueError("max_iterations should be specified")
    max_iterations = int(max_iterations.asscalar()
                         if isinstance(max_iterations, NDArray)
                         else max_iterations)
    flat_vars, var_fmt = _flatten(loop_vars)
    if not flat_vars:
        raise ValueError("loop_vars should contain at least one element")
    _check_nd(flat_vars, "loop_vars")

    def as_args(flat_nd):
        """The caller's loop_vars structure as call arguments."""
        top = _shape(flat_nd, var_fmt)
        return [top] if var_fmt == 0 else list(top)

    def call_func(flat_nd):
        step_out, new_vars = func(*as_args(flat_nd))
        step_out = [] if step_out is None else step_out
        flat_new, _ = _flatten([] if new_vars is None else new_vars)
        if len(flat_new) != len(flat_vars):
            raise ValueError("The length of loop_vars should be consistent "
                             "during the loop")
        return step_out, flat_new

    if torch.compiler.is_compiling():
        fmt_box = {}

        def func_t(cur):
            step_out, flat_new = call_func([NDArray(c) for c in cur])
            flat_out, fmt_box["out"] = _flatten(step_out)
            return [o._data for o in flat_out], [v._data for v in flat_new]

        stacked, final = _masked_loop(
            lambda cur: cond(*as_args([NDArray(c) for c in cur]))._data,
            func_t, [v._data for v in flat_vars], max_iterations)
        return (_shape([NDArray(s) for s in stacked], fmt_box["out"]),
                _shape([NDArray(v) for v in final], var_fmt))

    cur = list(flat_vars)
    rows, out_fmt, steps = [], None, 0
    while steps < max_iterations and bool(cond(*as_args(cur)).asscalar()):
        step_out, cur = call_func(cur)
        flat_out, out_fmt = _flatten(step_out)
        rows.append(flat_out)
        steps += 1
    if not rows:
        return [], _shape(cur, var_fmt)
    cols = []
    for col in zip(*rows):
        stacked = _invoke_nd("stack", list(col), {"axis": 0})
        if steps < max_iterations:
            pad = nd_zeros((max_iterations - steps,) + col[0].shape,
                           ctx=col[0].context, dtype=col[0].dtype)
            stacked = _invoke_nd("concat", [stacked, pad], {"dim": 0})
        cols.append(stacked)
    return _shape(cols, out_fmt), _shape(cur, var_fmt)


def cond(pred, then_func, else_func):
    """If-then-else on a one-element predicate.  Parity:
    ``ndarray/contrib.py:400``."""
    from ..ndarray.ndarray import NDArray

    if not isinstance(pred, NDArray):
        raise MXNetError("pred should be an NDArray")
    if not torch.compiler.is_compiling():
        # run only the chosen branch (taped when recording)
        return then_func() if bool(pred.asscalar()) else else_func()
    then_flat, then_fmt = _flatten(then_func())
    else_flat, else_fmt = _flatten(else_func())
    if then_fmt != else_fmt:
        raise ValueError("then_func and else_func must produce outputs of "
                         "the same structure")
    p = _pred(pred._data)
    return _shape([NDArray(torch.where(p, t._data, e._data))
                   for t, e in zip(then_flat, else_flat)], then_fmt)


# ---------------------------------------------------------------------------
# registered graph ops (Symbol executor path)
# ---------------------------------------------------------------------------


def _n_cf_outputs(attrs):
    return attrs["_n_out"] + attrs.get("_n_state", 0)


@register("_foreach", num_inputs=-1, num_outputs=_n_cf_outputs)
def _foreach_op(*arrays, _sub=None, _n_data=0, _n_state=0, _n_out=0,
                _data_names=(), _state_names=(), _cap_names=()):
    """Graph form of foreach: inputs are [data..., states...,
    captured...]; outputs are [stacked step outputs..., final
    states...]."""
    data = arrays[:_n_data]
    states = list(arrays[_n_data:_n_data + _n_state])
    caps = dict(zip(_cap_names, arrays[_n_data + _n_state:]))
    rows = []
    for i in range(data[0].shape[0]):
        vm = dict(zip(_state_names, states))
        vm.update(zip(_data_names, (d[i] for d in data)))
        vm.update(caps)
        outs, _ = _sub(vm)
        rows.append(outs[:_n_out])
        states = list(outs[_n_out:])
    res = tuple(torch.stack(col) for col in zip(*rows)) + tuple(states)
    return res if len(res) > 1 else res[0]


@register("_while_loop", num_inputs=-1, num_outputs=_n_cf_outputs)
def _while_loop_op(*arrays, _cond_sub=None, _func_sub=None, _n_state=0,
                   _n_out=0, _max_iter=0, _state_names=(), _cap_names=()):
    """Graph form of while_loop: the masked loop of ``_max_iter``
    steps."""
    caps = dict(zip(_cap_names, arrays[_n_state:]))

    def vm_of(cur):
        vm = dict(zip(_state_names, cur))
        vm.update(caps)
        return vm

    def func_t(cur):
        outs, _ = _func_sub(vm_of(cur))
        return outs[:_n_out], outs[_n_out:]

    stacked, final = _masked_loop(lambda cur: _cond_sub(vm_of(cur))[0][0],
                                  func_t, list(arrays[:_n_state]),
                                  _max_iter)
    res = tuple(stacked) + tuple(final)
    return res if len(res) > 1 else res[0]


@register("_cond", num_inputs=-1, num_outputs=lambda attrs: attrs["_n_out"])
def _cond_op(*arrays, _then_sub=None, _else_sub=None, _then_caps=(),
             _else_caps=(), _n_out=0):
    """Graph form of cond: inputs are [pred, then-captures...,
    else-captures...]; both branches run and ``torch.where`` picks."""
    nt = len(_then_caps)
    then_outs, _ = _then_sub(dict(zip(_then_caps, arrays[1:1 + nt])))
    else_outs, _ = _else_sub(dict(zip(_else_caps, arrays[1 + nt:])))
    p = _pred(arrays[0])
    outs = tuple(torch.where(p, t, e) for t, e in zip(then_outs, else_outs))
    return outs if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# symbolic surface (mx.sym.contrib.*)
# ---------------------------------------------------------------------------


def _trace_subgraph(build, placeholders):
    """Build a Symbol-level closure's graph; returns (value-map
    function, captured names, captured Symbols): every variable that is
    not a placeholder is captured from the enclosing graph."""
    from ..symbol import symbol as S

    sub = S.Group(build())
    fn, _, _ = sub._build_fn()
    ph = set(placeholders)
    cap_names, cap_syms = [], []
    arg_nodes, aux_nodes = sub._arg_nodes(with_aux=True)
    for node in list(arg_nodes) + list(aux_nodes):
        if node.name not in ph:
            cap_names.append(node.name)
            cap_syms.append(S.Symbol([(node, 0)]))
    return fn, cap_names, cap_syms


def sym_foreach(body, data, init_states, name="foreach"):
    """Symbol foreach (parity: symbol/contrib.py:212)."""
    from ..symbol import symbol as S

    flat_data, data_fmt = _flatten(data)
    flat_states, state_fmt = _flatten(init_states)
    uid = next(_uid)
    data_names = ["_cf%d_data%d" % (uid, i) for i in range(len(flat_data))]
    state_names = ["_cf%d_state%d" % (uid, i)
                   for i in range(len(flat_states))]
    fmt_box = {}

    def build():
        eles = _shape([S.var(n) for n in data_names], data_fmt)
        states = _shape([S.var(n) for n in state_names], state_fmt)
        out, new_states = body(eles, states)
        flat_out, fmt_box["out"] = _flatten(out)
        flat_new, _ = _flatten(new_states)
        return flat_out + flat_new

    fn, cap_names, cap_syms = _trace_subgraph(
        build, data_names + state_names)
    n_out = _leaf_count(fmt_box["out"])
    res = S._invoke_sym(
        "_foreach", flat_data + flat_states + cap_syms,
        {"_sub": fn, "_n_data": len(flat_data),
         "_n_state": len(flat_states), "_n_out": n_out,
         "_data_names": tuple(data_names),
         "_state_names": tuple(state_names),
         "_cap_names": tuple(cap_names)}, name=name)
    outs = _shape([res[i] for i in range(n_out)], fmt_box["out"])
    states = _shape([res[n_out + i] for i in range(len(flat_states))],
                    state_fmt)
    return outs, states


def sym_while_loop(cond, func, loop_vars, max_iterations=None,
                   name="while_loop"):
    """Symbol while_loop (parity: symbol/contrib.py:375)."""
    from ..symbol import symbol as S

    if max_iterations is None:
        raise ValueError("max_iterations should be specified")
    single = isinstance(loop_vars, S.Symbol)
    flat_vars = [loop_vars] if single else list(loop_vars)
    uid = next(_uid)
    state_names = ["_cf%d_var%d" % (uid, i) for i in range(len(flat_vars))]
    fmt_box = {}

    def build_cond():
        return [cond(*[S.var(n) for n in state_names])]

    def build_func():
        step_out, new_vars = func(*[S.var(n) for n in state_names])
        step_out = [] if step_out is None else step_out
        flat_out, fmt_box["out"] = _flatten(step_out)
        new_vars = [] if new_vars is None else new_vars
        new_vars = [new_vars] if isinstance(new_vars, S.Symbol) \
            else list(new_vars)
        if len(new_vars) != len(flat_vars):
            raise ValueError("The length of loop_vars should be consistent "
                             "during the loop")
        return flat_out + new_vars

    cond_fn, cond_caps, cond_cap_syms = _trace_subgraph(build_cond,
                                                        state_names)
    func_fn, func_caps, func_cap_syms = _trace_subgraph(build_func,
                                                        state_names)
    # one capture list feeds both subgraphs
    cap_names, cap_syms = list(cond_caps), list(cond_cap_syms)
    for n, s in zip(func_caps, func_cap_syms):
        if n not in cap_names:
            cap_names.append(n)
            cap_syms.append(s)
    n_out = _leaf_count(fmt_box["out"])
    res = S._invoke_sym(
        "_while_loop", flat_vars + cap_syms,
        {"_cond_sub": cond_fn, "_func_sub": func_fn,
         "_n_state": len(flat_vars), "_n_out": n_out,
         "_max_iter": int(max_iterations),
         "_state_names": tuple(state_names),
         "_cap_names": tuple(cap_names)}, name=name)
    outs = _shape([res[i] for i in range(n_out)], fmt_box["out"])
    final = [res[n_out + i] for i in range(len(flat_vars))]
    return outs, (final[0] if single else final)


def sym_cond(pred, then_func, else_func, name="cond"):
    """Symbol cond (parity: symbol/contrib.py:598)."""
    from ..symbol import symbol as S

    fmt_box = {}

    def build(fn, key):
        def run():
            flat, fmt = _flatten(fn())
            fmt_box[key] = fmt
            return flat

        return run

    then_fn, then_caps, then_cap_syms = _trace_subgraph(
        build(then_func, "then"), [])
    else_fn, else_caps, else_cap_syms = _trace_subgraph(
        build(else_func, "else"), [])
    if fmt_box["then"] != fmt_box["else"]:
        raise ValueError("then_func and else_func must produce outputs of "
                         "the same structure")
    n_out = _leaf_count(fmt_box["then"])
    res = S._invoke_sym(
        "_cond", [pred] + then_cap_syms + else_cap_syms,
        {"_then_sub": then_fn, "_else_sub": else_fn,
         "_then_caps": tuple(then_caps), "_else_caps": tuple(else_caps),
         "_n_out": n_out}, name=name)
    if n_out == 1:
        return _shape([res], fmt_box["then"])
    return _shape([res[i] for i in range(n_out)], fmt_box["then"])
