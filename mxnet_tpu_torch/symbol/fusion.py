"""Graph-level fusion over the Symbol DAG (parity:
mxnet_tpu/symbol/fusion.py): a registry of rewrite patterns gated by the
fusion plan and its shape-keyed cost table (``fusion_cost``).

* :class:`FusionPattern` / :func:`register_pattern`: a matcher
  (``plan``) and an emitter over :func:`rewrite_graph`, whether it is on
  without a table (``default_on``: the same math as the graph it
  replaces, or a different rounding), and a ``bench_builder`` of the
  chain it matches, which :func:`microbench` times.  Registered:
  ``conv_bn_relu``, ``norm_act``, ``act_scale_add``, ``add_act`` and
  ``layer_norm_fast``, over the ops of ``ops/fused.py``.
* :func:`apply_fusion` runs the registry over a Symbol, one pass a
  pattern, each matched site decided by the plan (``fusion=``, else
  ``MXNET_FUSION``; the table from ``MXNET_FUSION_TUNE``).  The
  ``Executor`` calls it at bind.
* :func:`fold_batchnorm`: for prediction, BatchNorm's scale and shift
  folded into the weights of the Convolution or FullyConnected before
  it; the BatchNorm node leaves the graph.  It rewrites values, so it is
  an explicit call and not a pattern.
* :func:`rewrite_graph`: the rebuild every pass runs on.

Every pattern keeps the parameter and auxiliary names (the fused node
takes the same variable nodes), so ``arg_params``/``aux_params`` bind
unchanged; ``fold_batchnorm`` returns new parameter dicts, as it changes
weight values.
"""
from __future__ import annotations

import numpy as np

import torch

from ..base import MXNetError
from ..ops.registry import get_op
from ..ops.utils import pbool, pint, pfloat
from . import symbol as S

__all__ = ["rewrite_graph", "fold_batchnorm", "fuse_conv_bn_relu",
           "count_ops", "FusionPattern", "register_pattern",
           "get_pattern", "list_patterns", "apply_fusion", "microbench"]


# ---------------------------------------------------------------------------
# generic rewrite engine
# ---------------------------------------------------------------------------


def rewrite_graph(sym, emit):
    """Rebuild ``sym`` bottom-up through ``emit``.

    ``emit(node, ins, sub)`` is called for every op node in topological
    order with ``ins`` = the rebuilt single-output input Symbols, and
    ``sub`` = a function mapping any original ``(node, out_index)``
    entry to its rebuilt Symbol output (for multi-node pattern fusion).
    Return a Symbol to replace the node, or None to re-emit it
    unchanged.  Variable nodes are reused as-is, so argument/aux names
    are stable across the rewrite.
    """
    memo = {}

    def rebuild(node):
        if id(node) in memo:
            return memo[id(node)]
        if node.op is None:
            out = S.Symbol([(node, 0)])
            memo[id(node)] = out
            return out
        ins = [sub(entry) for entry in node.inputs]
        out = emit(node, ins, sub)
        if out is None:
            out = S._invoke_sym(node.op, ins, dict(node.attrs),
                                name=node.name)
        memo[id(node)] = out
        return out

    def sub(entry):
        node, i = entry
        s = rebuild(node)
        return s[i] if len(s) > 1 else s

    outs = [sub(entry) for entry in sym._entries]
    return S.Group(outs) if len(outs) > 1 else outs[0]


def _consumer_map(nodes):
    """id(node) -> list of (consumer_node, input_position)."""
    out = {}
    for node in nodes:
        if node.op is None:
            continue
        for pos, (src, _i) in enumerate(node.inputs):
            out.setdefault(id(src), []).append((node, pos))
    return out


def _entry_ids(sym):
    return {id(node) for (node, _i) in sym._entries}


def count_ops(sym, op_name):
    """Number of ``op_name`` nodes in the graph (test/debug helper)."""
    return sum(1 for n in sym._topo_nodes() if n.op == op_name)


def _is_plain_var(node):
    return node.op is None


# ---------------------------------------------------------------------------
# inference-mode BN folding
# ---------------------------------------------------------------------------

_FOLD_PRODUCERS = ("Convolution", "FullyConnected")


def _bn_fold_plan(sym):
    """Find BatchNorm nodes foldable into their producing conv/FC.

    Conditions: the BN's data input is output 0 of a Convolution/
    FullyConnected that (a) feeds only this BN, (b) is not itself a
    graph output, (c) has a plain-variable weight (and bias) consumed
    by no other node; the BN normalizes the channel axis the producer
    fills (axis 1), exposes only its first output, and its
    gamma/beta/moving inputs are plain variables.
    """
    nodes = sym._topo_nodes()
    consumers = _consumer_map(nodes)
    entries = _entry_ids(sym)
    plan = {}  # id(bn_node) -> producer node
    for bn in nodes:
        if bn.op != "BatchNorm" or pbool(bn.attrs.get("output_mean_var")):
            continue
        if pint(bn.attrs.get("axis"), 1) != 1:
            continue
        src, oi = bn.inputs[0]
        if oi != 0 or src.op not in _FOLD_PRODUCERS:
            continue
        if id(src) in entries or len(consumers.get(id(src), ())) != 1:
            continue
        # weight/bias vars must be exclusive to this producer
        w_ok = all(_is_plain_var(n) and
                   len(consumers.get(id(n), ())) == 1
                   for (n, _i) in src.inputs[1:])
        bn_ok = all(_is_plain_var(n) for (n, _i) in bn.inputs[1:])
        if w_ok and bn_ok:
            plan[id(bn)] = src
    return plan


def _np_of(params, name, fallback=None):
    arr = params.get(name)
    if arr is None and fallback is not None:
        arr = fallback.get(name)
    if arr is None:
        raise MXNetError("fold_batchnorm: parameter %r not provided" % name)
    return arr.asnumpy() if hasattr(arr, "asnumpy") else np.asarray(arr)


def fold_batchnorm(sym, arg_params, aux_params):
    """Fold inference-mode BatchNorm into adjacent conv/FC weights.

    Returns ``(fused_sym, fused_arg_params, fused_aux_params)``.  For
    every foldable ``producer -> BatchNorm`` pair the BN node vanishes
    and the producer's weight/bias values absorb the normalization:

        scale = gamma / sqrt(moving_var + eps)
        W'    = W * scale            (per output channel)
        b'    = (b - moving_mean) * scale + beta

    The rewritten graph computes the *inference* BN semantics exactly,
    so it must only be used for serving/eval (train-mode batch stats
    are gone by construction — that path is :func:`fuse_conv_bn_relu`).
    Producers keep their names and weight/bias parameter names; the
    folded BN's gamma/beta/moving_mean/moving_var entries are dropped
    from the returned param dicts.  A producer that had ``no_bias``
    gains a ``<name>_bias`` argument carrying the shift.
    """
    from ..ndarray.ndarray import array as nd_array

    plan = _bn_fold_plan(sym)
    new_args = dict(arg_params)
    new_aux = dict(aux_params)
    if not plan:
        return sym, new_args, new_aux

    existing_names = set(sym.list_arguments()) | \
        set(sym.list_auxiliary_states())

    def emit(node, ins, sub):
        if id(node) not in plan:
            return None
        producer = plan[id(node)]
        bn = node
        names = S._op_input_names(bn.op, len(bn.inputs))
        bn_vars = {nm: src.name for (src, _i), nm
                   in zip(bn.inputs, names) if src.op is None}
        eps = pfloat(bn.attrs.get("eps"), 1e-3)
        gamma = _np_of(new_args, bn_vars["gamma"], new_aux)
        beta = _np_of(new_args, bn_vars["beta"], new_aux)
        mean = _np_of(new_aux, bn_vars["moving_mean"], new_args)
        var = _np_of(new_aux, bn_vars["moving_var"], new_args)
        if pbool(bn.attrs.get("fix_gamma"), True):
            gamma = np.ones_like(gamma)
        scale = gamma / np.sqrt(var + eps)
        shift = beta - mean * scale

        w_name = producer.inputs[1][0].name
        w = _np_of(new_args, w_name)
        ctx = getattr(new_args[w_name], "context", None)
        w_scale_shape = (scale.shape[0],) + (1,) * (w.ndim - 1)
        new_args[w_name] = nd_array(
            (w * scale.reshape(w_scale_shape)).astype(w.dtype), ctx=ctx)

        attrs = dict(producer.attrs)
        if len(producer.inputs) > 2:  # existing bias
            b_name = producer.inputs[2][0].name
            b = _np_of(new_args, b_name)
        else:
            b_name = producer.name + "_bias"
            while b_name in existing_names:
                b_name += "_folded"
            b = np.zeros((scale.shape[0],), w.dtype)
            attrs.pop("no_bias", None)
        new_args[b_name] = nd_array((b * scale + shift).astype(w.dtype),
                                    ctx=ctx)
        # gamma/beta/moving_* entries are dropped by the live-name filter
        # below (not popped here: a var shared with another consumer must
        # survive)

        prod_ins = [sub(e) for e in producer.inputs[:2]]
        bias_sym = S.var(b_name) if len(producer.inputs) <= 2 \
            else sub(producer.inputs[2])
        attrs["no_bias"] = False
        return S._invoke_sym(producer.op, prod_ins + [bias_sym], attrs,
                             name=producer.name)

    fused = rewrite_graph(sym, emit)
    # drop param entries for vars no longer referenced by the graph
    live = set(fused.list_arguments()) | set(fused.list_auxiliary_states())
    new_args = {k: v for k, v in new_args.items() if k in live}
    new_aux = {k: v for k, v in new_aux.items() if k in live}
    return fused, new_args, new_aux


# ---------------------------------------------------------------------------
# training-mode conv+BN+ReLU fusion
# ---------------------------------------------------------------------------


def _cbr_plan(sym):
    """Match Convolution -> BatchNorm [-> Activation(relu)] chains.

    Returns ``{id(head_node): (conv, bn, has_act)}`` where head is the
    relu when present, else the BN.  Inner nodes must have exactly one
    consumer and not be graph outputs, so collapsing them is safe.
    """
    nodes = sym._topo_nodes()
    consumers = _consumer_map(nodes)
    entries = _entry_ids(sym)
    plan = {}
    for bn in nodes:
        if bn.op != "BatchNorm" or pbool(bn.attrs.get("output_mean_var")):
            continue
        if pint(bn.attrs.get("axis"), 1) != 1:
            continue
        src, oi = bn.inputs[0]
        if oi != 0 or src.op != "Convolution":
            continue
        if id(src) in entries or len(consumers.get(id(src), ())) != 1:
            continue
        if not all(_is_plain_var(n) for (n, _i) in bn.inputs[1:]):
            continue
        cons = consumers.get(id(bn), ())
        head, has_act = bn, False
        if id(bn) not in entries and len(cons) == 1:
            act, pos = cons[0]
            if act.op == "Activation" and pos == 0 and \
                    act.attrs.get("act_type", "relu") == "relu":
                head, has_act = act, True
        plan[id(head)] = (src, bn, has_act)
    return plan


def _cbr_tag(conv):
    """Cost-key discriminator for the conv geometry: the input shape
    alone would let one measured entry gate every conv config that
    happens to share it (a 1x1 stride-2 projection vs the measured 3x3
    stride-1 conv)."""
    from ..ops.utils import ptuple

    kernel = ptuple(conv.attrs.get("kernel"))
    nd = len(kernel)
    parts = ["k" + "x".join(str(d) for d in kernel)]
    for tag, attr in (("s", "stride"), ("d", "dilate"), ("p", "pad")):
        dflt = (1,) * nd if tag in ("s", "d") else (0,) * nd
        v = ptuple(conv.attrs.get(attr), ndim=nd, default=dflt)
        if tuple(v) != dflt:
            parts.append(tag + "x".join(str(d) for d in v))
    parts.append("f%d" % pint(conv.attrs.get("num_filter"), 0))
    g = pint(conv.attrs.get("num_group"), 1)
    if g != 1:
        parts.append("g%d" % g)
    return ".".join(parts)


def _cbr_sites(sym):
    return {hid: {"conv": conv, "bn": bn, "has_act": has_act,
                  "data": conv.inputs[0], "tag": _cbr_tag(conv)}
            for hid, (conv, bn, has_act) in _cbr_plan(sym).items()}


def _cbr_emit(node, ins, sub, site):
    conv, bn, has_act = site["conv"], site["bn"], site["has_act"]
    data_s = sub(conv.inputs[0])
    weight_s = sub(conv.inputs[1])
    bias = [sub(conv.inputs[2])] if len(conv.inputs) > 2 else []
    bn_ins = [sub(e) for e in bn.inputs[1:]]  # gamma..moving_var
    attrs = {k: v for k, v in conv.attrs.items()
             if k not in ("no_bias",)}
    attrs["no_bias"] = not bias
    for k in ("eps", "momentum", "fix_gamma", "use_global_stats"):
        if k in bn.attrs:
            attrs[k] = bn.attrs[k]
    attrs["act_type"] = "relu" if has_act else ""
    return S._invoke_sym(
        "_contrib_conv_bn_relu",
        [data_s, weight_s] + bn_ins + bias, attrs,
        name=conv.name + "_bn_act")


def fuse_conv_bn_relu(sym):
    """Collapse conv->BN[->relu] chains into ``_contrib_conv_bn_relu``.

    The fused op keeps BatchNorm's train/eval semantics (batch stats +
    moving-average updates in train mode, moving stats in eval) and its
    backward recomputes the normalized activation (a checkpoint inside
    the op) instead of keeping it from the forward.  All
    parameter and aux names are preserved: the fused node consumes the
    very same variable nodes, so existing ``arg_params``/``aux_params``
    bind unchanged.
    """
    fused, _fired = apply_fusion(sym, "conv_bn_relu")
    return fused


# ---------------------------------------------------------------------------
# pattern registry
# ---------------------------------------------------------------------------

# activations every fused elementwise kernel supports with math
# identical to the standalone op/Activation node
_FUSABLE_ACTS = ("relu", "sigmoid", "tanh", "softrelu", "softsign")
_UNARY_ACTS = ("relu", "sigmoid", "tanh", "softsign")
_ADD_OPS = ("elemwise_add", "broadcast_add")
_MUL_OPS = ("elemwise_mul", "broadcast_mul")


class FusionPattern:
    """One registered rewrite.

    ``plan(sym)`` returns ``{id(head_node): site}`` where ``site`` is a
    dict with at least ``"data"`` — the original ``(node, out_index)``
    entry whose output shape keys the cost table (optionally
    ``"axis"``).  ``emit(head, ins, sub, site)`` builds the fused
    replacement (rewrite_graph contract).  ``default_on`` marks
    identical-math refactors that are safe without a cost table;
    numerics-bearing kernels stay off until measured faster.
    ``bench_builder(shape)`` returns ``(chain_sym, {input: shape})`` —
    the canonical micro-benchmark/parity chain for the pattern, which
    :func:`microbench` and the parity tests share.
    """

    __slots__ = ("name", "plan", "emit", "default_on", "doc",
                 "bench_builder", "bench_shapes")

    def __init__(self, name, plan, emit, default_on=False, doc="",
                 bench_builder=None, bench_shapes=()):
        self.name = name
        self.plan = plan
        self.emit = emit
        self.default_on = default_on
        self.doc = doc
        self.bench_builder = bench_builder
        self.bench_shapes = tuple(bench_shapes)

    def site_key(self, site, structs):
        """Cost-table key for a matched site, or None when the shape is
        unknown (decision then falls back to ``default_on``)."""
        if structs is None:
            return None
        node, oi = site["data"]
        outs = structs.get(id(node))
        if not outs or oi >= len(outs) or outs[oi] is None:
            return None
        from .. import fusion_cost as _fc

        st = outs[oi]
        return _fc.shape_key(self.name, st.shape, st.dtype,
                             axis=site.get("axis"),
                             extra=site.get("tag"))


_PATTERNS = {}  # insertion-ordered: passes run in registration order


def register_pattern(pattern):
    if pattern.name in _PATTERNS:
        raise MXNetError("fusion pattern %r already registered"
                         % pattern.name)
    _PATTERNS[pattern.name] = pattern
    return pattern


def get_pattern(name):
    try:
        return _PATTERNS[name]
    except KeyError:
        raise MXNetError("unknown fusion pattern %r (registered: %s)"
                         % (name, sorted(_PATTERNS)))


def list_patterns():
    return list(_PATTERNS)


# ---------------------------------------------------------------------------
# per-node shape inference (cost-table gating)
# ---------------------------------------------------------------------------


def _node_structs(sym, known):
    """``{id(node): [meta tensor] | None}`` by abstract evaluation
    (``symbol._abstract_eval``: meta tensors, shapes and dtypes only).

    ``known`` maps variable names to ``(shape, dtype)``.  A node whose
    inputs (or whose own evaluation) cannot be resolved gets None, and
    its decision falls back to the pattern's default: shape gating never
    makes a bind fail."""
    from ..base import torch_dtype

    out = {}
    for node in sym._topo_nodes():
        if node.op is None:
            sd = known.get(node.name)
            out[id(node)] = None if sd is None else [
                S._meta(tuple(sd[0]), torch_dtype(sd[1]))]
            continue
        in_structs = []
        for (inp, i) in node.inputs:
            s = out.get(id(inp))
            if not s or i >= len(s) or s[i] is None:
                in_structs = None
                break
            in_structs.append(s[i])
        if in_structs is None:
            out[id(node)] = None
            continue
        try:
            out[id(node)] = S._abstract_eval(get_op(node.op), node.attrs,
                                             in_structs)
        except Exception:
            out[id(node)] = None
    return out


# ---------------------------------------------------------------------------
# the rewrite loop over the registry
# ---------------------------------------------------------------------------


def apply_fusion(sym, fusion=None, known=None):
    """Run the pattern registry over ``sym`` under a fusion plan.

    ``fusion`` is anything :func:`fusion_cost.resolve_fusion` accepts (None defers to ``MXNET_FUSION``); ``known`` maps bound
    variable names to ``(shape, dtype)`` so cost-table decisions can be
    made per concrete site shape.  Returns ``(fused_sym, fired)`` where
    ``fired`` is a list of ``(pattern, site_name, key)`` — empty when
    the plan is off or nothing matched.  Each fired rewrite goes to
    ``fusion_cost.note_fired``."""
    from .. import fusion_cost as _fc

    plan = _fc.resolve_fusion(fusion)
    if plan is None:
        return sym, []
    fired = []
    structs = None  # per-graph cache: recompute only after a rewrite
    for pattern in _PATTERNS.values():
        if not plan.wants(pattern.name):
            continue
        if not plan.force and plan.table is None and \
                not pattern.default_on:
            continue  # nothing could fire: skip the matcher entirely
        sites = pattern.plan(sym)
        if not sites:
            continue
        if structs is None and plan.needs_shapes() and known:
            structs = _node_structs(sym, known)
        decisions = {}
        any_fire = False
        for hid, site in sites.items():
            key = pattern.site_key(site, structs)
            ok = plan.decide(pattern.name, pattern.default_on, key)
            decisions[hid] = (ok, key)
            any_fire = any_fire or ok
        if not any_fire:
            continue

        def emit(node, ins, sub, _p=pattern, _sites=sites,
                 _dec=decisions):
            d = _dec.get(id(node))
            if d is None or not d[0]:
                return None
            out = _p.emit(node, ins, sub, _sites[id(node)])
            if out is not None:
                fired.append((_p.name, node.name, d[1]))
            return out

        sym = rewrite_graph(sym, emit)
        structs = None  # graph changed: stale node ids
    for name, site_name, key in fired:
        _fc.note_fired(name, site_name, key)
    return sym, fired


# ---------------------------------------------------------------------------
# registered patterns
# ---------------------------------------------------------------------------


def _head_act(node):
    """act_type for an Activation/unary-activation head, else None."""
    if node.op == "Activation":
        act = node.attrs.get("act_type", "relu") or "relu"
        return act if act in _FUSABLE_ACTS else None
    if node.op in _UNARY_ACTS:
        return node.op
    return None


def _fusable_inner(node, entry, ops, consumers, entries):
    """The producer behind ``entry`` if it is an ``ops`` node safe to
    collapse (single consumer, not a graph output, first output)."""
    src, oi = entry
    if oi != 0 or src.op not in ops:
        return None
    if id(src) in entries or len(consumers.get(id(src), ())) != 1:
        return None
    return src


def _norm_act_sites(sym):
    """BatchNorm -> activation chains the conv fusion cannot reach."""
    nodes = sym._topo_nodes()
    consumers = _consumer_map(nodes)
    entries = _entry_ids(sym)
    sites = {}
    for head in nodes:
        act = _head_act(head)
        if act is None or not head.inputs:
            continue
        bn = _fusable_inner(head, head.inputs[0], ("BatchNorm",),
                            consumers, entries)
        if bn is None or pbool(bn.attrs.get("output_mean_var")):
            continue
        if not all(_is_plain_var(n) for (n, _i) in bn.inputs[1:]):
            continue
        sites[id(head)] = {"bn": bn, "act": act, "data": bn.inputs[0]}
    return sites


def _norm_act_emit(node, ins, sub, site):
    bn = site["bn"]
    attrs = dict(bn.attrs)
    attrs["act_type"] = site["act"]
    return S._invoke_sym("_contrib_norm_act",
                         [sub(e) for e in bn.inputs], attrs,
                         name=node.name)


def _add_act_sites(sym):
    """(elemwise|broadcast)_add -> activation (bias add / residual
    join)."""
    nodes = sym._topo_nodes()
    consumers = _consumer_map(nodes)
    entries = _entry_ids(sym)
    sites = {}
    for head in nodes:
        act = _head_act(head)
        if act is None or not head.inputs:
            continue
        add = _fusable_inner(head, head.inputs[0], _ADD_OPS,
                             consumers, entries)
        if add is None:
            continue
        sites[id(head)] = {"add": add, "act": act, "data": add.inputs[0]}
    return sites


def _add_act_emit(node, ins, sub, site):
    add = site["add"]
    return S._invoke_sym("_contrib_add_act",
                         [sub(add.inputs[0]), sub(add.inputs[1])],
                         {"act_type": site["act"]}, name=node.name)


def _act_scale_add_sites(sym):
    """activation -> scale (tensor or scalar) -> add/residual-add."""
    nodes = sym._topo_nodes()
    consumers = _consumer_map(nodes)
    entries = _entry_ids(sym)
    sites = {}
    for head in nodes:
        if head.op not in _ADD_OPS:
            continue
        for add_pos in (0, 1):
            mul = _fusable_inner(head, head.inputs[add_pos],
                                 _MUL_OPS + ("_mul_scalar",),
                                 consumers, entries)
            if mul is None:
                continue
            act_node = None
            mul_pos = 0
            for p in range(len(mul.inputs)):
                cand = _fusable_inner(
                    mul, mul.inputs[p],
                    ("Activation",) + _UNARY_ACTS, consumers, entries)
                if cand is not None and _head_act(cand) is not None:
                    act_node, mul_pos = cand, p
                    break
            if act_node is None:
                continue
            sites[id(head)] = {
                "mul": mul, "act_node": act_node,
                "act": _head_act(act_node), "add_pos": add_pos,
                "mul_pos": mul_pos, "data": act_node.inputs[0]}
            break
    return sites


def _act_scale_add_emit(node, ins, sub, site):
    mul, act_node = site["mul"], site["act_node"]
    data_s = sub(act_node.inputs[0])
    add_other = sub(node.inputs[1 - site["add_pos"]])
    attrs = {"act_type": site["act"]}
    if mul.op == "_mul_scalar":
        attrs["scalar"] = mul.attrs.get("scalar", 1.0)
        inputs = [data_s, add_other]
    else:
        inputs = [data_s, sub(mul.inputs[1 - site["mul_pos"]]),
                  add_other]
    return S._invoke_sym("_contrib_act_scale_add", inputs, attrs,
                         name=node.name)


def _layer_norm_sites(sym):
    sites = {}
    for node in sym._topo_nodes():
        if node.op != "LayerNorm" or \
                pbool(node.attrs.get("output_mean_var")):
            continue
        sites[id(node)] = {"ln": node, "data": node.inputs[0],
                           "axis": pint(node.attrs.get("axis"), -1)}
    return sites


def _layer_norm_emit(node, ins, sub, site):
    return S._invoke_sym("_contrib_layer_norm_fused", ins,
                         dict(node.attrs), name=node.name)


# -- canonical micro-benchmark / parity chains ------------------------------


def _bb_conv_bn_relu(shape):
    data = S.var("data")
    c = S._invoke_sym("Convolution", [data],
                      {"kernel": (3, 3), "num_filter": max(shape[1], 4),
                       "pad": (1, 1), "no_bias": True}, name="conv0")
    b = S._invoke_sym("BatchNorm", [c], {"fix_gamma": False}, name="bn0")
    r = S._invoke_sym("Activation", [b], {"act_type": "relu"},
                      name="relu0")
    return r, {"data": shape}


def _bb_norm_act(shape):
    data = S.var("data")
    b = S._invoke_sym("BatchNorm", [data], {"fix_gamma": False},
                      name="bn0")
    r = S._invoke_sym("Activation", [b], {"act_type": "relu"},
                      name="relu0")
    return r, {"data": shape}


def _bb_add_act(shape):
    a, b = S.var("data"), S.var("residual")
    s = S._invoke_sym("broadcast_add", [a, b], {}, name="add0")
    r = S._invoke_sym("Activation", [s], {"act_type": "relu"},
                      name="relu0")
    return r, {"data": shape, "residual": shape}


def _bb_act_scale_add(shape):
    a, res = S.var("data"), S.var("residual")
    g = S.var("scale")
    y = S._invoke_sym("Activation", [a], {"act_type": "relu"},
                      name="act0")
    y = S._invoke_sym("broadcast_mul", [y, g], {}, name="mul0")
    y = S._invoke_sym("broadcast_add", [y, res], {}, name="add0")
    return y, {"data": shape, "residual": shape,
               "scale": (shape[-1],)}


def _bb_layer_norm(shape):
    data = S.var("data")
    y = S._invoke_sym("LayerNorm", [data], {"axis": -1}, name="ln0")
    return y, {"data": shape}


register_pattern(FusionPattern(
    "conv_bn_relu", _cbr_sites, _cbr_emit, default_on=False,
    doc="Convolution -> BatchNorm [-> relu] into _contrib_conv_bn_relu "
        "(VJP recomputes the normalized activation)",
    bench_builder=_bb_conv_bn_relu,
    bench_shapes=((8, 16, 28, 28), (4, 32, 56, 56))))

register_pattern(FusionPattern(
    "norm_act", _norm_act_sites, _norm_act_emit, default_on=False,
    doc="BatchNorm -> activation into _contrib_norm_act (checkpointed "
        "normalize+activate tail; covers BN sites behind shared conv "
        "outputs)",
    bench_builder=_bb_norm_act,
    bench_shapes=((8, 32, 28, 28), (16, 64, 14, 14))))

register_pattern(FusionPattern(
    "act_scale_add", _act_scale_add_sites, _act_scale_add_emit,
    default_on=True,
    doc="activation -> scale -> add/residual-add chain into "
        "_contrib_act_scale_add (identical math, one node)",
    bench_builder=_bb_act_scale_add,
    bench_shapes=((256, 1024), (64, 4096))))

register_pattern(FusionPattern(
    "add_act", _add_act_sites, _add_act_emit, default_on=True,
    doc="add -> activation (bias+act / residual join) into "
        "_contrib_add_act (identical math, one node)",
    bench_builder=_bb_add_act,
    bench_shapes=((256, 1024), (64, 4096))))

register_pattern(FusionPattern(
    "layer_norm_fast", _layer_norm_sites, _layer_norm_emit,
    default_on=False,
    doc="LayerNorm into _contrib_layer_norm_fused (one-pass E[x^2] "
        "statistics, fp32 accumulation; the attention-path "
        "normalization)",
    bench_builder=_bb_layer_norm,
    bench_shapes=((64, 1024), (256, 4096), (32, 128, 512))))


# ---------------------------------------------------------------------------
# per-shape micro-benchmark
# ---------------------------------------------------------------------------


def microbench(pattern_name, shape, iters=20, warmup=3, grad=True,
               rng=None, repeats=5, dtype="float32", ctx=None):
    """Time one pattern's canonical chain fused against unfused at
    ``shape`` on ``ctx`` (default: the current context).

    Binds two executors on the same values, the stock graph and the
    graph with only ``pattern_name`` applied, and times forward
    (prediction) and forward+backward (training) blocks: ``repeats``
    blocks of at least ``iters`` calls, fused and unfused interleaved,
    each side scored by its fastest block; on the card a block is timed
    with CUDA events.  Returns ``{fused,unfused}_{fwd,train}_ms``,
    ``speedup`` (training: the cost table's basis), ``speedup_infer``,
    ``fired`` (False: the matcher found no site) and ``key``, the site's
    cost-table key."""
    import time

    from ..base import torch_dtype
    from ..context import current_context
    from ..ndarray.ndarray import array as nd_array

    pattern = get_pattern(pattern_name)
    if pattern.bench_builder is None:
        raise MXNetError("pattern %r has no bench_builder" % pattern_name)
    ctx = ctx or current_context()
    device = ctx.torch_device
    rng = rng or np.random.RandomState(0)
    dt = torch_dtype(dtype)
    chain, feeds = pattern.bench_builder(tuple(shape))
    loss = S._invoke_sym("sum", [chain], {}, name="loss")
    fused_sym, fired = apply_fusion(loss, pattern_name)

    vals = {n: rng.rand(*s).astype(np.float32) + 0.5
            for n, s in feeds.items()}

    def bind(sym_):
        exe = sym_.simple_bind(ctx=ctx, fusion="off",
                               grad_req="write" if grad else "null",
                               **feeds)
        for d in (exe.arg_dict, exe.aux_dict):
            for n, a in d.items():
                v = vals.setdefault(
                    n, rng.rand(*a.shape).astype(np.float32) + 0.5)
                a._rebind(nd_array(v, ctx=ctx)._data.to(dt))
        return exe

    def timed(fn, n):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    def fwd_block(exe, n):
        return timed(lambda: exe.forward(is_train=False), n)

    def train_block(exe, n):
        def step():
            exe.forward(is_train=True)
            exe.backward()
        return timed(step, n)

    def measure(block, exes, target_block_ms=40.0):
        # warm both up (compile, caches), size a block to span at least
        # target_block_ms, then interleave the blocks
        for exe in exes:
            for _ in range(max(1, warmup)):
                block(exe, 1)
        t1 = max(min(block(exe, 1) for exe in exes), 1e-3)
        n = max(iters, int(target_block_ms / t1) + 1)
        best = [float("inf")] * len(exes)
        for _ in range(max(1, repeats)):
            for i, exe in enumerate(exes):
                best[i] = min(best[i], block(exe, n))
        return best

    out = {"pattern": pattern_name, "shape": list(shape),
           "fired": bool(fired)}
    exe_u, exe_f = bind(loss), bind(fused_sym)
    out["unfused_fwd_ms"], out["fused_fwd_ms"] = measure(
        fwd_block, (exe_u, exe_f))
    if grad:
        out["unfused_train_ms"], out["fused_train_ms"] = measure(
            train_block, (exe_u, exe_f))
        out["speedup"] = out["unfused_train_ms"] / max(
            out["fused_train_ms"], 1e-9)
    else:
        out["speedup"] = out["unfused_fwd_ms"] / max(
            out["fused_fwd_ms"], 1e-9)
    out["speedup_infer"] = out["unfused_fwd_ms"] / max(
        out["fused_fwd_ms"], 1e-9)
    # the key comes from the bind-time gate's own site_key, so a table
    # entry made from it is found at bind
    sites = pattern.plan(loss)
    known = {n: (s, dtype) for n, s in feeds.items()}
    structs = _node_structs(loss, known)
    keys = {pattern.site_key(s, structs) for s in sites.values()}
    keys.discard(None)
    out["key"] = sorted(keys)[0] if keys else None
    return out
