"""Symbol: the declarative graph front end (parity:
mxnet_tpu/symbol/symbol.py; python/mxnet/symbol/symbol.py:54 — compose,
infer_shape, bind, JSON).

A Symbol is a small DAG of registry-op nodes.  ``_build_fn`` turns it
into one Python function over a dict of named tensors that calls each
op's torch function in topological order and returns
``(outputs, aux_updates)``; the ``Executor`` runs that function through
the port's compiled path (``jit``), as the JAX package runs it through
``jax.jit``.  Shape inference runs each op on ``torch.device("meta")``
tensors, the counterpart of ``jax.eval_shape``: shapes and dtypes
propagate and no data is touched.  An op that cannot run on meta tensors
(one that reads a value on the host) runs instead on zero CPU tensors of
those shapes.  Weights left unknown are deduced from the data shapes by
``_deduce_param_shape``'s rules, as in the JAX package.

The JSON is the JAX package's schema, its ``mxnet_version`` and ``mxtpu``
attributes included: a file either package writes loads in the other.
"""
from __future__ import annotations

import json

import numpy as np

import torch

from ..base import MXNetError
from ..name import NameManager
from ..attribute import AttrScope
from ..ops.registry import get_op, clean_attrs
from ..ops.utils import ptuple, pint, pbool

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "zeros", "ones", "_invoke_sym"]


class _Node:
    __slots__ = ("op", "attrs", "inputs", "name", "user_attrs")

    def __init__(self, op, attrs, inputs, name, user_attrs=None):
        self.op = op  # op name string; None for variables
        self.attrs = attrs
        self.inputs = inputs  # list of (node, out_index)
        self.name = name
        self.user_attrs = user_attrs or {}

    @property
    def num_outputs(self):
        if self.op is None:
            return 1
        return get_op(self.op).n_outputs(self.attrs)


# ops whose trailing inputs are auxiliary states (not learned arguments)
AUX_INPUTS = {
    "BatchNorm": ("moving_mean", "moving_var"),
    "SyncBatchNorm": ("moving_mean", "moving_var"),
    "_contrib_conv_bn_relu": ("moving_mean", "moving_var"),
    "_contrib_norm_act": ("moving_mean", "moving_var"),
}

# ops that return (out, batch_mean, batch_var) and whose bound moving
# stats receive the momentum update in train mode (_build_fn)
_MOVING_STAT_OPS = ("BatchNorm", "SyncBatchNorm", "_contrib_conv_bn_relu",
                    "_contrib_norm_act")

# canonical input names per op for auto-created variables
_INPUT_NAMES = {
    "FullyConnected": ("data", "weight", "bias"),
    "Convolution": ("data", "weight", "bias"),
    "Deconvolution": ("data", "weight", "bias"),
    "BatchNorm": ("data", "gamma", "beta", "moving_mean", "moving_var"),
    # conv bias LAST so the aux positions are bias-independent
    "_contrib_conv_bn_relu": ("data", "weight", "gamma", "beta",
                              "moving_mean", "moving_var", "bias"),
    "_contrib_norm_act": ("data", "gamma", "beta", "moving_mean",
                          "moving_var"),
    "LayerNorm": ("data", "gamma", "beta"),
    "_contrib_layer_norm_fused": ("data", "gamma", "beta"),
    "InstanceNorm": ("data", "gamma", "beta"),
    "Embedding": ("data", "weight"),
    "LeakyReLU": ("data", "gamma"),
    "RNN": ("data", "parameters", "state", "state_cell"),
    "SoftmaxOutput": ("data", "label"),
    "LinearRegressionOutput": ("data", "label"),
    "LogisticRegressionOutput": ("data", "label"),
    "MAERegressionOutput": ("data", "label"),
    "softmax_cross_entropy": ("data", "label"),
    "CTCLoss": ("data", "label"),
    "dot": ("lhs", "rhs"),
    "batch_dot": ("lhs", "rhs"),
}


def _op_input_names(op_name, n):
    names = _INPUT_NAMES.get(op_name)
    if names:
        return names[:n] if n <= len(names) else names + tuple(
            "arg%d" % i for i in range(len(names), n))
    if n == 1:
        return ("data",)
    if n == 2:
        return ("lhs", "rhs")
    return tuple("arg%d" % i for i in range(n))


class Symbol:
    """A handle to one or more outputs of a graph node."""

    __slots__ = ("_entries",)

    def __init__(self, entries):
        self._entries = entries  # list of (node, out_index)

    # -- composition ----------------------------------------------------
    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def __iter__(self):
        return (Symbol([e]) for e in self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._entries[index])
        return Symbol([self._entries[index]])

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "group")

    # -- arithmetic sugar ------------------------------------------------
    def _bin(self, other, op, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _invoke_sym(op, [a, b], {})
        return _invoke_sym(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, o):
        return self._bin(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._bin(o, "broadcast_sub", "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._bin(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._bin(o, "broadcast_div", "_rdiv_scalar", reverse=True)

    __div__ = __truediv__

    def __pow__(self, o):
        return self._bin(o, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return _invoke_sym("negative", [self], {})

    def __eq__(self, o):
        return self._bin(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        return self._bin(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._bin(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._bin(o, "broadcast_greater_equal", "_greater_equal_scalar")

    def __lt__(self, o):
        return self._bin(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._bin(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # method sugar matching NDArray
    def reshape(self, *shape, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if kw.get("shape"):
            shape = kw["shape"]
        return _invoke_sym("Reshape", [self], {"shape": shape})

    def astype(self, dtype):
        return _invoke_sym("Cast", [self], {"dtype": dtype})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _invoke_sym("transpose", [self], {"axes": axes or None})

    def sum(self, axis=None, keepdims=False):
        return _invoke_sym("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _invoke_sym("mean", [self], {"axis": axis, "keepdims": keepdims})

    def flatten(self):
        return _invoke_sym("Flatten", [self], {})

    def slice_axis(self, axis, begin, end):
        return _invoke_sym("slice_axis", [self], {"axis": axis, "begin": begin,
                                                  "end": end})

    def expand_dims(self, axis):
        return _invoke_sym("expand_dims", [self], {"axis": axis})

    def softmax(self, axis=-1):
        return _invoke_sym("softmax", [self], {"axis": axis})

    # -- graph traversal -------------------------------------------------
    def _topo_nodes(self):
        seen = {}
        order = []

        def visit(node):
            if id(node) in seen:
                return
            seen[id(node)] = node
            for (n, _) in node.inputs:
                visit(n)
            order.append(node)

        for (n, _) in self._entries:
            visit(n)
        return order

    def _arg_nodes(self, with_aux=False):
        args, auxs = [], []
        aux_names = set()
        for node in self._topo_nodes():
            if node.op in AUX_INPUTS:
                names = _op_input_names(node.op, len(node.inputs))
                aux_set = set(AUX_INPUTS[node.op])
                for (inp, _), nm in zip(node.inputs, names):
                    if inp.op is None and nm in aux_set:
                        aux_names.add(inp.name)
        for node in self._topo_nodes():
            if node.op is None:
                (auxs if node.name in aux_names else args).append(node)
        return (args, auxs) if with_aux else args

    def list_arguments(self):
        return [n.name for n in self._arg_nodes()]

    def list_auxiliary_states(self):
        return [n.name for n in self._arg_nodes(with_aux=True)[1]]

    def list_outputs(self):
        out = []
        for (node, idx) in self._entries:
            if node.op is None:
                n_vis = 1
            else:
                n_vis = get_op(node.op).n_visible_outputs(node.attrs)
            if n_vis > 1:
                out.append("%s_output%d" % (node.name, idx))
            else:
                out.append("%s_output" % node.name)
        return out

    def list_inputs(self):
        a, x = self._arg_nodes(with_aux=True)
        return [n.name for n in a] + [n.name for n in x]

    def get_internals(self):
        entries = []
        for node in self._topo_nodes():
            for i in range(node.num_outputs):
                entries.append((node, i))
        return Symbol(entries)

    def get_children(self):
        nodes = {id(n): n for (n, _) in self._entries}
        ins = []
        for n in nodes.values():
            ins.extend(n.inputs)
        if not ins:
            return None
        return Symbol(ins)

    def attr(self, key):
        if len(self._entries) == 1:
            node = self._entries[0][0]
            if key == "name":
                return node.name
            return node.user_attrs.get(key)
        return None

    def attr_dict(self):
        out = {}
        for node in self._topo_nodes():
            d = dict(node.user_attrs)
            if node.op is not None:
                d.update({k: str(v) for k, v in node.attrs.items()})
            if d:
                out[node.name] = d
        return out

    def _set_attr(self, **kwargs):
        for (node, _) in self._entries:
            node.user_attrs.update(kwargs)

    def get_backend_symbol(self, backend):
        return self  # no graph partitioning in this port

    # -- evaluation ------------------------------------------------------
    def _build_fn(self):
        """Build fn(arg_dict) -> (list outputs, dict aux_updates)."""
        nodes = self._topo_nodes()
        arg_nodes, aux_nodes = self._arg_nodes(with_aux=True)
        aux_set = {n.name for n in aux_nodes}

        def fn(value_map, is_train=False, device=None):
            # value_map: name -> tensor for every variable node; an op
            # without inputs makes its tensor on ``device``
            results = {}  # id(node) -> tuple of outputs
            aux_updates = {}
            for node in nodes:
                if node.op is None:
                    results[id(node)] = (value_map[node.name],)
                    continue
                ins = [results[id(n)][i] for (n, i) in node.inputs]
                info = get_op(node.op)
                attrs = node.attrs
                if info.num_inputs == 0:
                    attrs = dict(attrs, ctx=device)
                out = info.fn(*ins, **attrs)
                out = out if isinstance(out, tuple) else (out,)
                results[id(node)] = out
                if node.op in _MOVING_STAT_OPS and is_train \
                        and not pbool(node.attrs.get("use_global_stats")):
                    names = _op_input_names(node.op, len(node.inputs))
                    mom = float(node.attrs.get("momentum", 0.9))
                    for aux_i, nm in enumerate(("moving_mean", "moving_var")):
                        pos = names.index(nm)
                        inp_node, _ = node.inputs[pos]
                        if inp_node.op is None and inp_node.name in aux_set:
                            old = value_map[inp_node.name]
                            new = out[1 + aux_i].detach()
                            aux_updates[inp_node.name] = \
                                mom * old + (1 - mom) * new
            outs = [results[id(n)][i] for (n, i) in self._entries]
            return outs, aux_updates

        return fn, [n.name for n in arg_nodes], [n.name for n in aux_nodes]

    def eval(self, ctx=None, **kwargs):
        """Outputs for the given arguments (NDArrays), in inference mode
        and without grad."""
        from ..context import current_context
        from ..ndarray.ndarray import NDArray

        device = (ctx or current_context()).torch_device
        fn, arg_names, aux_names = self._build_fn()
        vmap = {k: v._data if isinstance(v, NDArray)
                else torch.as_tensor(v, device=device)
                for k, v in kwargs.items()}
        with torch.no_grad():
            outs, _ = fn(vmap, device=device)
        return [NDArray(o) for o in outs]

    # -- inference -------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        try:
            return self._infer_shape_impl(False, *args, **kwargs)
        except MXNetError:
            raise

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        known = {}
        if args:
            for name, shp in zip(self.list_arguments(), args):
                if shp is not None:
                    known[name] = tuple(shp)
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})

        nodes = self._topo_nodes()
        arg_nodes, aux_nodes = self._arg_nodes(with_aux=True)
        shapes = dict(known)  # name -> shape for vars
        node_out_shapes = {}  # id(node) -> [meta tensor]

        for node in nodes:
            if node.op is None:
                if node.name in shapes:
                    node_out_shapes[id(node)] = [_meta(shapes[node.name])]
                else:
                    node_out_shapes[id(node)] = None
                continue
            in_structs = []
            names = _op_input_names(node.op, len(node.inputs))
            # try parameter-shape deduction for unknown var inputs
            for pos, ((inp, i), nm) in enumerate(zip(node.inputs, names)):
                if inp.op is None and inp.name not in shapes:
                    ded = _deduce_param_shape(node, pos, nm, node_out_shapes,
                                              shapes)
                    if ded is not None:
                        shapes[inp.name] = ded
                        node_out_shapes[id(inp)] = [_meta(ded)]
            ok = True
            for (inp, i) in node.inputs:
                s = node_out_shapes.get(id(inp))
                if s is None:
                    ok = False
                    break
                in_structs.append(s[i])
            if not ok:
                node_out_shapes[id(node)] = None
                continue
            try:
                out_structs = _abstract_eval(get_op(node.op), node.attrs,
                                             in_structs)
            except Exception as e:
                if partial:
                    node_out_shapes[id(node)] = None
                    continue
                raise MXNetError("infer_shape failed at node %s(%s): %s"
                                 % (node.op, node.name, e)) from e
            node_out_shapes[id(node)] = list(out_structs)

        def shape_of(node):
            s = node_out_shapes.get(id(node))
            return None if s is None else tuple(s[0].shape)

        arg_shapes = [shapes.get(n.name) for n in arg_nodes]
        aux_shapes = [shapes.get(n.name) for n in aux_nodes]
        out_shapes = []
        for (node, i) in self._entries:
            s = node_out_shapes.get(id(node))
            out_shapes.append(None if s is None else tuple(s[i].shape))
        if not partial and any(s is None for s in arg_shapes + out_shapes):
            missing = [n.name for n, s in zip(arg_nodes, arg_shapes) if s is None]
            raise MXNetError("infer_shape incomplete; unknown: %s" % missing)
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        args_l = self.list_arguments()
        dt = [np.float32] * len(args_l)
        if args:
            dt = [np.dtype(a).type if a is not None else np.float32
                  for a in args]
        for k, v in kwargs.items():
            if k in args_l:
                dt[args_l.index(k)] = np.dtype(v).type
        out_t = [np.float32] * len(self._entries)
        aux_t = [np.float32] * len(self.list_auxiliary_states())
        return dt, out_t, aux_t

    # -- binding ---------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, remat_policy=None,
                    fusion=None, aot=None, dtype_policy=None, **kwargs):
        """Allocate zero arguments, gradients and aux states of the
        inferred shapes on ``ctx`` and bind them."""
        from ..executor import Executor
        from ..ndarray.ndarray import zeros as nd_zeros
        from ..context import current_context

        ctx = ctx or current_context()
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        args = {}
        for name, shp in zip(arg_names, arg_shapes):
            dtype = (type_dict or {}).get(name, "float32")
            args[name] = nd_zeros(shp, ctx=ctx, dtype=dtype)
        args_grad = {}
        req = grad_req
        for name in arg_names:
            r = req.get(name, "null") if isinstance(req, dict) else req
            if r != "null":
                args_grad[name] = nd_zeros(args[name].shape, ctx=ctx)
        aux = {n: nd_zeros(s, ctx=ctx)
               for n, s in zip(self.list_auxiliary_states(), aux_shapes)}
        return Executor(self, ctx, args, args_grad, grad_req, aux,
                        shared_exec=shared_exec, remat_policy=remat_policy,
                        fusion=fusion, aot=aot, dtype_policy=dtype_policy)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None,
             remat_policy=None, fusion=None, aot=None, dtype_policy=None):
        from ..executor import Executor

        arg_names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        aux_names = self.list_auxiliary_states()
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        return Executor(self, ctx, args or {}, args_grad or {}, grad_req,
                        aux_states or {}, shared_exec=shared_exec,
                        remat_policy=remat_policy, fusion=fusion, aot=aot,
                        dtype_policy=dtype_policy)

    # gradient: a symbolic gradient graph; the executor's backward is
    # torch autograd instead
    def gradient(self, wrt):  # pragma: no cover
        raise NotImplementedError("use executor.backward (torch autograd)")

    # -- serialization ---------------------------------------------------
    def tojson(self):
        nodes = self._topo_nodes()
        idx = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": n.op or "null",
                "name": n.name,
                "attrs": {k: str(v) for k, v in (n.attrs or {}).items()},
                "inputs": [[idx[id(src)], oi, 0] for (src, oi) in n.inputs],
            })
        heads = [[idx[id(n)], oi, 0] for (n, oi) in self._entries]
        arg_nodes = [i for i, n in enumerate(nodes) if n.op is None]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(nodes) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10500],
                                     "mxtpu": ["int", 1]}}, indent=2)

    def save(self, fname):
        from ..checkpoint import atomic_write

        atomic_write(fname, self.tojson().encode())

    def __deepcopy__(self, memo):
        return load_json(self.tojson())


def _parse_attr_value(v):
    """Best-effort de-stringification for round-tripped attrs."""
    if not isinstance(v, str):
        return v
    try:
        import ast

        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def load_json(json_str):
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        op = jn["op"]
        attrs = {k: _parse_attr_value(v)
                 for k, v in (jn.get("attrs") or jn.get("param") or {}).items()}
        inputs = [(nodes[i], oi) for (i, oi, *_rest) in jn["inputs"]]
        nodes.append(_Node(None if op == "null" else op, attrs, inputs,
                           jn["name"]))
    heads = data.get("heads")
    if not heads:
        heads = [[len(nodes) - 1, 0, 0]]
    return Symbol([(nodes[i], oi) for (i, oi, *_r) in heads])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _abstract_eval(info, attrs, in_structs):
    """Output tensors of op ``info`` on ``in_structs``: first on meta
    tensors; an op that cannot run there (it reads a value on the host)
    runs on zero CPU tensors of the same shapes and dtypes."""
    if info.num_inputs == 0:
        attrs = dict(attrs, ctx=torch.device("meta"))
    try:
        with torch.no_grad():
            out = info.fn(*in_structs, **attrs)
    except Exception:
        zeros = [torch.zeros(t.shape, dtype=t.dtype) for t in in_structs]
        with torch.no_grad():
            out = info.fn(*zeros, **attrs)
    return list(out) if isinstance(out, tuple) else [out]


# ---------------------------------------------------------------------------
# parameter-shape deduction rules (stand-in for backward shape inference in
# src/executor/infer_graph_attr_pass.cc; enough for the model zoo)
# ---------------------------------------------------------------------------


def _deduce_param_shape(node, pos, input_name, node_out_shapes, shapes):
    op = node.op
    attrs = node.attrs

    def in_shape(i):
        inp, oi = node.inputs[i]
        s = node_out_shapes.get(id(inp))
        return None if s is None else tuple(s[oi].shape)

    data_shape = in_shape(0)
    if data_shape is None:
        return None
    if op == "FullyConnected":
        nh = pint(attrs.get("num_hidden"))
        flat = pbool(attrs.get("flatten"), True)
        in_dim = int(np.prod(data_shape[1:])) if flat else data_shape[-1]
        if input_name == "weight":
            return (nh, in_dim)
        if input_name == "bias":
            return (nh,)
    elif op == "Convolution":
        k = ptuple(attrs.get("kernel"))
        nf = pint(attrs.get("num_filter"))
        ng = pint(attrs.get("num_group"), 1)
        if input_name == "weight":
            return (nf, data_shape[1] // ng) + k
        if input_name == "bias":
            return (nf,)
    elif op == "Deconvolution":
        k = ptuple(attrs.get("kernel"))
        nf = pint(attrs.get("num_filter"))
        ng = pint(attrs.get("num_group"), 1)
        if input_name == "weight":
            return (data_shape[1], nf // ng) + k
        if input_name == "bias":
            return (nf,)
    elif op in ("BatchNorm", "SyncBatchNorm", "_contrib_norm_act"):
        ax = pint(attrs.get("axis"), 1)
        c = data_shape[ax]
        return (c,)
    elif op == "_contrib_conv_bn_relu":
        k = ptuple(attrs.get("kernel"))
        nf = pint(attrs.get("num_filter"))
        ng = pint(attrs.get("num_group"), 1)
        if input_name == "weight":
            return (nf, data_shape[1] // ng) + k
        if input_name in ("gamma", "beta", "moving_mean", "moving_var",
                          "bias"):
            return (nf,)
    elif op in ("LayerNorm", "_contrib_layer_norm_fused"):
        ax = pint(attrs.get("axis"), -1)
        return (data_shape[ax],)
    elif op == "InstanceNorm":
        return (data_shape[1],)
    elif op == "Embedding":
        if input_name == "weight":
            return (pint(attrs.get("input_dim")), pint(attrs.get("output_dim")))
    elif op == "LeakyReLU" and input_name == "gamma":
        return (data_shape[1] if len(data_shape) > 1 else data_shape[0],)
    elif op == "RNN":
        H = pint(attrs.get("state_size"))
        L = pint(attrs.get("num_layers"), 1)
        D = 2 if pbool(attrs.get("bidirectional")) else 1
        mode = attrs.get("mode", "lstm")
        gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        C = data_shape[2]
        if input_name == "parameters":
            size = 0
            for layer in range(L):
                in_sz = C if layer == 0 else H * D
                size += D * gates * H * (in_sz + H)
            size += L * D * 2 * gates * H
            return (size,)
        if input_name in ("state", "state_cell"):
            return (L * D, data_shape[1], H)
    elif op in ("SoftmaxOutput", "LinearRegressionOutput",
                "LogisticRegressionOutput", "MAERegressionOutput") \
            and input_name == "label":
        if op == "SoftmaxOutput":
            return data_shape[:1] if not pbool(attrs.get("multi_output")) \
                else (data_shape[0],) + data_shape[2:]
        return data_shape
    return None


# ---------------------------------------------------------------------------
# symbol construction
# ---------------------------------------------------------------------------


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    ua = AttrScope.current().get(attr or {})
    if shape is not None:
        ua["__shape__"] = str(tuple(shape))
    if dtype is not None:
        ua["__dtype__"] = str(dtype)
    if init is not None:
        ua["__init__"] = init.dumps() if hasattr(init, "dumps") else str(init)
    if lr_mult is not None:
        ua["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        ua["__wd_mult__"] = str(wd_mult)
    node = _Node(None, {}, [], name, ua)
    return Symbol([(node, 0)])


Variable = var


def Group(symbols):
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def zeros(shape, dtype="float32", **kw):
    return _invoke_sym("_zeros", [], {"shape": shape, "dtype": dtype})


def ones(shape, dtype="float32", **kw):
    return _invoke_sym("_ones", [], {"shape": shape, "dtype": dtype})


def _invoke_sym(op_name, inputs, attrs, name=None):
    info = get_op(op_name)
    attrs = clean_attrs(attrs)
    sym_kwargs = {k: v for k, v in attrs.items() if isinstance(v, Symbol)}
    for k in sym_kwargs:
        del attrs[k]
    # input-position kwargs passed as None (e.g. weight=None meaning
    # "auto-create") must not linger in attrs: the executor would pass
    # them as keywords on top of the positional inputs
    for k in _INPUT_NAMES.get(op_name, ()):
        if k in attrs and attrs[k] is None:
            del attrs[k]
    name = NameManager.current().get(name, op_name.strip("_"))

    entries = []
    for s in inputs:
        if isinstance(s, Symbol):
            if len(s._entries) != 1:
                entries.extend(s._entries)
            else:
                entries.append(s._entries[0])
        else:
            raise MXNetError("symbol op %s: input must be Symbol, got %r"
                             % (op_name, type(s)))
    # place keyword Symbols at their canonical input positions and
    # auto-create variables for every other missing slot (reference
    # symbol composition); a keyword for a later slot (bias=b with
    # weight omitted) must NOT slide into the earlier position
    expected_n = info.num_inputs
    if expected_n in (-1, None):
        expected_n = _expected_inputs(op_name, attrs)
    if expected_n not in (-1, None) and \
            len(entries) + len(sym_kwargs) <= expected_n:
        names = _op_input_names(op_name, expected_n)
        no_bias = pbool(attrs.get("no_bias"))
        for i in range(len(entries), expected_n):
            nm = names[i] if i < len(names) else "arg%d" % i
            if nm in sym_kwargs:
                entries.append(sym_kwargs.pop(nm)._entries[0])
                continue
            if nm == "bias" and no_bias:
                continue
            if nm == "state_cell" and attrs.get("mode", "lstm") != "lstm":
                continue
            v = var("%s_%s" % (name, nm))
            entries.append(v._entries[0])
    if sym_kwargs:
        # variadic ops / names outside the canonical table: append in
        # canonical-then-given order
        expected = _op_input_names(op_name,
                                   len(entries) + len(sym_kwargs))
        ordered = [k for k in expected if k in sym_kwargs]
        ordered += [k for k in sym_kwargs if k not in ordered]
        for k in ordered:
            entries.append(sym_kwargs[k]._entries[0])

    node = _Node(op_name, attrs, entries, name,
                 AttrScope.current().get({}))
    # composition sees only visible outputs (reference FNumVisibleOutputs:
    # BatchNorm's mean/var are internal) — the executor still receives
    # the op fn's full output tuple
    n_out = info.n_visible_outputs(attrs)
    return Symbol([(node, i) for i in range(n_out)]) if n_out > 1 \
        else Symbol([(node, 0)])


def _expected_inputs(op_name, attrs):
    """Expected input arity for variadic-registered ops that take learned
    parameters (drives auto-var creation)."""
    if op_name in ("FullyConnected", "Convolution", "Deconvolution"):
        return 2 if pbool(attrs.get("no_bias")) else 3
    if op_name == "_contrib_conv_bn_relu":
        return 6 if pbool(attrs.get("no_bias"), True) else 7
    if op_name == "LeakyReLU":
        return 2 if attrs.get("act_type") == "prelu" else 1
    if op_name == "RNN":
        return 4 if attrs.get("mode", "lstm") == "lstm" else 3
    if op_name in ("SequenceMask", "SequenceLast", "SequenceReverse"):
        return 2 if pbool(attrs.get("use_sequence_length")) else 1
    return -1


def pow(base, exp):
    return base ** exp
