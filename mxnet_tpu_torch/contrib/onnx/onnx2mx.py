"""ONNX -> Symbol importer (parity: mxnet_tpu/contrib/onnx/onnx2mx.py,
building the port's Symbol; parameters come back as NDArrays on
``current_context()``, the card unless the caller enters ``mx.cpu()``).

Reference parity: ``python/mxnet/contrib/onnx/onnx2mx/import_model.py``
(``import_model(file) -> (sym, arg_params, aux_params)`` and
``get_model_metadata``) plus the translator breadth of
``onnx2mx/_op_translations.py``.  Parses real .onnx protobuf via
``_proto``.

Supported ONNX ops (the inverse of mx2onnx's table): Gemm, MatMul,
Conv, ConvTranspose, BatchNormalization, InstanceNormalization, LRN,
LpNormalization, Max/AveragePool, Global*Pool, MaxRoiPool, Relu,
Sigmoid, Tanh, Softplus, Softsign, LeakyRelu, Elu, Selu, Gelu, PRelu,
HardSigmoid, Softmax, LogSoftmax, Dropout, Flatten, Concat, Reshape,
Transpose, Identity, Constant, Add/Sub/Mul/Div, Max/Min/Sum, Pow, Neg,
Abs, Ceil, Floor, Sqrt, Exp, Log, Reciprocal, Sin/Cos/Tan/Asin/Acos/
Atan, Clip, Cast, Pad, Slice, Split, Squeeze, Unsqueeze, Tile, Expand,
DepthToSpace, SpaceToDepth, Shape, Size, ReduceSum/Mean/Min/Max/Prod/
L1/L2, ArgMax/ArgMin, Less/Greater/Equal, And/Or/Xor, Not,
RandomUniform, RandomNormal, Multinomial.
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from . import _proto as P

__all__ = ["import_model", "get_model_metadata"]

_NP_OF = {P.TP_FLOAT: np.float32, P.TP_DOUBLE: np.float64,
          P.TP_INT32: np.int32, P.TP_INT64: np.int64,
          P.TP_INT8: np.int8, P.TP_UINT8: np.uint8,
          P.TP_BOOL: np.bool_}


def _tensor_to_np(t):
    dt = _NP_OF.get(t.get("data_type", P.TP_FLOAT), np.float32)
    dims = t.get("dims", [])
    if "raw_data" in t:
        return np.frombuffer(t["raw_data"], dt).reshape(dims).copy()
    if "float_data" in t:
        return np.asarray(t["float_data"], np.float32).reshape(dims)
    if "int64_data" in t:
        return np.asarray(t["int64_data"], np.int64).reshape(dims)
    return np.zeros(dims, dt)


def _attrs_of(node):
    out = {}
    for a in node.get("attribute", []):
        t = a.get("type")
        if t == P.ATTR_INT:
            out[a["name"]] = a.get("i", 0)
        elif t == P.ATTR_FLOAT:
            out[a["name"]] = a.get("f", 0.0)
        elif t == P.ATTR_STRING:
            out[a["name"]] = a.get("s", b"").decode("utf-8")
        elif t == P.ATTR_INTS:
            out[a["name"]] = tuple(a.get("ints", []))
        elif t == P.ATTR_FLOATS:
            out[a["name"]] = tuple(a.get("floats", []))
        elif t == P.ATTR_TENSOR:
            out[a["name"]] = _tensor_to_np(a["t"])
    return out


def _split_pads(pads, nd):
    if not pads:
        return (0,) * nd
    begin, end = pads[:nd], pads[nd:]
    if tuple(begin) != tuple(end):
        raise MXNetError("asymmetric ONNX pads %s unsupported" % (pads,))
    return tuple(begin)


class _Ctx:
    """State shared by node converters."""

    def __init__(self, S, initializers):
        self.S = S
        self.initializers = initializers
        self.aux_names = set()
        self.consumed = set()
        self.gemm_fresh = {}   # fresh transposed-copy name -> var sym

    def const_of(self, name, what):
        """An input that must be a compile-time constant (shape/axes/
        scalar operands the mx attr system wants as attributes)."""
        if name not in self.initializers:
            raise MXNetError("dynamic %s input unsupported (must be an "
                             "initializer)" % what)
        self.consumed.add(name)
        return self.initializers[name]


_IMPORTERS = {}


def imports(*ops):
    def deco(fn):
        for o in ops:
            _IMPORTERS[o] = fn
        return fn
    return deco


# 1:1 single-input renames
_SIMPLE = {
    "Relu": ("Activation", {"act_type": "relu"}),
    "Sigmoid": ("Activation", {"act_type": "sigmoid"}),
    "Tanh": ("Activation", {"act_type": "tanh"}),
    "Softplus": ("Activation", {"act_type": "softrelu"}),
    "Softsign": ("Activation", {"act_type": "softsign"}),
    "Identity": ("identity", {}),
    "Neg": ("negative", {}),
    "Abs": ("abs", {}),
    "Ceil": ("ceil", {}),
    "Floor": ("floor", {}),
    "Sqrt": ("sqrt", {}),
    "Exp": ("exp", {}),
    "Log": ("log", {}),
    "Reciprocal": ("reciprocal", {}),
    "Sin": ("sin", {}), "Cos": ("cos", {}), "Tan": ("tan", {}),
    "Asin": ("arcsin", {}), "Acos": ("arccos", {}),
    "Atan": ("arctan", {}),
    "Flatten": ("Flatten", {}),
    "Shape": ("shape_array", {}),
    "Size": ("size_array", {}),
    "Not": ("logical_not", {}),
}

for _ox, (_mx, _a) in _SIMPLE.items():
    def _mk(mx, aa):
        def fn(ctx, node, ins, a, name):
            return ctx.S._invoke_sym(mx, ins[:1], dict(aa), name=name)
        return fn
    _IMPORTERS[_ox] = _mk(_mx, _a)

# two-input broadcasting arithmetic
for _ox, _mx in {"Add": "broadcast_add", "Sub": "broadcast_sub",
                 "Mul": "broadcast_mul", "Div": "broadcast_div",
                 "Pow": "broadcast_power",
                 "Less": "broadcast_lesser",
                 "Greater": "broadcast_greater",
                 "Equal": "broadcast_equal",
                 "And": "broadcast_logical_and",
                 "Or": "broadcast_logical_or",
                 "Xor": "broadcast_logical_xor"}.items():
    def _mk2(mx):
        def fn(ctx, node, ins, a, name):
            return ctx.S._invoke_sym(mx, ins[:2], {}, name=name)
        return fn
    _IMPORTERS[_ox] = _mk2(_mx)


@imports("MatMul")
def _i_matmul(ctx, node, ins, a, name):
    # ONNX MatMul is batched over leading dims: linalg_gemm2, not mx
    # dot (which tensordots last axis against first)
    return ctx.S._invoke_sym("_linalg_gemm2", ins[:2], {}, name=name)


@imports("Max", "Min", "Sum")
def _i_variadic(ctx, node, ins, a, name):
    if len(ins) == 1:
        return ctx.S._invoke_sym("identity", ins, {}, name=name)
    if node["op_type"] == "Sum":
        return ctx.S._invoke_sym("add_n", ins,
                                 {"num_args": len(ins)}, name=name)
    mx = "broadcast_maximum" if node["op_type"] == "Max" \
        else "broadcast_minimum"
    out = ins[0]
    for i, nxt in enumerate(ins[1:]):
        out = ctx.S._invoke_sym(
            mx, [out, nxt], {},
            name=name if i == len(ins) - 2 else "%s_%d" % (name, i))
    return out


@imports("Gemm")
def _i_gemm(ctx, node, ins, a, name):
    if a.get("transA"):
        raise MXNetError("Gemm transA unsupported")
    if a.get("alpha", 1.0) != 1.0 or \
            (len(ins) > 2 and a.get("beta", 1.0) != 1.0):
        raise MXNetError("Gemm alpha/beta scaling unsupported "
                         "(fold them into the weights/bias)")
    w_name = node["input"][1]
    inits = ctx.initializers
    # transB=0 weights are stored (K, N) and FullyConnected wants (N, K).
    # NEVER mutate inits[w_name] in place: the initializer may be shared
    # with a non-Gemm consumer (MatMul/Add/...) that needs the original
    # layout, and the dict is read only after all nodes convert, so an
    # in-place transpose would silently corrupt that consumer.  Instead
    # materialize the transposed copy once under a fresh name (the same
    # mechanism the mixed-transB share always used) and leave the
    # original untouched; transB=1 nodes use the original as-is.
    transb = bool(a.get("transB"))
    if not transb:
        fresh = w_name + "_gemm_t"
        if fresh not in inits:
            inits[fresh] = np.ascontiguousarray(inits[w_name].T)
            ctx.gemm_fresh[fresh] = ctx.S.var(fresh)
        w_name = fresh
        ins = [ins[0], ctx.gemm_fresh[fresh]] + list(ins[2:])
    num_hidden = inits[w_name].shape[0]
    return ctx.S._invoke_sym("FullyConnected", ins,
                             {"num_hidden": int(num_hidden),
                              "no_bias": len(ins) < 3,
                              "flatten": False}, name=name)


@imports("Conv")
def _i_conv(ctx, node, ins, a, name):
    kernel = a.get("kernel_shape")
    nd = len(kernel)
    w_name = node["input"][1]
    return ctx.S._invoke_sym(
        "Convolution", ins,
        {"kernel": tuple(kernel),
         "stride": tuple(a.get("strides", (1,) * nd)),
         "pad": _split_pads(a.get("pads"), nd),
         "dilate": tuple(a.get("dilations", (1,) * nd)),
         "num_filter": int(ctx.initializers[w_name].shape[0]),
         "num_group": int(a.get("group", 1)),
         "no_bias": len(ins) < 3}, name=name)


@imports("ConvTranspose")
def _i_deconv(ctx, node, ins, a, name):
    kernel = a.get("kernel_shape")
    nd = len(kernel)
    w_name = node["input"][1]
    num_group = int(a.get("group", 1))
    # onnx W layout: (C, M/group, kH, kW) — num_filter is M
    num_filter = int(ctx.initializers[w_name].shape[1]) * num_group
    attrs = {"kernel": tuple(kernel),
             "stride": tuple(a.get("strides", (1,) * nd)),
             "pad": _split_pads(a.get("pads"), nd),
             "dilate": tuple(a.get("dilations", (1,) * nd)),
             "num_filter": num_filter,
             "num_group": num_group,
             "no_bias": len(ins) < 3}
    adj = a.get("output_padding")
    if adj:
        attrs["adj"] = tuple(adj)
    return ctx.S._invoke_sym("Deconvolution", ins, attrs, name=name)


@imports("LeakyRelu")
def _i_leaky(ctx, node, ins, a, name):
    return ctx.S._invoke_sym("LeakyReLU", ins,
                             {"act_type": "leaky",
                              "slope": float(a.get("alpha", 0.01))},
                             name=name)


@imports("Elu", "Selu", "Gelu")
def _i_elu(ctx, node, ins, a, name):
    op = node["op_type"]
    if op == "Gelu" and a.get("approximate", "none") == "tanh":
        raise MXNetError("Gelu approximate='tanh' unsupported "
                         "(erf-based gelu only)")
    kind = {"Elu": "elu", "Selu": "selu", "Gelu": "gelu"}[op]
    attrs = {"act_type": kind}
    if op == "Elu":
        attrs["slope"] = float(a.get("alpha", 1.0))
    return ctx.S._invoke_sym("LeakyReLU", ins, attrs, name=name)


@imports("PRelu")
def _i_prelu(ctx, node, ins, a, name):
    return ctx.S._invoke_sym("LeakyReLU", ins[:2],
                             {"act_type": "prelu"}, name=name)


@imports("HardSigmoid")
def _i_hsig(ctx, node, ins, a, name):
    return ctx.S._invoke_sym("hard_sigmoid", ins,
                             {"alpha": float(a.get("alpha", 0.2)),
                              "beta": float(a.get("beta", 0.5))},
                             name=name)


@imports("BatchNormalization")
def _i_bn(ctx, node, ins, a, name):
    ctx.aux_names.update(node["input"][3:5])
    return ctx.S._invoke_sym(
        "BatchNorm", ins,
        {"eps": float(a.get("epsilon", 1e-5)),
         "momentum": float(a.get("momentum", 0.9)),
         "fix_gamma": False}, name=name)


@imports("InstanceNormalization")
def _i_instnorm(ctx, node, ins, a, name):
    return ctx.S._invoke_sym(
        "InstanceNorm", ins,
        {"eps": float(a.get("epsilon", 1e-5))}, name=name)


@imports("LRN")
def _i_lrn(ctx, node, ins, a, name):
    return ctx.S._invoke_sym(
        "LRN", ins,
        {"alpha": float(a.get("alpha", 1e-4)),
         "beta": float(a.get("beta", 0.75)),
         "knorm": float(a.get("bias", 1.0)),
         "nsize": int(a.get("size", 5))}, name=name)


@imports("LpNormalization")
def _i_lpnorm(ctx, node, ins, a, name):
    if int(a.get("p", 2)) != 2 or int(a.get("axis", -1)) != 1:
        raise MXNetError("LpNormalization: only p=2 axis=1 maps to "
                         "L2Normalization(mode='channel')")
    return ctx.S._invoke_sym("L2Normalization", ins,
                             {"mode": "channel"}, name=name)


@imports("MaxPool", "AveragePool")
def _i_pool(ctx, node, ins, a, name):
    op = node["op_type"]
    kernel = a.get("kernel_shape")
    nd = len(kernel)
    attrs = {"kernel": tuple(kernel),
             "stride": tuple(a.get("strides", (1,) * nd)),
             "pad": _split_pads(a.get("pads"), nd),
             "pool_type": "max" if op == "MaxPool" else "avg"}
    if op == "AveragePool":
        # ONNX defaults count_include_pad=0; mx defaults True
        attrs["count_include_pad"] = bool(a.get("count_include_pad", 0))
    return ctx.S._invoke_sym("Pooling", ins, attrs, name=name)


@imports("GlobalMaxPool", "GlobalAveragePool")
def _i_gpool(ctx, node, ins, a, name):
    op = node["op_type"]
    return ctx.S._invoke_sym(
        "Pooling", ins,
        {"kernel": (1, 1), "global_pool": True,
         "pool_type": "max" if op == "GlobalMaxPool" else "avg"},
        name=name)


@imports("MaxRoiPool")
def _i_roipool(ctx, node, ins, a, name):
    return ctx.S._invoke_sym(
        "ROIPooling", ins,
        {"pooled_size": tuple(a.get("pooled_shape")),
         "spatial_scale": float(a.get("spatial_scale", 1.0))},
        name=name)


@imports("Softmax")
def _i_softmax(ctx, node, ins, a, name):
    return ctx.S._invoke_sym("softmax", ins,
                             {"axis": int(a.get("axis", -1))}, name=name)


@imports("LogSoftmax")
def _i_logsoftmax(ctx, node, ins, a, name):
    return ctx.S._invoke_sym("log_softmax", ins,
                             {"axis": int(a.get("axis", -1))}, name=name)


@imports("Concat")
def _i_concat(ctx, node, ins, a, name):
    return ctx.S._invoke_sym("Concat", ins,
                             {"dim": int(a.get("axis", 1)),
                              "num_args": len(ins)}, name=name)


@imports("Dropout")
def _i_dropout(ctx, node, ins, a, name):
    return ctx.S._invoke_sym("Dropout", ins[:1], {}, name=name)


@imports("Reshape")
def _i_reshape(ctx, node, ins, a, name):
    shape = tuple(int(v) for v in
                  ctx.const_of(node["input"][1], "Reshape shape"))
    return ctx.S._invoke_sym("Reshape", ins[:1], {"shape": shape},
                             name=name)


@imports("Transpose")
def _i_transpose(ctx, node, ins, a, name):
    axes = a.get("perm")
    attrs = {"axes": tuple(axes)} if axes else {}
    return ctx.S._invoke_sym("transpose", ins, attrs, name=name)


@imports("Constant")
def _i_constant(ctx, node, ins, a, name):
    val = a.get("value")
    if val is None:
        raise MXNetError("Constant without tensor value unsupported")
    ctx.initializers[node["output"][0]] = np.asarray(val)
    return None  # becomes an initializer, not a node


@imports("Clip")
def _i_clip(ctx, node, ins, a, name):
    # opset>=11: min/max arrive as inputs; pre-11 as attrs
    if len(node["input"]) > 1 and node["input"][1]:
        lo = float(np.asarray(ctx.const_of(node["input"][1],
                                           "Clip min")).ravel()[0])
    else:
        lo = float(a.get("min", -3.4e38))
    if len(node["input"]) > 2 and node["input"][2]:
        hi = float(np.asarray(ctx.const_of(node["input"][2],
                                           "Clip max")).ravel()[0])
    else:
        hi = float(a.get("max", 3.4e38))
    return ctx.S._invoke_sym("clip", ins[:1],
                             {"a_min": lo, "a_max": hi}, name=name)


@imports("Cast")
def _i_cast(ctx, node, ins, a, name):
    dt = _NP_OF.get(int(a.get("to", P.TP_FLOAT)), np.float32)
    return ctx.S._invoke_sym("Cast", ins[:1],
                             {"dtype": np.dtype(dt).name}, name=name)


@imports("Pad")
def _i_pad(ctx, node, ins, a, name):
    mode = a.get("mode", "constant")
    if len(node["input"]) > 1:
        pads = [int(v) for v in ctx.const_of(node["input"][1],
                                             "Pad pads")]
    else:
        pads = list(a.get("pads", ()))
    nd = len(pads) // 2
    pw = []
    for i in range(nd):
        pw += [pads[i], pads[nd + i]]
    attrs = {"mode": mode, "pad_width": tuple(pw)}
    if mode == "constant":
        if len(node["input"]) > 2 and node["input"][2]:
            attrs["constant_value"] = float(np.asarray(ctx.const_of(
                node["input"][2], "Pad value")).ravel()[0])
        else:
            attrs["constant_value"] = float(a.get("value", 0.0))
    return ctx.S._invoke_sym("Pad", ins[:1], attrs, name=name)


@imports("Slice")
def _i_slice(ctx, node, ins, a, name):
    if len(node["input"]) >= 3:
        starts = [int(v) for v in ctx.const_of(node["input"][1],
                                               "Slice starts")]
        ends = [int(v) for v in ctx.const_of(node["input"][2],
                                             "Slice ends")]
        if len(node["input"]) >= 4 and node["input"][3]:
            axes = [int(v) for v in ctx.const_of(node["input"][3],
                                                 "Slice axes")]
        else:
            axes = list(range(len(starts)))
        if len(node["input"]) >= 5 and node["input"][4]:
            steps = [int(v) for v in ctx.const_of(node["input"][4],
                                                  "Slice steps")]
            if any(s != 1 for s in steps):
                raise MXNetError("Slice steps != 1 unsupported")
    else:  # opset<10 attribute form
        starts = list(a.get("starts", ()))
        ends = list(a.get("ends", ()))
        axes = list(a.get("axes", range(len(starts))))
    out = ins[0]
    for i, (ax, st, en) in enumerate(zip(axes, starts, ends)):
        attrs = {"axis": int(ax), "begin": int(st)}
        if en < 2 ** 31 - 1:  # sentinel "to the end" stays unset
            attrs["end"] = int(en)
        out = ctx.S._invoke_sym(
            "slice_axis", [out], attrs,
            name=name if i == len(axes) - 1 else "%s_ax%d" % (name, i))
    return out


@imports("Split")
def _i_split(ctx, node, ins, a, name):
    n_out = len(node.get("output", []))
    if len(node.get("input", [])) > 1 and node["input"][1]:
        # opset>=13 carries split sizes as an input tensor
        sizes = [int(v) for v in ctx.const_of(node["input"][1],
                                              "Split sizes")]
    else:
        sizes = list(a.get("split", ()))
    if sizes and len(set(sizes)) != 1:
        raise MXNetError("uneven Split unsupported")
    return ctx.S._invoke_sym("SliceChannel", ins[:1],
                             {"num_outputs": n_out,
                              "axis": int(a.get("axis", 0))}, name=name)


@imports("Squeeze")
def _i_squeeze(ctx, node, ins, a, name):
    if len(node["input"]) > 1:
        axes = tuple(int(v) for v in
                     ctx.const_of(node["input"][1], "Squeeze axes"))
    else:
        axes = tuple(a.get("axes", ()))
    attrs = {"axis": axes} if axes else {}
    return ctx.S._invoke_sym("squeeze", ins[:1], attrs, name=name)


@imports("Unsqueeze")
def _i_unsqueeze(ctx, node, ins, a, name):
    if len(node["input"]) > 1:
        axes = [int(v) for v in ctx.const_of(node["input"][1],
                                             "Unsqueeze axes")]
    else:
        axes = list(a.get("axes", ()))
    out = ins[0]
    for i, ax in enumerate(sorted(axes)):
        out = ctx.S._invoke_sym(
            "expand_dims", [out], {"axis": int(ax)},
            name=name if i == len(axes) - 1 else "%s_ax%d" % (name, i))
    return out


@imports("Tile")
def _i_tile(ctx, node, ins, a, name):
    reps = tuple(int(v) for v in ctx.const_of(node["input"][1],
                                              "Tile repeats"))
    return ctx.S._invoke_sym("tile", ins[:1], {"reps": reps}, name=name)


@imports("Expand")
def _i_expand(ctx, node, ins, a, name):
    shape = tuple(int(v) for v in ctx.const_of(node["input"][1],
                                               "Expand shape"))
    return ctx.S._invoke_sym("broadcast_to", ins[:1], {"shape": shape},
                             name=name)


@imports("DepthToSpace", "SpaceToDepth")
def _i_d2s(ctx, node, ins, a, name):
    mx = "depth_to_space" if node["op_type"] == "DepthToSpace" \
        else "space_to_depth"
    return ctx.S._invoke_sym(mx, ins[:1],
                             {"block_size": int(a.get("blocksize", 1))},
                             name=name)


@imports("ReduceSum", "ReduceMean", "ReduceMin", "ReduceMax",
         "ReduceProd", "ReduceL1", "ReduceL2")
def _i_reduce(ctx, node, ins, a, name):
    op = node["op_type"]
    if op == "ReduceSum" and len(node["input"]) > 1:
        axes = tuple(int(v) for v in
                     ctx.const_of(node["input"][1], "ReduceSum axes"))
    else:
        axes = tuple(a.get("axes", ()))
    keep = bool(a.get("keepdims", 1))
    if op in ("ReduceL1", "ReduceL2"):
        attrs = {"ord": 1 if op == "ReduceL1" else 2,
                 "keepdims": keep}
        if axes:
            attrs["axis"] = axes
        return ctx.S._invoke_sym("norm", ins[:1], attrs, name=name)
    mx = {"ReduceSum": "sum", "ReduceMean": "mean", "ReduceMin": "min",
          "ReduceMax": "max", "ReduceProd": "prod"}[op]
    attrs = {"keepdims": keep}
    if axes:
        attrs["axis"] = axes
    return ctx.S._invoke_sym(mx, ins[:1], attrs, name=name)


@imports("ArgMax", "ArgMin")
def _i_arg(ctx, node, ins, a, name):
    mx = "argmax" if node["op_type"] == "ArgMax" else "argmin"
    return ctx.S._invoke_sym(
        mx, ins[:1],
        {"axis": int(a.get("axis", 0)),
         "keepdims": bool(a.get("keepdims", 1))}, name=name)


@imports("RandomUniform")
def _i_runiform(ctx, node, ins, a, name):
    return ctx.S._invoke_sym(
        "_random_uniform", [],
        {"low": float(a.get("low", 0.0)),
         "high": float(a.get("high", 1.0)),
         "shape": tuple(a.get("shape", ()))}, name=name)


@imports("RandomNormal")
def _i_rnormal(ctx, node, ins, a, name):
    return ctx.S._invoke_sym(
        "_random_normal", [],
        {"loc": float(a.get("mean", 0.0)),
         "scale": float(a.get("scale", 1.0)),
         "shape": tuple(a.get("shape", ()))}, name=name)


@imports("Multinomial")
def _i_multinomial(ctx, node, ins, a, name):
    return ctx.S._invoke_sym(
        "_sample_multinomial", ins[:1],
        {"shape": (int(a.get("sample_size", 1)),)}, name=name)


def _convert_node(ctx, node, ins, name):
    fn = _IMPORTERS.get(node["op_type"])
    if fn is None:
        raise MXNetError("ONNX import: unsupported operator %r"
                         % node["op_type"])
    return fn(ctx, node, ins, _attrs_of(node), name)


# inputs that converters consume as attributes, not graph inputs
_ATTR_INPUTS = {"Reshape": 1, "Clip": 1, "Pad": 1, "Slice": 1,
                "Squeeze": 1, "Unsqueeze": 1, "Tile": 1, "Expand": 1,
                "ReduceSum": 1, "Split": 1}


def import_model(model_file):
    """Parse a .onnx file -> (sym, arg_params, aux_params)."""
    from ...ndarray.ndarray import array
    from ...symbol import symbol as S

    with open(model_file, "rb") as f:
        model = P.decode(f.read(), "ModelProto")
    graph = model["graph"]
    initializers = {t["name"]: _tensor_to_np(t)
                    for t in graph.get("initializer", [])}
    ctx = _Ctx(S, initializers)

    value_syms = {}

    def sym_of(name):
        if name not in value_syms:
            value_syms[name] = S.var(name)
        return value_syms[name]

    for node in graph.get("node", []):
        keep = _ATTR_INPUTS.get(node["op_type"], len(node.get("input",
                                                              [])))
        ins = [sym_of(n) for n in node.get("input", [])[:keep]]
        out_sym = _convert_node(ctx, node, ins,
                                node.get("name") or node["output"][0])
        if out_sym is None:
            continue  # folded to an initializer (Constant)
        outs = list(out_sym) if len(out_sym) > 1 else [out_sym]
        for i, out_name in enumerate(node.get("output", [])):
            if i < len(outs):
                value_syms[out_name] = outs[i]

    outputs = [value_syms[o["name"]] for o in graph.get("output", [])]
    sym = S.Group(outputs) if len(outputs) > 1 else outputs[0]

    arg_params, aux_params = {}, {}
    live = set(sym.list_inputs())
    for name, arr in initializers.items():
        if name in ctx.consumed:
            continue  # attr-folded (e.g. Reshape shape tensors)
        if name not in live:
            # not referenced by the final graph — e.g. a Gemm weight
            # whose consumers all use the fresh transposed copy; binding
            # it would make Module.set_params reject the param dict
            continue
        target = aux_params if name in ctx.aux_names else arg_params
        target[name] = array(arr.astype(np.float32)
                             if arr.dtype == np.float64 else arr)
    return sym, arg_params, aux_params


def get_model_metadata(model_file):
    """Input/output names + shapes of an .onnx file (parity:
    onnx2mx.import_model.get_model_metadata)."""
    with open(model_file, "rb") as f:
        model = P.decode(f.read(), "ModelProto")
    graph = model["graph"]

    def fmt(vi):
        tt = vi.get("type", {}).get("tensor_type", {})
        dims = tuple(d.get("dim_value", 0)
                     for d in tt.get("shape", {}).get("dim", []))
        return (vi["name"], dims)

    inits = {t["name"] for t in graph.get("initializer", [])}
    return {
        "input_tensor_data": [fmt(v) for v in graph.get("input", [])
                              if v["name"] not in inits],
        "output_tensor_data": [fmt(v) for v in graph.get("output", [])],
    }
