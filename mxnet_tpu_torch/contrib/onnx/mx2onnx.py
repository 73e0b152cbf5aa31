"""Symbol -> ONNX exporter (parity: mxnet_tpu/contrib/onnx/mx2onnx.py,
walking the port's Symbol).

Reference parity: ``python/mxnet/contrib/onnx/mx2onnx/export_model.py``
plus the 97 ``convert_*`` translators of ``mx2onnx/_op_translations.py``.
The graph walk emits ONNX opset-13 nodes; serialization uses the
self-contained wire codec in ``_proto`` (no onnx package needed).

Operator coverage (reference ``@mx_op.register`` list, all 97):

==================== =========================================
mx op(s)             ONNX lowering
==================== =========================================
null                 graph input / initializer
FullyConnected       (Flatten) + Gemm
Convolution          Conv
Deconvolution        ConvTranspose
Pooling              Max/AveragePool / Global*Pool
BatchNorm            BatchNormalization
InstanceNorm         InstanceNormalization
LRN                  LRN
L2Normalization      LpNormalization(p=2)
Activation           Relu/Sigmoid/Tanh/Softplus
LeakyReLU            LeakyRelu/Elu/Selu/PRelu
softmax/log_softmax  Softmax/LogSoftmax
SoftmaxOutput        Softmax
LogisticRegressionOutput  Sigmoid
Logistic/MAE/MakeLoss/BlockGrad/_copy/identity  Identity
Dropout              Dropout
Concat               Concat
Pad                  Pad (pads input, opset-13 form)
Crop                 Slice
clip                 Clip (min/max inputs)
Cast                 Cast
Reshape              Reshape (shape initializer)
Flatten              Flatten
transpose            Transpose
expand_dims/squeeze  Unsqueeze/Squeeze (axes input)
slice_axis           Slice
SliceChannel         Split
tile                 Tile
broadcast_to         Expand
depth_to_space       DepthToSpace
space_to_depth       SpaceToDepth
dot/_linalg_gemm2    MatMul (+Transpose for transpose flags)
elemwise/broadcast   Add/Sub/Mul/Div arithmetic family
_maximum/_minimum    Max/Min
_*_scalar family     const initializer + Add/Sub/Mul/Div/Pow
negative/abs/...     Neg/Abs/Ceil/Floor/Sqrt/Exp/Log/...
trig family          Sin/Cos/Tan/Asin/Acos/Atan
square               Pow(x, 2)
reciprocal           Reciprocal
_power/broadcast_power  Pow
add_n                Sum
sum/mean/min/max/prod  ReduceSum(axes input)/ReduceMean/...
norm                 ReduceL1/ReduceL2
argmax/argmin        ArgMax/ArgMin (+Cast to float)
broadcast_lesser/... Less/Greater/Equal (+Cast to float)
broadcast_logical_*  And/Or/Xor over bool casts (+Cast back)
logical_not          Not over bool cast (+Cast back)
shape_array/size_array  Shape/Size
hard_sigmoid         HardSigmoid
_random_uniform/normal  RandomUniform/RandomNormal
_sample_multinomial  Multinomial
ROIPooling           MaxRoiPool
==================== =========================================
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from ...ops.utils import pbool, pfloat, pint, ptuple
from . import _proto as P

__all__ = ["export_model"]

# opset 13: Softmax/LogSoftmax gained per-axis semantics (pre-13 they
# flatten trailing dims), matching the mx ops we map onto them
_OPSET = 13


def _attr(name, value):
    """Build an AttributeProto from a python value."""
    if isinstance(value, bool):
        return {"name": name, "type": P.ATTR_INT, "i": int(value)}
    if isinstance(value, int):
        return {"name": name, "type": P.ATTR_INT, "i": value}
    if isinstance(value, float):
        return {"name": name, "type": P.ATTR_FLOAT, "f": value}
    if isinstance(value, str):
        return {"name": name, "type": P.ATTR_STRING,
                "s": value.encode("utf-8")}
    if isinstance(value, (tuple, list)):
        if all(isinstance(v, int) for v in value):
            return {"name": name, "type": P.ATTR_INTS,
                    "ints": list(value)}
        return {"name": name, "type": P.ATTR_FLOATS,
                "floats": [float(v) for v in value]}
    raise MXNetError("unsupported attribute %s=%r" % (name, value))


_TP_OF_NP = {np.dtype(np.float32): P.TP_FLOAT,
             np.dtype(np.float64): P.TP_DOUBLE,
             np.dtype(np.int32): P.TP_INT32,
             np.dtype(np.int64): P.TP_INT64,
             np.dtype(np.int8): P.TP_INT8,
             np.dtype(np.uint8): P.TP_UINT8,
             np.dtype(np.bool_): P.TP_BOOL}


def _tensor(name, arr):
    arr = np.ascontiguousarray(arr)
    dt = _TP_OF_NP.get(arr.dtype)
    if dt is None:
        arr = arr.astype(np.float32)
        dt = P.TP_FLOAT
    return {"name": name, "dims": list(arr.shape), "data_type": dt,
            "raw_data": arr.tobytes()}


def _vinfo(name, shape, elem_type=P.TP_FLOAT):
    return {"name": name, "type": {"tensor_type": {
        "elem_type": elem_type,
        "shape": {"dim": [{"dim_value": int(d)} for d in shape]}}}}


def _conv_attrs(attrs):
    kernel = ptuple(attrs.get("kernel"))
    nd = len(kernel)
    stride = ptuple(attrs.get("stride"), ndim=nd, default=(1,) * nd)
    pad = ptuple(attrs.get("pad"), ndim=nd, default=(0,) * nd)
    dilate = ptuple(attrs.get("dilate"), ndim=nd, default=(1,) * nd)
    return [_attr("kernel_shape", kernel),
            _attr("strides", stride),
            _attr("pads", pad + pad),
            _attr("dilations", dilate),
            _attr("group", pint(attrs.get("num_group"), 1))]


class _Exporter:
    def __init__(self, params):
        self.params = params      # name -> numpy
        self.nodes = []
        self.initializers = []
        self.used_params = set()
        self.shapes = {}          # value name -> inferred shape

    def emit(self, op_type, inputs, outputs, name, attrs=()):
        self.nodes.append({"op_type": op_type, "input": list(inputs),
                           "output": list(outputs), "name": name,
                           "attribute": list(attrs)})

    def add_init(self, name, arr):
        if name not in self.used_params:
            self.used_params.add(name)
            self.initializers.append(_tensor(name, np.asarray(arr)))

    def const(self, name, arr):
        self.add_init(name, arr)
        return name

    def cast_to_f32(self, src, out, name):
        """Comparison/logical ops produce bool in ONNX but float in mx:
        append a Cast so round-trips agree numerically."""
        self.emit("Cast", [src], [out], name,
                  [_attr("to", P.TP_FLOAT)])


# --------------------------------------------------------------------------
# translator registry
# --------------------------------------------------------------------------

_TRANSLATORS = {}


def translates(*ops):
    def deco(fn):
        for o in ops:
            _TRANSLATORS[o] = fn
        return fn
    return deco


# 1:1 renames with no attributes
_SIMPLE = {
    "tanh": "Tanh", "cos": "Cos", "sin": "Sin", "tan": "Tan",
    "arccos": "Acos", "arcsin": "Asin", "arctan": "Atan",
    "sigmoid": "Sigmoid", "relu": "Relu", "exp": "Exp", "log": "Log",
    "negative": "Neg", "abs": "Abs", "ceil": "Ceil", "floor": "Floor",
    "sqrt": "Sqrt", "reciprocal": "Reciprocal",
    "shape_array": "Shape", "size_array": "Size",
    "LogisticRegressionOutput": "Sigmoid",
    "_copy": "Identity", "identity": "Identity",
    "BlockGrad": "Identity", "MakeLoss": "Identity",
    "MAERegressionOutput": "Identity",
    "LinearRegressionOutput": "Identity",
}

for _mx, _ox in _SIMPLE.items():
    def _mk(ox):
        def fn(ex, node, ins, out, attrs, name):
            ex.emit(ox, ins[:1], [out], name)
        return fn
    _TRANSLATORS[_mx] = _mk(_ox)

# two-input elementwise
for _mx_ops, _ox in ((("elemwise_add", "_plus", "broadcast_add"), "Add"),
                     (("elemwise_sub", "_minus", "broadcast_sub"), "Sub"),
                     (("elemwise_mul", "_mul", "broadcast_mul"), "Mul"),
                     (("elemwise_div", "_div", "broadcast_div"), "Div"),
                     (("_maximum", "broadcast_maximum"), "Max"),
                     (("_minimum", "broadcast_minimum"), "Min"),
                     (("_power", "broadcast_power"), "Pow")):
    def _mk2(ox):
        def fn(ex, node, ins, out, attrs, name):
            ex.emit(ox, ins[:2], [out], name)
        return fn
    for _m in _mx_ops:
        _TRANSLATORS[_m] = _mk2(_ox)


@translates("add_n", "ElementWiseSum")
def _t_add_n(ex, node, ins, out, attrs, name):
    ex.emit("Sum", ins, [out], name)


@translates("dot")
def _t_dot(ex, node, ins, out, attrs, name):
    # MatMul only matches mx dot for rank-2 operands (N-D dot is a
    # tensordot of last-vs-first axes, which ONNX has no op for)
    a, b = ins[0], ins[1]
    for src in (a, b):
        shp = ex.shapes.get(src)
        if shp is not None and len(shp) != 2:
            raise MXNetError("ONNX export: dot with rank-%d input %r is "
                             "a tensordot, not MatMul; use linalg_gemm2 "
                             "for batched matmul" % (len(shp), src))

    def _t2(src, tag):
        t = name + tag
        ex.emit("Transpose", [src], [t], name + "_T" + tag,
                [_attr("perm", [1, 0])])
        return t

    if pbool(attrs.get("transpose_a")):
        a = _t2(a, "_ta")
    if pbool(attrs.get("transpose_b")):
        b = _t2(b, "_tb")
    ex.emit("MatMul", [a, b], [out], name)


# scalar arithmetic: materialize the scalar as an initializer
def _scalar_of(ex, attrs, name):
    return ex.const(name + "_sc",
                    np.asarray(pfloat(attrs.get("scalar"), 0.0),
                               np.float32))


for _mx, (_ox, _rev) in {
        "_plus_scalar": ("Add", False), "_minus_scalar": ("Sub", False),
        "_rminus_scalar": ("Sub", True), "_mul_scalar": ("Mul", False),
        "_div_scalar": ("Div", False), "_rdiv_scalar": ("Div", True),
        "_power_scalar": ("Pow", False),
        "_maximum_scalar": ("Max", False),
        "_minimum_scalar": ("Min", False)}.items():
    def _mks(ox, rev):
        def fn(ex, node, ins, out, attrs, name):
            sc = _scalar_of(ex, attrs, name)
            pair = [sc, ins[0]] if rev else [ins[0], sc]
            ex.emit(ox, pair, [out], name)
        return fn
    _TRANSLATORS[_mx] = _mks(_ox, _rev)


@translates("square")
def _t_square(ex, node, ins, out, attrs, name):
    two = ex.const(name + "_two", np.asarray(2.0, np.float32))
    ex.emit("Pow", [ins[0], two], [out], name)


# comparisons / logicals: ONNX yields bool; cast back to float for mx
for _mx, _ox in {"broadcast_lesser": "Less",
                 "broadcast_greater": "Greater",
                 "broadcast_equal": "Equal"}.items():
    def _mkc(ox):
        def fn(ex, node, ins, out, attrs, name):
            b = name + "_b"
            ex.emit(ox, ins[:2], [b], name + "_cmp")
            ex.cast_to_f32(b, out, name)
        return fn
    _TRANSLATORS[_mx] = _mkc(_ox)

for _mx, _ox in {"broadcast_logical_and": "And",
                 "broadcast_logical_or": "Or",
                 "broadcast_logical_xor": "Xor"}.items():
    def _mkl(ox):
        def fn(ex, node, ins, out, attrs, name):
            ba, bb, bo = name + "_ba", name + "_bb", name + "_bo"
            ex.emit("Cast", [ins[0]], [ba], name + "_ca",
                    [_attr("to", P.TP_BOOL)])
            ex.emit("Cast", [ins[1]], [bb], name + "_cb",
                    [_attr("to", P.TP_BOOL)])
            ex.emit(ox, [ba, bb], [bo], name + "_l")
            ex.cast_to_f32(bo, out, name)
        return fn
    _TRANSLATORS[_mx] = _mkl(_ox)


@translates("logical_not")
def _t_not(ex, node, ins, out, attrs, name):
    b, bo = name + "_b", name + "_bo"
    ex.emit("Cast", [ins[0]], [b], name + "_c",
            [_attr("to", P.TP_BOOL)])
    ex.emit("Not", [b], [bo], name + "_n")
    ex.cast_to_f32(bo, out, name)


# reductions.  opset 13: ReduceSum takes axes as INPUT; the others
# still take the axes attribute (until opset 18).
def _reduce_common(attrs):
    axis = ptuple(attrs.get("axis"), default=())
    keep = pbool(attrs.get("keepdims"))
    return axis, keep


for _mx, _ox in {"min": "ReduceMin", "max": "ReduceMax",
                 "mean": "ReduceMean", "prod": "ReduceProd"}.items():
    def _mkr(ox):
        def fn(ex, node, ins, out, attrs, name):
            axis, keep = _reduce_common(attrs)
            a = [_attr("keepdims", 1 if keep else 0)]
            if axis:
                a.append(_attr("axes", axis))
            ex.emit(ox, ins[:1], [out], name, a)
        return fn
    _TRANSLATORS[_mx] = _mkr(_ox)


@translates("sum")
def _t_sum(ex, node, ins, out, attrs, name):
    axis, keep = _reduce_common(attrs)
    a = [_attr("keepdims", 1 if keep else 0)]
    inputs = [ins[0]]
    if axis:
        inputs.append(ex.const(name + "_axes",
                               np.asarray(axis, np.int64)))
    ex.emit("ReduceSum", inputs, [out], name, a)


@translates("norm")
def _t_norm(ex, node, ins, out, attrs, name):
    ord_ = pint(attrs.get("ord"), 2)
    if ord_ not in (1, 2):
        raise MXNetError("ONNX export: norm ord=%d unsupported" % ord_)
    axis, keep = _reduce_common(attrs)
    a = [_attr("keepdims", 1 if keep else 0)]
    if axis:
        a.append(_attr("axes", axis))
    ex.emit("ReduceL1" if ord_ == 1 else "ReduceL2", ins[:1], [out],
            name, a)


@translates("argmax", "argmin")
def _t_arg(ex, node, ins, out, attrs, name):
    onnx_op = "ArgMax" if node.op == "argmax" else "ArgMin"
    i64 = name + "_i64"
    raw_axis = attrs.get("axis")
    if raw_axis in (None, "None", ""):
        # mx semantics: no axis -> argmax over the FLATTENED array
        flat = name + "_flat"
        ex.emit("Reshape", [ins[0], ex.const(name + "_m1",
                                             np.asarray([-1], np.int64))],
                [flat], name + "_flatten")
        ex.emit(onnx_op, [flat], [i64], name + "_arg",
                [_attr("axis", 0), _attr("keepdims", 0)])
    else:
        keep = pbool(attrs.get("keepdims"))
        ex.emit(onnx_op, ins[:1], [i64], name + "_arg",
                [_attr("axis", pint(raw_axis, 0)),
                 _attr("keepdims", 1 if keep else 0)])
    ex.cast_to_f32(i64, out, name)  # mx argmax returns float


@translates("FullyConnected")
def _t_fc(ex, node, ins, out, attrs, name):
    data = ins[0]
    if pbool(attrs.get("flatten"), True):
        flat = name + "_flat"
        ex.emit("Flatten", [data], [flat], name + "_flatten",
                [_attr("axis", 1)])
        data = flat
    if pbool(attrs.get("no_bias")):
        ex.emit("Gemm", [data, ins[1]], [out], name, [_attr("transB", 1)])
    else:
        ex.emit("Gemm", [data, ins[1], ins[2]], [out], name,
                [_attr("transB", 1)])


@translates("Convolution")
def _t_conv(ex, node, ins, out, attrs, name):
    ex.emit("Conv", ins[:2] if pbool(attrs.get("no_bias")) else ins,
            [out], name, _conv_attrs(attrs))


@translates("Deconvolution")
def _t_deconv(ex, node, ins, out, attrs, name):
    a = _conv_attrs(attrs)
    adj = ptuple(attrs.get("adj"), default=())
    if adj and any(adj):
        a.append(_attr("output_padding", adj))
    if attrs.get("target_shape"):
        raise MXNetError("ONNX export: Deconvolution target_shape "
                         "unsupported; use pad/adj")
    ex.emit("ConvTranspose",
            ins[:2] if pbool(attrs.get("no_bias")) else ins, [out],
            name, a)


@translates("Activation")
def _t_act(ex, node, ins, out, attrs, name):
    act = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
           "softrelu": "Softplus", "softsign": "Softsign"}[
               attrs.get("act_type", "relu")]
    ex.emit(act, ins, [out], name)


@translates("LeakyReLU")
def _t_lrelu(ex, node, ins, out, attrs, name):
    kind = attrs.get("act_type", "leaky")
    if kind == "leaky":
        ex.emit("LeakyRelu", ins[:1], [out], name,
                [_attr("alpha", pfloat(attrs.get("slope"), 0.25))])
    elif kind == "elu":
        ex.emit("Elu", ins[:1], [out], name,
                [_attr("alpha", pfloat(attrs.get("slope"), 0.25))])
    elif kind == "selu":
        ex.emit("Selu", ins[:1], [out], name)
    elif kind == "prelu":
        ex.emit("PRelu", ins[:2], [out], name)
    else:
        raise MXNetError("ONNX export: LeakyReLU act_type %r is not "
                         "expressible at opset %d" % (kind, _OPSET))


@translates("hard_sigmoid")
def _t_hsig(ex, node, ins, out, attrs, name):
    ex.emit("HardSigmoid", ins[:1], [out], name,
            [_attr("alpha", pfloat(attrs.get("alpha"), 0.2)),
             _attr("beta", pfloat(attrs.get("beta"), 0.5))])


@translates("BatchNorm")
def _t_bn(ex, node, ins, out, attrs, name):
    eps = pfloat(attrs.get("eps"), 1e-3)
    mom = pfloat(attrs.get("momentum"), 0.9)
    if pbool(attrs.get("fix_gamma"), True):
        gamma = ex.params.get(ins[1])
        if gamma is not None:
            ex.params[ins[1]] = np.ones_like(gamma)
    ex.emit("BatchNormalization", ins, [out], name,
            [_attr("epsilon", eps), _attr("momentum", mom)])


@translates("InstanceNorm")
def _t_instnorm(ex, node, ins, out, attrs, name):
    ex.emit("InstanceNormalization", ins, [out], name,
            [_attr("epsilon", pfloat(attrs.get("eps"), 1e-3))])


@translates("LRN")
def _t_lrn(ex, node, ins, out, attrs, name):
    ex.emit("LRN", ins, [out], name,
            [_attr("alpha", pfloat(attrs.get("alpha"), 1e-4)),
             _attr("beta", pfloat(attrs.get("beta"), 0.75)),
             _attr("bias", pfloat(attrs.get("knorm"), 2.0)),
             _attr("size", pint(attrs.get("nsize"), 5))])


@translates("L2Normalization")
def _t_l2norm(ex, node, ins, out, attrs, name):
    mode = attrs.get("mode", "instance")
    if mode != "channel":
        raise MXNetError("ONNX export: L2Normalization mode=%r has no "
                         "LpNormalization equivalent (channel only)"
                         % mode)
    ex.emit("LpNormalization", ins, [out], name,
            [_attr("p", 2), _attr("axis", 1)])


@translates("Pooling")
def _t_pool(ex, node, ins, out, attrs, name):
    kind = attrs.get("pool_type", "max")
    if kind not in ("max", "avg"):
        raise MXNetError("ONNX export: pool_type=%r unsupported" % kind)
    if pbool(attrs.get("global_pool")):
        ex.emit("GlobalMaxPool" if kind == "max" else
                "GlobalAveragePool", ins, [out], name)
        return
    if attrs.get("pooling_convention", "valid") == "full":
        raise MXNetError("ONNX export: pooling_convention='full' "
                         "has no ONNX equivalent")
    kernel = ptuple(attrs.get("kernel"))
    nd = len(kernel)
    stride = ptuple(attrs.get("stride"), ndim=nd, default=(1,) * nd)
    pad = ptuple(attrs.get("pad"), ndim=nd, default=(0,) * nd)
    pool_attrs = [_attr("kernel_shape", kernel),
                  _attr("strides", stride),
                  _attr("pads", pad + pad)]
    if kind != "max":
        # mx defaults count_include_pad=True; ONNX defaults 0
        pool_attrs.append(_attr(
            "count_include_pad",
            1 if pbool(attrs.get("count_include_pad"), True) else 0))
    ex.emit("MaxPool" if kind == "max" else "AveragePool", ins, [out],
            name, pool_attrs)


@translates("ROIPooling")
def _t_roipool(ex, node, ins, out, attrs, name):
    size = ptuple(attrs.get("pooled_size"))
    ex.emit("MaxRoiPool", ins, [out], name,
            [_attr("pooled_shape", size),
             _attr("spatial_scale",
                   pfloat(attrs.get("spatial_scale"), 1.0))])


@translates("Flatten")
def _t_flatten(ex, node, ins, out, attrs, name):
    ex.emit("Flatten", ins, [out], name, [_attr("axis", 1)])


@translates("softmax", "SoftmaxOutput", "log_softmax",
            "SoftmaxActivation")
def _t_softmax(ex, node, ins, out, attrs, name):
    op = node.op
    onnx_op = "LogSoftmax" if op == "log_softmax" else "Softmax"
    axis = pint(attrs.get("axis"),
                1 if op in ("SoftmaxOutput", "SoftmaxActivation") else -1)
    ex.emit(onnx_op, ins[:1], [out], name, [_attr("axis", axis)])


@translates("Concat", "concat")
def _t_concat(ex, node, ins, out, attrs, name):
    ex.emit("Concat", ins, [out], name,
            [_attr("axis", pint(attrs.get("dim"), 1))])


@translates("Dropout")
def _t_dropout(ex, node, ins, out, attrs, name):
    ex.emit("Dropout", ins, [out], name)


@translates("Reshape")
def _t_reshape(ex, node, ins, out, attrs, name):
    shape = ptuple(attrs.get("shape"))
    shp = ex.const(name + "_shape", np.asarray(shape, np.int64))
    ex.emit("Reshape", [ins[0], shp], [out], name)


@translates("transpose")
def _t_transpose(ex, node, ins, out, attrs, name):
    axes = ptuple(attrs.get("axes"), default=())
    a = [_attr("perm", axes)] if axes else []
    ex.emit("Transpose", ins, [out], name, a)


@translates("expand_dims")
def _t_expand_dims(ex, node, ins, out, attrs, name):
    ax = ex.const(name + "_axes",
                  np.asarray([pint(attrs.get("axis"), 0)], np.int64))
    ex.emit("Unsqueeze", [ins[0], ax], [out], name)


@translates("squeeze")
def _t_squeeze(ex, node, ins, out, attrs, name):
    axis = ptuple(attrs.get("axis"), default=())
    inputs = [ins[0]]
    if axis:
        inputs.append(ex.const(name + "_axes",
                               np.asarray(axis, np.int64)))
    ex.emit("Squeeze", inputs, [out], name)


@translates("slice_axis")
def _t_slice_axis(ex, node, ins, out, attrs, name):
    axis = pint(attrs.get("axis"), 0)
    begin = pint(attrs.get("begin"), 0)
    end = attrs.get("end")
    end = 2 ** 31 - 1 if end in (None, "None", "") else pint(end, 0)
    ex.emit("Slice", [
        ins[0],
        ex.const(name + "_st", np.asarray([begin], np.int64)),
        ex.const(name + "_en", np.asarray([end], np.int64)),
        ex.const(name + "_ax", np.asarray([axis], np.int64))],
        [out], name)


@translates("Crop")
def _t_crop(ex, node, ins, out, attrs, name):
    offset = ptuple(attrs.get("offset"), default=(0, 0))
    h_w = ptuple(attrs.get("h_w"), default=())
    if not h_w:
        raise MXNetError("ONNX export: Crop needs explicit h_w "
                         "(reference-style 2-input crop unsupported)")
    ex.emit("Slice", [
        ins[0],
        ex.const(name + "_st",
                 np.asarray([offset[0], offset[1]], np.int64)),
        ex.const(name + "_en",
                 np.asarray([offset[0] + h_w[0], offset[1] + h_w[1]],
                            np.int64)),
        ex.const(name + "_ax", np.asarray([2, 3], np.int64))],
        [out], name)


@translates("SliceChannel")
def _t_split(ex, node, ins, out, attrs, name):
    num = pint(attrs.get("num_outputs"), 1)
    axis = pint(attrs.get("axis"), 1)
    if pbool(attrs.get("squeeze_axis")):
        raise MXNetError("ONNX export: SliceChannel squeeze_axis=1 "
                         "unsupported (insert explicit squeeze)")
    outs = [out] + ["%s_out%d" % (name, i) for i in range(1, num)]
    ex.emit("Split", ins[:1], outs, name, [_attr("axis", axis)])


@translates("tile")
def _t_tile(ex, node, ins, out, attrs, name):
    reps = ptuple(attrs.get("reps"))
    ex.emit("Tile", [ins[0], ex.const(name + "_reps",
                                      np.asarray(reps, np.int64))],
            [out], name)


@translates("broadcast_to")
def _t_broadcast_to(ex, node, ins, out, attrs, name):
    shape = ptuple(attrs.get("shape"))
    ex.emit("Expand", [ins[0], ex.const(name + "_shape",
                                        np.asarray(shape, np.int64))],
            [out], name)


@translates("depth_to_space", "space_to_depth")
def _t_d2s(ex, node, ins, out, attrs, name):
    ex.emit("DepthToSpace" if node.op == "depth_to_space"
            else "SpaceToDepth", ins[:1], [out], name,
            [_attr("blocksize", pint(attrs.get("block_size"), 1))])


@translates("clip")
def _t_clip(ex, node, ins, out, attrs, name):
    lo = ex.const(name + "_min",
                  np.asarray(pfloat(attrs.get("a_min"), 0.0), np.float32))
    hi = ex.const(name + "_max",
                  np.asarray(pfloat(attrs.get("a_max"), 0.0), np.float32))
    ex.emit("Clip", [ins[0], lo, hi], [out], name)


@translates("Cast", "cast")
def _t_cast(ex, node, ins, out, attrs, name):
    dt = np.dtype(attrs.get("dtype", "float32"))
    to = _TP_OF_NP.get(dt)
    if to is None:
        raise MXNetError("ONNX export: Cast dtype %s unsupported" % dt)
    ex.emit("Cast", ins[:1], [out], name, [_attr("to", to)])


@translates("Pad")
def _t_pad(ex, node, ins, out, attrs, name):
    mode = attrs.get("mode", "constant")
    if mode not in ("constant", "edge", "reflect"):
        raise MXNetError("ONNX export: Pad mode %r unsupported" % mode)
    pw = ptuple(attrs.get("pad_width"))
    nd = len(pw) // 2
    # mx interleaves (before,after) per axis; ONNX wants all-befores
    # then all-afters
    befores = [pw[2 * i] for i in range(nd)]
    afters = [pw[2 * i + 1] for i in range(nd)]
    pads = ex.const(name + "_pads",
                    np.asarray(befores + afters, np.int64))
    inputs = [ins[0], pads]
    if mode == "constant":
        inputs.append(ex.const(
            name + "_cv",
            np.asarray(pfloat(attrs.get("constant_value"), 0.0),
                       np.float32)))
    ex.emit("Pad", inputs, [out], name,
            [_attr("mode", mode)])


@translates("_linalg_gemm2", "linalg_gemm2")
def _t_gemm2(ex, node, ins, out, attrs, name):
    alpha = pfloat(attrs.get("alpha"), 1.0)
    a, b = ins[0], ins[1]

    def _swap_last2(src, tag):
        # gemm2's transpose flags swap the last two axes only; a bare
        # ONNX Transpose reverses ALL axes, so the perm must be explicit
        shape = ex.shapes.get(src)
        if shape is None:
            raise MXNetError("ONNX export: linalg_gemm2 transpose needs "
                             "a known input rank for %r" % src)
        perm = list(range(len(shape)))
        perm[-2], perm[-1] = perm[-1], perm[-2]
        t = name + tag
        ex.emit("Transpose", [src], [t], name + "_T" + tag,
                [_attr("perm", perm)])
        return t

    if pbool(attrs.get("transpose_a")):
        a = _swap_last2(a, "_ta")
    if pbool(attrs.get("transpose_b")):
        b = _swap_last2(b, "_tb")
    if alpha == 1.0:
        ex.emit("MatMul", [a, b], [out], name)
    else:
        mm = name + "_mm"
        ex.emit("MatMul", [a, b], [mm], name + "_matmul")
        sc = ex.const(name + "_alpha", np.asarray(alpha, np.float32))
        ex.emit("Mul", [mm, sc], [out], name)


@translates("_random_uniform")
def _t_runiform(ex, node, ins, out, attrs, name):
    shape = ptuple(attrs.get("shape"))
    ex.emit("RandomUniform", [], [out], name,
            [_attr("low", pfloat(attrs.get("low"), 0.0)),
             _attr("high", pfloat(attrs.get("high"), 1.0)),
             _attr("shape", shape)])


@translates("_random_normal")
def _t_rnormal(ex, node, ins, out, attrs, name):
    shape = ptuple(attrs.get("shape"))
    ex.emit("RandomNormal", [], [out], name,
            [_attr("mean", pfloat(attrs.get("loc"), 0.0)),
             _attr("scale", pfloat(attrs.get("scale"), 1.0)),
             _attr("shape", shape)])


@translates("_sample_multinomial")
def _t_multinomial(ex, node, ins, out, attrs, name):
    shape = ptuple(attrs.get("shape"), default=(1,))
    n = 1
    for d in shape:
        n *= d
    if len(shape) <= 1:
        ex.emit("Multinomial", ins[:1], [out], name,
                [_attr("sample_size", n)])
        return
    # mx emits (batch,)+shape; ONNX Multinomial emits (batch, prod):
    # restore the trailing dims (Reshape dim 0 keeps the input dim)
    mn = name + "_mn"
    ex.emit("Multinomial", ins[:1], [mn], name + "_sample",
            [_attr("sample_size", n)])
    shp = ex.const(name + "_shape",
                   np.asarray((0,) + shape, np.int64))
    ex.emit("Reshape", [mn, shp], [out], name)


def _export_node(ex, node, ins, out):
    """Emit ONNX node(s) for one mx symbol node (writes into ex)."""
    fn = _TRANSLATORS.get(node.op)
    if fn is None:
        raise MXNetError("ONNX export: unsupported operator %r"
                         % node.op)
    fn(ex, node, ins, out, node.attrs, node.name)


def export_model(sym, params, input_shape, input_type=np.float32,
                 onnx_file_path="model.onnx", verbose=False):
    """Export a Symbol + params to a real .onnx protobuf file.

    ``params`` accepts plain names or the checkpoint's "arg:"/"aux:"
    prefixes.  ``input_shape`` is one shape tuple or a list of them (one
    per data input).  Returns the file path.
    """
    from ...ndarray.ndarray import NDArray

    clean = {}
    for k, v in params.items():
        k = k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) else k
        clean[k] = v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)

    nodes = sym._topo_nodes()
    out_names = {}
    # ops whose extra mx outputs are training-side (mean/var, mask) and
    # are exported as single-output ONNX nodes: references to idx > 0
    # come from the symbol layer's output fan-out and must be dropped
    _TRAIN_ONLY_EXTRA = {"BatchNorm", "Dropout"}

    def name_of(node, idx):
        if node.op is None:
            return node.name
        if idx > 0 and node.op in _TRAIN_ONLY_EXTRA:
            return None
        base = out_names[id(node)]
        return base if idx == 0 else "%s_out%d" % (base, idx)

    ex = _Exporter(clean)
    shapes = [input_shape] if isinstance(input_shape[0], int) \
        else list(input_shape)

    # best-effort shape annotation for translators that need input rank
    # (dot/linalg_gemm2 transpose perms): map every internal output name
    # to its inferred shape
    try:
        pre_data = [n.name for n in nodes
                    if n.op is None and n.name not in clean]
        ints = sym.get_internals()
        _, int_shapes, _ = ints.infer_shape(
            **{n: s for n, s in zip(pre_data, shapes)})
        for nm, shp in zip(ints.list_outputs(), int_shapes):
            key = nm[:-len("_output")] if nm.endswith("_output") else nm
            ex.shapes.setdefault(key, tuple(shp))
    except Exception:
        pass  # translators that require shapes raise their own error

    data_inputs = []
    for node in nodes:
        if node.op is None:
            if node.name in clean:
                ex.add_init(node.name, clean[node.name])
            else:
                data_inputs.append(node.name)
            continue
        out_names[id(node)] = node.name
        ins = [name_of(n, i) for (n, i) in node.inputs]
        if None in ins:
            bad = node.inputs[ins.index(None)][0]
            raise MXNetError(
                "ONNX export: %s(%s) consumes a training-internal "
                "extra output of %s (%s) — these have no inference-"
                "graph counterpart" % (node.op, node.name, bad.op,
                                       bad.name))
        _export_node(ex, node, ins, node.name)

    # re-emit initializers after fix_gamma rewrites
    inits = [_tensor(t["name"], ex.params[t["name"]])
             if t["name"] in ex.params else t for t in ex.initializers]

    # drop data inputs no emitted node consumes — loss-layer label vars
    # (SoftmaxOutput/LogisticRegressionOutput/...) exist in the symbol
    # but have no inference-graph counterpart
    referenced = {n for nd_ in ex.nodes for n in nd_["input"]}
    data_inputs = [n for n in data_inputs if n in referenced]

    if len(shapes) != len(data_inputs):
        raise MXNetError("export_model: %d input shapes for %d data "
                         "inputs %s" % (len(shapes), len(data_inputs),
                                        data_inputs))
    in_elem = _TP_OF_NP.get(np.dtype(input_type), P.TP_FLOAT)
    # ONNX requires typed graph outputs: get shapes via inference
    _, out_shapes, _ = sym.infer_shape(
        **{n: s for n, s in zip(data_inputs, shapes)})
    graph_outputs = []
    for (node, i), shape in zip(sym._entries, out_shapes):
        out_name = name_of(node, i)
        if out_name is None:
            raise MXNetError(
                "ONNX export: graph output %d is a training-internal "
                "extra output of %s (%s); export the primary output "
                "only" % (i, node.op, node.name))
        graph_outputs.append(_vinfo(out_name, shape))
    graph = {
        "name": "mxnet_tpu_exported",
        "node": ex.nodes,
        "initializer": inits,
        "input": [_vinfo(n, s, in_elem)
                  for n, s in zip(data_inputs, shapes)],
        "output": graph_outputs,
    }
    # the JAX package's producer name, so a file is byte-identical
    # whichever package wrote it
    model = {
        "ir_version": 7,
        "producer_name": "mxnet_tpu",
        "opset_import": [{"domain": "", "version": _OPSET}],
        "graph": graph,
    }
    from ...checkpoint import atomic_write

    atomic_write(onnx_file_path, P.encode(model, "ModelProto"))
    if verbose:
        print("exported %d nodes -> %s" % (len(ex.nodes), onnx_file_path))
    return onnx_file_path
