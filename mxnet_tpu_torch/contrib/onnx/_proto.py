"""Minimal protobuf wire codec for the ONNX schema subset (the port's own
copy of mxnet_tpu/contrib/onnx/_proto.py).

The environment has no ``onnx`` package, so this module speaks the
protobuf wire format directly (varint + length-delimited fields per
https://protobuf.dev/programming-guides/encoding/) for the messages the
exporter/importer need: ModelProto, GraphProto, NodeProto,
AttributeProto, TensorProto, ValueInfoProto and friends.  Field numbers
follow onnx/onnx.proto3 (opset-era, IR version 7).  Files produced here
load in stock onnx/onnxruntime; files produced there parse here.

Messages are plain dicts; repeated fields are lists.
"""
from __future__ import annotations

import struct

# AttributeProto.type enum
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8

# TensorProto.DataType enum
TP_FLOAT, TP_UINT8, TP_INT8, TP_INT32, TP_INT64 = 1, 2, 3, 6, 7
TP_BOOL, TP_FLOAT16, TP_DOUBLE = 9, 10, 11

# field-number tables: field -> (name, kind)
# kinds: int (varint), str, bytes, float32 (fixed32), msg:<schema>,
#        rep_* for repeated; packed_int for packed varint lists
SCHEMAS = {
    "ModelProto": {
        1: ("ir_version", "int"),
        2: ("producer_name", "str"),
        3: ("producer_version", "str"),
        4: ("domain", "str"),
        5: ("model_version", "int"),
        7: ("graph", "msg:GraphProto"),
        8: ("opset_import", "rep_msg:OperatorSetIdProto"),
    },
    "OperatorSetIdProto": {
        1: ("domain", "str"),
        2: ("version", "int"),
    },
    "GraphProto": {
        1: ("node", "rep_msg:NodeProto"),
        2: ("name", "str"),
        5: ("initializer", "rep_msg:TensorProto"),
        10: ("doc_string", "str"),
        11: ("input", "rep_msg:ValueInfoProto"),
        12: ("output", "rep_msg:ValueInfoProto"),
        13: ("value_info", "rep_msg:ValueInfoProto"),
    },
    "NodeProto": {
        1: ("input", "rep_str"),
        2: ("output", "rep_str"),
        3: ("name", "str"),
        4: ("op_type", "str"),
        5: ("attribute", "rep_msg:AttributeProto"),
        7: ("domain", "str"),
    },
    "AttributeProto": {
        1: ("name", "str"),
        2: ("f", "float32"),
        3: ("i", "int"),
        4: ("s", "bytes"),
        5: ("t", "msg:TensorProto"),
        7: ("floats", "rep_float32"),
        8: ("ints", "packed_int"),
        9: ("strings", "rep_bytes"),
        20: ("type", "int"),
    },
    "TensorProto": {
        1: ("dims", "packed_int"),
        2: ("data_type", "int"),
        4: ("float_data", "rep_float32"),
        7: ("int64_data", "packed_int"),
        8: ("name", "str"),
        9: ("raw_data", "bytes"),
    },
    "ValueInfoProto": {
        1: ("name", "str"),
        2: ("type", "msg:TypeProto"),
    },
    "TypeProto": {
        1: ("tensor_type", "msg:TypeProtoTensor"),
    },
    "TypeProtoTensor": {
        1: ("elem_type", "int"),
        2: ("shape", "msg:TensorShapeProto"),
    },
    "TensorShapeProto": {
        1: ("dim", "rep_msg:Dimension"),
    },
    "Dimension": {
        1: ("dim_value", "int"),
        2: ("dim_param", "str"),
    },
}

# name -> (field, kind) reverse index, built once
_BY_NAME = {
    schema: {name: (field, kind) for field, (name, kind) in table.items()}
    for schema, table in SCHEMAS.items()
}


def _varint(n):
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf, pos):
    shift, val = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _signed64(v):
    return v - (1 << 64) if v >= (1 << 63) else v


def _tag(field, wire):
    return _varint((field << 3) | wire)


def _encode_value(kind, value):
    if kind == "int":
        return None  # handled by caller (wire 0)
    if kind in ("str", "rep_str"):
        return value.encode("utf-8")
    if kind in ("bytes", "rep_bytes"):
        return bytes(value)
    raise AssertionError(kind)


def encode(msg, schema):
    """dict -> wire bytes for the named schema."""
    table = _BY_NAME[schema]
    out = bytearray()
    for name, value in msg.items():
        if value is None:
            continue
        field, kind = table[name]
        if kind == "int":
            out += _tag(field, 0) + _varint(int(value))
        elif kind == "float32":
            out += _tag(field, 5) + struct.pack("<f", float(value))
        elif kind in ("str", "bytes"):
            payload = _encode_value(kind, value)
            out += _tag(field, 2) + _varint(len(payload)) + payload
        elif kind.startswith("msg:"):
            payload = encode(value, kind[4:])
            out += _tag(field, 2) + _varint(len(payload)) + payload
        elif kind in ("rep_str", "rep_bytes"):
            for v in value:
                payload = _encode_value(kind, v)
                out += _tag(field, 2) + _varint(len(payload)) + payload
        elif kind.startswith("rep_msg:"):
            for v in value:
                payload = encode(v, kind[8:])
                out += _tag(field, 2) + _varint(len(payload)) + payload
        elif kind == "packed_int":
            payload = b"".join(_varint(int(v)) for v in value)
            out += _tag(field, 2) + _varint(len(payload)) + payload
        elif kind == "rep_float32":
            payload = struct.pack("<%df" % len(value),
                                  *[float(v) for v in value])
            out += _tag(field, 2) + _varint(len(payload)) + payload
        else:
            raise AssertionError(kind)
    return bytes(out)


def decode(buf, schema):
    """wire bytes -> dict for the named schema (repeated fields are
    lists; unknown fields are skipped)."""
    table = SCHEMAS[schema]
    msg = {}
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            raw, pos = _read_varint(buf, pos)
            payload = raw
        elif wire == 5:
            payload = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        elif wire == 1:
            payload = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            payload = bytes(buf[pos:pos + ln])
            pos += ln
        else:
            raise ValueError("unsupported wire type %d" % wire)
        if field not in table:
            continue
        name, kind = table[field]
        if kind == "int":
            msg[name] = _signed64(payload)
        elif kind == "float32":
            msg[name] = payload if wire == 5 else \
                struct.unpack("<f", struct.pack("<I", payload))[0]
        elif kind == "str":
            msg[name] = payload.decode("utf-8")
        elif kind == "bytes":
            msg[name] = payload
        elif kind.startswith("msg:"):
            msg[name] = decode(payload, kind[4:])
        elif kind == "rep_str":
            msg.setdefault(name, []).append(payload.decode("utf-8"))
        elif kind == "rep_bytes":
            msg.setdefault(name, []).append(payload)
        elif kind.startswith("rep_msg:"):
            msg.setdefault(name, []).append(decode(payload, kind[8:]))
        elif kind == "packed_int":
            vals = msg.setdefault(name, [])
            if wire == 0:
                vals.append(_signed64(payload))
            else:
                p = 0
                while p < len(payload):
                    v, p = _read_varint(payload, p)
                    vals.append(_signed64(v))
        elif kind == "rep_float32":
            vals = msg.setdefault(name, [])
            if wire == 5:
                vals.append(payload)
            else:
                vals.extend(struct.unpack("<%df" % (len(payload) // 4),
                                          payload))
        else:
            raise AssertionError(kind)
    return msg
