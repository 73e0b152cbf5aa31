"""Worker side of the C predict ABI (parity: mxnet_tpu/predict_worker.py;
reference src/c_api/c_predict_api.cc / include/mxnet/c_predict_api.h).

The port's C library (its copy of ``cpp/mxtpu_predict.cc``, built by
``native.capi_library()``) runs ``python -m mxnet_tpu_torch.predict_worker``
(``MXTPU_PYTHON`` names the interpreter) and drives it over a pipe, so a
host app links no libpython.  The worker binds the exported symbol-json
+ params on ``current_context()``, the card, unless ``MXTPU_PREDICT_CPU``
asks for the host, and runs the bound graph eagerly under
``inference_mode`` through ``serving.symbol_function``, the binding that
``serving.Predictor.from_symbol`` runs: its outputs are then bit-equal
to the in-process Predictor's, and a worker compiles nothing.  It
installs no dtype-policy scope, so it computes in f32 as the Predictor
does with the policy that it pins for a gated int8 artifact.

Wire protocol (little-endian, over stdin/stdout; the JAX package's):
    request  = u8 opcode | u64 payload_len | payload
    response = u8 status (0 ok, 1 error) | u64 payload_len | payload
opcodes:
    1 CREATE   payload: u64 json_len, json, u64 params_len, params
               (reference .params binary), u32 n_inputs, then per input
               u32 name_len, name, u32 ndim, u32 dims[ndim]
               reply: u32 n_outputs, then per output u32 ndim,
               u32 dims[ndim]
    2 SETINPUT payload: u32 name_len, name, f32 data[] (row-major,
               shape fixed at CREATE)
    3 FORWARD  no payload; reply empty
    4 GETOUT   payload: u32 index; reply f32 data[]
    5 RELOAD   payload: u64 params_len, params — hot-swap weights
    0 CLOSE    worker exits

With ``MXTPU_WORKER_STATS`` naming a file, the worker appends one JSON
line there when it exits: the hand-written kernels' launches in this
process and the milliseconds each opcode took in the worker.
"""
from __future__ import annotations

import os
import struct
import tempfile

from . import _worker_io as _io
from .base import MXNetError


class _Server:
    def __init__(self):
        self.run = None
        self.input_names = []
        self.input_shapes = {}
        self.arg_arrays = {}
        self.aux_arrays = {}
        self.outputs = None
        from . import context

        self.ctx = context.cpu() if os.environ.get("MXTPU_PREDICT_CPU") \
            else context.current_context()

    # -- opcodes -----------------------------------------------------------

    def _load_params(self, params_bytes):
        from .ndarray import ndarray as nd_mod

        with tempfile.NamedTemporaryFile(suffix=".params",
                                         delete=False) as f:
            f.write(params_bytes)
            path = f.name
        try:
            # content-sniffing loader: reference binary OR npz
            loaded = nd_mod.load(path, ctx=self.ctx)
        finally:
            os.unlink(path)
        if not isinstance(loaded, dict):
            loaded = {"arg:%d" % i: a for i, a in enumerate(loaded)}
        arg, aux = {}, {}
        for name, arr in loaded.items():
            if name.startswith("arg:"):
                arg[name[4:]] = arr
            elif name.startswith("aux:"):
                aux[name[4:]] = arr
            else:
                arg[name] = arr
        return arg, aux

    def create(self, payload):
        import numpy as np

        from . import serving
        from .ndarray.ndarray import array
        from .symbol import symbol as S

        off = 0
        (jlen,) = struct.unpack_from("<Q", payload, off)
        off += 8
        sym = S.load_json(payload[off:off + jlen].decode("utf-8"))
        off += jlen
        (plen,) = struct.unpack_from("<Q", payload, off)
        off += 8
        arg_p, aux_p = self._load_params(payload[off:off + plen])
        off += plen
        (n_in,) = struct.unpack_from("<I", payload, off)
        off += 4
        self.input_names, self.input_shapes = [], {}
        for _ in range(n_in):
            (nlen,) = struct.unpack_from("<I", payload, off)
            off += 4
            name = payload[off:off + nlen].decode("utf-8")
            off += nlen
            (ndim,) = struct.unpack_from("<I", payload, off)
            off += 4
            dims = struct.unpack_from("<%dI" % ndim, payload, off)
            off += 4 * ndim
            self.input_names.append(name)
            self.input_shapes[name] = tuple(int(d) for d in dims)

        args = dict(arg_p)
        for name in self.input_names:
            args[name] = array(np.zeros(self.input_shapes[name],
                                        np.float32), ctx=self.ctx)
        arg_names = sym.list_arguments()
        aux_names = set(sym.list_auxiliary_states())
        missing = [n for n in arg_names if n not in args]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        self.arg_arrays = {k: v for k, v in args.items() if k in arg_names}
        self.aux_arrays = {k: v for k, v in aux_p.items() if k in aux_names}
        self.run, _ = serving.symbol_function(sym)
        # probe output shapes with one forward
        self.forward(b"")
        reply = struct.pack("<I", len(self.outputs))
        for o in self.outputs:
            reply += struct.pack("<I", len(o.shape))
            reply += struct.pack("<%dI" % len(o.shape),
                                 *[int(d) for d in o.shape])
        return reply

    def set_input(self, payload):
        import numpy as np
        import torch

        (nlen,) = struct.unpack_from("<I", payload, 0)
        name = payload[4:4 + nlen].decode("utf-8")
        shape = self.input_shapes[name]
        data = np.frombuffer(payload, np.float32,
                             offset=4 + nlen).reshape(shape)
        self.arg_arrays[name]._rebind(
            torch.from_numpy(data.copy()).to(self.ctx.torch_device))
        return b""

    def forward(self, payload):
        import torch

        from .ndarray.ndarray import NDArray

        values = {n: a._data for n, a in self.arg_arrays.items()}
        values.update({n: a._data for n, a in self.aux_arrays.items()})
        with torch.inference_mode():
            outs = self.run(values, self.ctx.torch_device)
        self.outputs = [NDArray(o) for o in outs]
        return b""

    def get_output(self, payload):
        import numpy as np

        (idx,) = struct.unpack_from("<I", payload, 0)
        return np.ascontiguousarray(
            self.outputs[idx].asnumpy().astype(np.float32)).tobytes()

    def reload_params(self, payload):
        (plen,) = struct.unpack_from("<Q", payload, 0)
        arg_p, aux_p = self._load_params(payload[8:8 + plen])
        for k, v in arg_p.items():
            if k in self.arg_arrays and k not in self.input_names:
                self.arg_arrays[k]._rebind(v._data)
        # aux states (BatchNorm running stats) hot-swap with the weights
        for k, v in aux_p.items():
            if k in self.aux_arrays:
                self.aux_arrays[k]._rebind(v._data)
        return b""


def main():
    srv = _Server()
    with srv.ctx:
        _io.serve("predict", {1: srv.create, 2: srv.set_input,
                              3: srv.forward, 4: srv.get_output,
                              5: srv.reload_params})


if __name__ == "__main__":
    main()
