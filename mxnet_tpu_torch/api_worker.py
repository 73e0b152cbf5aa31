"""Worker side of the C train/NDArray ABI (parity:
mxnet_tpu/api_worker.py; reference the core of ``include/mxnet/c_api.h``
/ ``src/c_api/c_api.cc``): NDArray CRUD, imperative invoke by op name,
symbol load + infer-shape, executor bind/forward/backward, the subset
that powers a cpp-package-style client that *trains*, not just
predicts.  The port's C library (its copy of ``cpp/mxtpu_api.cc``)
runs ``python -m mxnet_tpu_torch.api_worker``, as predict_worker.py's
runs that worker.  Arrays, ops and executors live on
``current_context()``, the card, unless ``MXTPU_API_CPU`` asks for the
host; ``MXTPU_WORKER_STATS`` as in predict_worker.py.

Wire protocol (little-endian, over stdin/stdout; the JAX package's,
shared framing with the predict worker):
    request  = u8 opcode | u64 payload_len | payload
    response = u8 status (0 ok, 1 error) | u64 payload_len | payload

Handles are u64 ids into per-kind tables; 0 is never issued.  Tensor
payloads are raw host-order bytes (f32 or i32), like the predict ABI.

opcodes:
     0 CLOSE        worker exits
     1 ND_CREATE    u8 dtype(0=f32,1=i32) u8 fill(0=zeros,1=ones)
                    u32 ndim u32 dims[]                  -> u64 h
     2 ND_FROMDATA  u8 dtype u32 ndim u32 dims[] raw     -> u64 h
     3 ND_TOHOST    u64 h                                -> raw bytes
     4 ND_SHAPE     u64 h                           -> u32 ndim u32 dims[]
     5 ND_FREE      u64 h                                -> ()
     6 INVOKE       u32 oplen op u32 n_in u64 h[] u32 n_attr
                    (u32 klen k u32 vlen v)*       -> u32 n_out u64 h[]
     7 SYM_FROMJSON json bytes                           -> u64 h
     8 SYM_ARGS     u64 h                     -> u32 n (u32 len str)*
     9 SYM_INFER    u64 h u32 n (u32 nlen name u32 ndim u32 dims[])*
                    -> u32 n_args (u32 ndim u32 dims[])*  [in SYM_ARGS
                       order]  u32 n_out (u32 ndim u32 dims[])*
    10 EXEC_BIND    u64 sym u32 n_args (u32 nlen name u64 h)*
                    u32 n_aux (u32 nlen name u64 h)* u8 with_grad
                    -> u64 h   (with_grad=1 allocates zero grad arrays
                       for every bound arg)
    11 EXEC_FWD     u64 h u8 is_train          -> u32 n_out u64 h[]
                    (fresh ndarray handles per call)
    12 EXEC_BWD     u64 h u32 n_heads u64 h[]  -> ()  (0 heads = loss
                    op semantics: ones_like head grads)
    13 EXEC_GRAD    u64 h u32 nlen name        -> u64 h (stable across
                    backward calls; the executor rebinds in place)
    14 SEED         u64 seed                   -> ()
    15 SYM_FREE     u64 h                      -> ()
    16 EXEC_FREE    u64 h                      -> ()
    17 ND_COPYFROM  u64 h raw                  -> ()  (SyncCopyFromCPU:
                    rebind the array's data in place, shape/dtype kept)
"""
from __future__ import annotations

import os
import struct

from . import _worker_io as _io


class _Reader:
    def __init__(self, payload):
        self.p = payload
        self.off = 0

    def u8(self):
        (v,) = struct.unpack_from("<B", self.p, self.off)
        self.off += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.p, self.off)
        self.off += 4
        return v

    def u64(self):
        (v,) = struct.unpack_from("<Q", self.p, self.off)
        self.off += 8
        return v

    def dims(self):
        nd = self.u32()
        out = struct.unpack_from("<%dI" % nd, self.p, self.off)
        self.off += 4 * nd
        return tuple(int(d) for d in out)

    def string(self):
        n = self.u32()
        s = self.p[self.off:self.off + n].decode("utf-8")
        self.off += n
        return s

    def rest(self):
        return self.p[self.off:]


def _shape_reply(shape):
    return struct.pack("<I", len(shape)) + \
        struct.pack("<%dI" % len(shape), *[int(d) for d in shape])


_DTYPES = ("float32", "int32")


class _Server:
    def __init__(self):
        from . import context

        self.ctx = context.cpu() if os.environ.get("MXTPU_API_CPU") \
            else context.current_context()
        self.nd = {}
        self.sym = {}
        self.exe = {}
        self._next = 1
        self._nd_rev = {}   # id(ndarray) -> handle (O(1) reuse lookup)

    def _new(self, table, obj):
        if table is self.nd:
            # reuse the existing handle for an object already in the
            # table (in-place-mutating ops return their input; without
            # reuse every sgd_update would leak a table entry).  ids are
            # stable here because the table holds a strong reference.
            h = self._nd_rev.get(id(obj))
            if h is not None:
                return h
        h = self._next
        self._next += 1
        table[h] = obj
        if table is self.nd:
            self._nd_rev[id(obj)] = h
        return h

    # -- ndarray -----------------------------------------------------------

    def nd_create(self, r):
        import numpy as np

        from .ndarray.ndarray import array

        dtype = _DTYPES[r.u8()]
        fill = r.u8()
        shape = r.dims()
        fn = np.ones if fill else np.zeros
        h = self._new(self.nd, array(fn(shape, dtype), ctx=self.ctx))
        return struct.pack("<Q", h)

    def nd_fromdata(self, r):
        import numpy as np

        from .ndarray.ndarray import array

        dtype = np.dtype(_DTYPES[r.u8()])
        shape = r.dims()
        data = np.frombuffer(r.rest(), dtype).reshape(shape)
        h = self._new(self.nd, array(data.copy(), ctx=self.ctx))
        return struct.pack("<Q", h)

    def nd_tohost(self, r):
        import numpy as np

        a = self.nd[r.u64()]
        out = a.asnumpy()
        if out.dtype not in (np.float32, np.int32):
            out = out.astype(np.float32)
        return np.ascontiguousarray(out).tobytes()

    def nd_shape(self, r):
        return _shape_reply(self.nd[r.u64()].shape)

    def nd_free(self, r):
        a = self.nd.pop(r.u64(), None)
        if a is not None:
            self._nd_rev.pop(id(a), None)
        return b""

    def nd_copyfrom(self, r):
        import numpy as np

        from .base import MXNetError
        from .ndarray.ndarray import array

        a = self.nd[r.u64()]
        dtype = np.dtype(a.dtype)
        raw = r.rest()
        if len(raw) != a.size * dtype.itemsize:
            raise MXNetError("copy size mismatch: array wants %d bytes, "
                             "got %d" % (a.size * dtype.itemsize,
                                         len(raw)))
        data = np.frombuffer(raw, dtype).reshape(a.shape)
        a._rebind(array(data.copy(), ctx=a.context)._data)
        return b""

    # -- imperative invoke -------------------------------------------------

    def invoke(self, r):
        from .ndarray.ndarray import _invoke_nd

        op = r.string()
        n_in = r.u32()
        ins = [self.nd[r.u64()] for _ in range(n_in)]
        attrs = {}
        for _ in range(r.u32()):
            k = r.string()
            attrs[k] = r.string()
        # registry dispatch (the c_api MXImperativeInvoke path): handles
        # mutate_inputs semantics, rng ops, and multi-output ops
        out = _invoke_nd(op, ins, attrs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        reply = struct.pack("<I", len(outs))
        for o in outs:
            reply += struct.pack("<Q", self._new(self.nd, o))
        return reply

    # -- symbol ------------------------------------------------------------

    def sym_fromjson(self, r):
        from .symbol import symbol as S

        sym = S.load_json(r.rest().decode("utf-8"))
        return struct.pack("<Q", self._new(self.sym, sym))

    def sym_args(self, r):
        names = self.sym[r.u64()].list_arguments()
        reply = struct.pack("<I", len(names))
        for n in names:
            b = n.encode("utf-8")
            reply += struct.pack("<I", len(b)) + b
        return reply

    def sym_infer(self, r):
        sym = self.sym[r.u64()]
        provided = {}
        for _ in range(r.u32()):
            name = r.string()
            provided[name] = r.dims()
        arg_shapes, out_shapes, _aux = sym.infer_shape(**provided)
        reply = struct.pack("<I", len(arg_shapes))
        for s in arg_shapes:
            reply += _shape_reply(s)
        reply += struct.pack("<I", len(out_shapes))
        for s in out_shapes:
            reply += _shape_reply(s)
        return reply

    def sym_free(self, r):
        self.sym.pop(r.u64(), None)
        return b""

    # -- executor ----------------------------------------------------------

    def exec_bind(self, r):
        import numpy as np

        from .ndarray.ndarray import array

        sym = self.sym[r.u64()]
        args = {}
        for _ in range(r.u32()):
            name = r.string()
            args[name] = self.nd[r.u64()]
        aux = {}
        for _ in range(r.u32()):
            name = r.string()
            aux[name] = self.nd[r.u64()]
        with_grad = r.u8()
        grads = {n: array(np.zeros(a.shape, np.float32), ctx=self.ctx)
                 for n, a in args.items()} if with_grad else None
        exe = sym.bind(self.ctx, args=args, args_grad=grads,
                       grad_req="write" if with_grad else "null",
                       aux_states=aux or None)
        return struct.pack("<Q", self._new(self.exe, exe))

    def exec_fwd(self, r):
        exe = self.exe[r.u64()]
        is_train = bool(r.u8())
        outs = exe.forward(is_train=is_train)
        reply = struct.pack("<I", len(outs))
        for o in outs:
            reply += struct.pack("<Q", self._new(self.nd, o))
        return reply

    def exec_bwd(self, r):
        exe = self.exe[r.u64()]
        n = r.u32()
        heads = [self.nd[r.u64()] for _ in range(n)]
        exe.backward(heads or None)
        return b""

    def exec_grad(self, r):
        exe = self.exe[r.u64()]
        name = r.string()
        g = exe.grad_dict.get(name)
        if g is None:
            from .base import MXNetError

            raise MXNetError("no gradient bound for %r" % name)
        # the executor rebinds this NDArray in place on every backward,
        # so one handle stays valid for the whole training run (_new
        # reuses the existing handle if the array is already tabled)
        return struct.pack("<Q", self._new(self.nd, g))

    def exec_free(self, r):
        self.exe.pop(r.u64(), None)
        return b""

    # -- misc --------------------------------------------------------------

    def seed(self, r):
        from . import random as _random

        _random.seed(r.u64())
        return b""


def main():
    srv = _Server()
    ops = {1: srv.nd_create, 2: srv.nd_fromdata, 3: srv.nd_tohost,
           4: srv.nd_shape, 5: srv.nd_free, 6: srv.invoke,
           7: srv.sym_fromjson, 8: srv.sym_args, 9: srv.sym_infer,
           10: srv.exec_bind, 11: srv.exec_fwd, 12: srv.exec_bwd,
           13: srv.exec_grad, 14: srv.seed, 15: srv.sym_free,
           16: srv.exec_free, 17: srv.nd_copyfrom}
    # ops with no array input (and the arrays they make) land on the
    # worker's context
    with srv.ctx:
        _io.serve("api", ops, _Reader)


if __name__ == "__main__":
    main()
