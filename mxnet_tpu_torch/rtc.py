"""Runtime kernels by name (parity: mxnet_tpu/rtc.py; python/mxnet/rtc.py
and src/common/rtc.cc, where ``mx.rtc.CudaModule`` compiles CUDA C at
run time through NVRTC).

As in the JAX package, the module holds callables given as
``kernels={name: fn}``: here functions on torch tensors (the card's own
kernels, a ``torch.library`` op, or plain torch), launched on NDArrays
by ``get_kernel(name).launch(args, ...)``.  CUDA C source is refused
with ``MXNetError``, as the JAX package refuses it: compiling source at
run time is not part of the JAX package's surface.
"""
from __future__ import annotations

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["PallasModule", "CudaModule", "PallasKernel"]


class PallasKernel:
    """One kernel of a module: ``launch(args)`` calls its function on the
    arguments' tensors (NDArrays unwrapped) and wraps what it returns."""

    def __init__(self, fn, name, out_shapes=None):
        self._fn = fn
        self._name = name
        self._out_shapes = out_shapes

    def launch(self, args, ctx=None, grid_dims=None, block_dims=None,
               shared_mem=0):
        raw = [a._data if isinstance(a, NDArray) else a for a in args]
        out = self._fn(*raw)
        if isinstance(out, tuple):
            return [NDArray(o) for o in out]
        return NDArray(out)

    __call__ = launch


class PallasModule:
    """Holds kernels by name; ``get_kernel(name)`` as CudaModule's."""

    def __init__(self, source=None, options=(), exports=(), kernels=None):
        if source is not None and kernels is None:
            raise MXNetError(
                "CUDA C source compilation is not available; pass "
                "`kernels={name: fn}` (functions on torch tensors) instead "
                "(reference: src/common/rtc.cc)")
        self._kernels = dict(kernels or {})

    def get_kernel(self, name, signature=None):
        if name not in self._kernels:
            raise MXNetError("kernel %r not found" % name)
        return PallasKernel(self._kernels[name], name)


CudaModule = PallasModule
