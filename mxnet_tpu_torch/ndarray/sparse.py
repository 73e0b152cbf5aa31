"""Sparse NDArrays: row_sparse and csr, component-first (parity:
mxnet_tpu/ndarray/sparse.py; reference src/ndarray kRowSparseStorage /
kCSRStorage, python/mxnet/ndarray/sparse.py).

A sparse array holds only its components, on the array's device: a
RowSparseNDArray its stored rows ``data`` (nnz_rows, *row_shape) and their
ascending ``indices``; a CSRNDArray ``data`` (nnz,), column ``indices``
(nnz,) and ``indptr`` (rows + 1,).  Nothing dense exists after
construction.  The sparse-aware functions (``retain``, ``add_rsp_rsp``,
``dot`` of a CSR with a dense array, ``scatter_op``, the row-sparse
KVStore push and ``row_sparse_pull``, SGD's lazy update) work on the
components with gathers and ``index_add_`` on the device.  Any other
operator reads ``_data``, the dense view, which is made on first use with
a ``RuntimeWarning`` so that a silent densification shows; from then on
the dense view is the array's value (it may be written in place) and the
components are derived from it again when asked for.  ``tostype`` and
``cast_storage`` convert explicitly and warn of nothing.

Indices are int64 (upstream's aux type); the JAX package's are int32,
its x64 being off.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..base import MXNetError, numeric_types, numpy_dtype, torch_dtype
from ..context import Context, current_context
from .ndarray import NDArray, array, zeros, _invoke_nd

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "zeros_sparse",
           "retain", "add_rsp_rsp", "dot", "scatter_op"]


def _tensor(x, device, dtype=None):
    """``x`` (an NDArray, tensor or array-like) as a tensor on
    ``device``."""
    if isinstance(x, NDArray):
        x = x._data if not isinstance(x, BaseSparseNDArray) \
            else x.tostype("default")._data
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device, dtype)


def _index(x, device):
    return _tensor(x, device, torch.int64).reshape(-1)


class BaseSparseNDArray(NDArray):
    """The components live in ``_aux``; the dense view ``_data`` is made
    lazily by ``_densify`` (subclasses implement it and ``_extract``)."""

    __slots__ = ("_aux", "_dense_cache", "_sshape", "_sdtype", "_stype")

    def _init_sparse(self, stype, shape, dtype, aux):
        self._grad = None
        self._grad_req = "null"
        self._producer = None
        self._stype = stype
        self._sshape = tuple(int(s) for s in shape)
        self._sdtype = dtype
        self._dense_cache = None
        self._aux = aux

    # the NDArray slot ``_data`` is shadowed: the dense array exists only
    # once something asks for it
    @property
    def _data(self):
        if self._dense_cache is None:
            warnings.warn(
                "%s densified for an operator without a sparse kernel "
                "(dense fallback)" % type(self).__name__, RuntimeWarning,
                stacklevel=3)
            self._dense_cache = self._densify()
        # whoever holds the dense view may write it in place: the
        # components are re-derived from it when next asked for
        self._aux = None
        return self._dense_cache

    @_data.setter
    def _data(self, value):
        self._dense_cache = value
        if value is not None:
            self._aux = None
            self._sshape = tuple(value.shape)
            self._sdtype = value.dtype

    def _components(self):
        if self._aux is None:
            self._aux = self._extract(self._dense_cache)
        return self._aux

    def _device(self):
        if self._aux is not None:
            return self._aux["data"]._data.device
        return self._dense_cache.device

    def _rebind(self, new_data):
        """In-place writes rebind the dense view and drop the
        components (parity: the JAX setter)."""
        if not isinstance(new_data, torch.Tensor):
            new_data = torch.as_tensor(np.asarray(new_data),
                                       device=self._device())
        self._data = new_data.detach()
        return self

    def _inplace(self, o, op_nd, op_sc, method):
        if not isinstance(o, (NDArray,) + numeric_types):
            return NotImplemented
        return self._rebind(self._binop(o, op_nd, op_sc)._data)

    def __setitem__(self, key, value):
        dense = self.tostype("default")
        dense[key] = value
        self._rebind(dense._data)

    @property
    def shape(self):
        return self._sshape

    @property
    def ndim(self):
        return len(self._sshape)

    @property
    def size(self):
        return int(np.prod(self._sshape))

    @property
    def dtype(self):
        return numpy_dtype(self._sdtype)

    @property
    def context(self):
        return Context.from_device(self._device())

    ctx = context

    @property
    def stype(self):
        return self._stype

    def asnumpy(self):
        return self.tostype("default").asnumpy()

    def tostype(self, stype):
        """This array (``stype`` its own), its dense value as an array of
        its own (``"default"``), or the other sparse type."""
        if stype == self._stype:
            return self
        if stype == "default":
            dense = self._dense_cache.clone() \
                if self._dense_cache is not None else self._densify()
            return NDArray(dense)
        return cast_storage(self, stype)

    def __repr__(self):
        return "<%s %s @%s>" % (type(self).__name__,
                                "x".join(map(str, self.shape)), self.context)


class RowSparseNDArray(BaseSparseNDArray):
    """Stored rows ``data`` (nnz_rows, *row_shape) at ascending row
    ``indices`` (nnz_rows,): memory in proportion to the stored rows."""

    def __init__(self, data, indices, shape, ctx=None):
        device = ctx.torch_device if ctx is not None else data._data.device
        vals = data._data.to(device)
        self._init_sparse("row_sparse", shape, vals.dtype, {
            "data": NDArray(vals), "indices": NDArray(_index(indices,
                                                             device))})

    def _densify(self):
        aux = self._aux
        vals = aux["data"]._data
        dense = torch.zeros(self._sshape, dtype=self._sdtype,
                            device=vals.device)
        return dense.index_copy_(0, aux["indices"]._data, vals)

    @staticmethod
    def _extract(dense):
        """The nonzero rows of ``dense``, ascending, on its device."""
        flat = dense.reshape(dense.shape[0], -1)
        nz = torch.nonzero((flat != 0).any(dim=1)).reshape(-1)
        return {"data": NDArray(dense[nz]), "indices": NDArray(nz)}

    @property
    def indices(self):
        return self._components()["indices"]

    @property
    def data(self):
        return self._components()["data"]

    def copyto(self, other):
        if isinstance(other, NDArray) and \
                not isinstance(other, BaseSparseNDArray):
            other._rebind(self.tostype("default")._data.to(
                other._data.device, other._data.dtype))
            return other
        return super().copyto(other)

    def _assign_rows(self, vals, rows, shape):
        """Make (``vals``, ``rows``) this array's components: the
        ``row_sparse_pull`` write-back."""
        self._sshape = tuple(int(s) for s in shape)
        self._sdtype = vals._data.dtype
        self._dense_cache = None
        self._aux = {"data": vals, "indices": NDArray(
            rows._data.to(torch.int64))}


class CSRNDArray(BaseSparseNDArray):
    """CSR: ``data`` (nnz,), column ``indices`` (nnz,), ``indptr``
    (rows + 1,)."""

    def __init__(self, data, indices, indptr, shape, ctx=None):
        device = ctx.torch_device if ctx is not None else data._data.device
        vals = data._data.to(device)
        self._init_sparse("csr", shape, vals.dtype, {
            "data": NDArray(vals),
            "indices": NDArray(_index(indices, device)),
            "indptr": NDArray(_index(indptr, device))})

    def _row_ids(self):
        """Each stored element's row (from indptr, kept with the
        components until they change)."""
        aux = self._components()
        if "_rows" not in aux:
            indptr = aux["indptr"]._data
            counts = indptr[1:] - indptr[:-1]
            aux["_rows"] = NDArray(torch.repeat_interleave(
                torch.arange(len(counts), device=indptr.device), counts,
                output_size=aux["data"]._data.shape[0]))
        return aux["_rows"]

    def _densify(self):
        aux = self._aux
        vals = aux["data"]._data
        rows = self._row_ids()._data
        dense = torch.zeros(self._sshape, dtype=self._sdtype,
                            device=vals.device)
        dense[rows, aux["indices"]._data] = vals
        return dense

    @staticmethod
    def _extract(dense):
        """The nonzeros of ``dense`` in row-major order, on its device."""
        rows, cols = torch.nonzero(dense, as_tuple=True)
        counts = torch.bincount(rows, minlength=dense.shape[0])
        indptr = torch.cat([torch.zeros(1, dtype=torch.int64,
                                        device=dense.device),
                            torch.cumsum(counts, 0)])
        return {"data": NDArray(dense[rows, cols]), "indices": NDArray(cols),
                "indptr": NDArray(indptr)}

    @property
    def indices(self):
        return self._components()["indices"]

    @property
    def indptr(self):
        return self._components()["indptr"]

    @property
    def data(self):
        return self._components()["data"]

    def check_format(self, full_check=True):
        """Raise MXNetError on a malformed indptr or indices (parity:
        sparse check_format); ``full_check`` also checks each row's
        columns for range and strict ascent, on the host."""
        aux = self._components()
        indptr = aux["indptr"]._data.cpu().numpy()
        indices = aux["indices"]._data.cpu().numpy()
        rows = self._sshape[0]
        if len(indptr) != rows + 1 or indptr[0] != 0:
            raise MXNetError("csr check_format: bad indptr length/start")
        if np.any(np.diff(indptr) < 0):
            raise MXNetError("csr check_format: indptr not non-decreasing")
        if int(indptr[-1]) != len(indices) or \
                len(indices) != aux["data"]._data.shape[0]:
            raise MXNetError("csr check_format: nnz mismatch")
        if full_check and len(indices):
            if indices.min() < 0 or indices.max() >= self._sshape[1]:
                raise MXNetError("csr check_format: column index out of "
                                 "range")
            # strictly ascending within each row (reference
            # src/common/utils.h csr_idx_check)
            ascending = np.diff(indices) > 0
            bound = indptr[1:-1] - 1
            bound = bound[(bound >= 0) & (bound < len(ascending))]
            ascending[bound] = True
            if not np.all(ascending):
                raise MXNetError("csr check_format: column indices must "
                                 "be strictly ascending within each row")


def _ctx_device(ctx, like=None):
    if ctx is not None:
        return ctx.torch_device
    if isinstance(like, NDArray):
        return like.context.torch_device
    return current_context().torch_device


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from (data, indices) and ``shape``, or from a
    dense array-like."""
    if isinstance(arg1, (list, tuple)) and len(arg1) == 2:
        data, indices = arg1
        device = _ctx_device(ctx, data)
        vals = array(data, ctx=Context.from_device(device), dtype=dtype)
        return RowSparseNDArray(vals, NDArray(_index(indices, device)),
                                _shape(shape))
    return cast_storage(_dense(arg1, ctx, dtype), "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from (data, indices, indptr) and ``shape``, or from a
    dense 2-D array-like."""
    if isinstance(arg1, (list, tuple)) and len(arg1) == 3:
        data, indices, indptr = arg1
        device = _ctx_device(ctx, data)
        vals = array(data, ctx=Context.from_device(device), dtype=dtype)
        return CSRNDArray(vals, NDArray(_index(indices, device)),
                          NDArray(_index(indptr, device)), _shape(shape))
    return cast_storage(_dense(arg1, ctx, dtype), "csr")


def _shape(shape):
    if shape is None:
        raise MXNetError("a sparse array made from its components needs "
                         "its shape")
    return shape


def _dense(arg1, ctx, dtype):
    if isinstance(arg1, BaseSparseNDArray):
        arg1 = arg1.tostype("default")
    if isinstance(arg1, NDArray):
        return arg1 if ctx is None and dtype is None \
            else array(arg1, ctx=ctx, dtype=dtype)
    return array(np.asarray(arg1, dtype=dtype or np.float32),
                 ctx=ctx or current_context())


def cast_storage(arr, stype):
    """``arr`` in storage ``stype`` (parity: mx.nd.cast_storage,
    src/operator/tensor/cast_storage.cc); the components are extracted on
    the array's device."""
    if stype == "default":
        if isinstance(arr, BaseSparseNDArray):
            return arr.tostype("default")
        return arr
    if isinstance(arr, BaseSparseNDArray):
        if arr.stype == stype:
            return arr
        arr = arr.tostype("default")
    dense = arr._data.detach()
    if stype == "row_sparse":
        aux = RowSparseNDArray._extract(dense)
        return RowSparseNDArray(aux["data"], aux["indices"], dense.shape)
    if stype == "csr":
        if dense.dim() != 2:
            raise MXNetError("csr requires 2-D")
        aux = CSRNDArray._extract(dense)
        return CSRNDArray(aux["data"], aux["indices"], aux["indptr"],
                          dense.shape)
    raise MXNetError("unknown stype %r" % stype)


def zeros_sparse(stype, shape, ctx=None, dtype=None):
    """An all-zero array of ``stype`` (no stored values)."""
    if stype == "default":
        return zeros(shape, ctx=ctx, dtype=dtype)
    device = _ctx_device(ctx)
    dt = torch_dtype(dtype or np.float32)
    none = NDArray(torch.zeros(0, dtype=torch.int64, device=device))
    if stype == "row_sparse":
        vals = torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=device)
        return RowSparseNDArray(NDArray(vals), none, shape)
    if stype == "csr":
        ptr = torch.zeros(int(shape[0]) + 1, dtype=torch.int64,
                          device=device)
        return CSRNDArray(NDArray(torch.zeros(0, dtype=dt, device=device)),
                          none, NDArray(ptr), shape)
    raise MXNetError("unknown stype %r" % stype)


def retain(data, indices):
    """The stored rows of ``data`` that ``indices`` lists (parity:
    mx.nd.sparse.retain), on the components."""
    if not isinstance(data, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    idx = data.indices._data
    mask = torch.isin(idx, _index(indices, idx.device))
    return RowSparseNDArray(NDArray(data.data._data[mask]),
                            NDArray(idx[mask]), data.shape)


def add_rsp_rsp(a, b):
    """``a + b`` of two RowSparseNDArrays on their components: the union
    of their rows (ascending) and each one's values added at its rows'
    positions in it."""
    ia, ib = a.indices._data, b.indices._data
    union = torch.unique(torch.cat([ia, ib.to(ia.device)]))
    va = a.data._data
    out = torch.zeros((len(union),) + tuple(a.shape[1:]), dtype=va.dtype,
                      device=va.device)
    out.index_add_(0, torch.searchsorted(union, ia), va)
    out.index_add_(0, torch.searchsorted(union, ib.to(ia.device)),
                   b.data._data.to(va.device, va.dtype))
    return RowSparseNDArray(NDArray(out), NDArray(union), a.shape)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``dot`` with CSR kernels: csr . dense and csr^T . dense are a gather
    and an ``index_add`` over the stored elements (``_csr_matmul``,
    through the op registry, so autograd records it); other storage
    types go through the dense ``dot``."""
    if isinstance(lhs, CSRNDArray) and \
            not isinstance(rhs, BaseSparseNDArray) and not transpose_b:
        out_rows = lhs.shape[1] if transpose_a else lhs.shape[0]
        return _invoke_nd(
            "_csr_matmul", [lhs.data, lhs.indices, lhs._row_ids(), rhs],
            {"out_rows": out_rows, "transpose_a": bool(transpose_a)})
    dl = lhs.tostype("default") if isinstance(lhs, BaseSparseNDArray) \
        else lhs
    dr = rhs.tostype("default") if isinstance(rhs, BaseSparseNDArray) \
        else rhs
    return _invoke_nd("dot", [dl, dr], {"transpose_a": transpose_a,
                                        "transpose_b": transpose_b})


def _register_csr_matmul():
    from ..ops.registry import register

    @register("_csr_matmul", num_inputs=4)
    def _csr_matmul(vals, cols, rows, rhs, out_rows=0, transpose_a=False,
                    **kw):
        """csr(vals, cols, rows) . rhs (or its transpose's) as a gather of
        rhs's rows and an ``index_add`` into the output's; autograd gives
        the gradients of ``vals`` and ``rhs`` (none for the integer
        ``cols``/``rows``)."""
        v = vals if rhs.dim() == 1 \
            else vals.reshape((-1,) + (1,) * (rhs.dim() - 1))
        out = torch.zeros((int(out_rows),) + tuple(rhs.shape[1:]),
                          dtype=vals.dtype, device=vals.device)
        if transpose_a:
            return out.index_add(0, cols, v * rhs[rows])
        return out.index_add(0, rows, v * rhs[cols])


_register_csr_matmul()


def scatter_op(name, arr, other=None, scalar=None):
    """Storage-preserving scatter arithmetic (reference
    elemwise_scatter_op.cc): the op applies to a sparse array's stored
    values only, its indices kept, so rows it does not store stay zero
    even under ``+ scalar``.  ``name`` is 'plus_scalar', 'minus_scalar' or
    'elemwise_div' (the latter for a row_sparse lhs: ``other`` read at its
    rows); dense inputs take the plain op."""
    if name not in ("plus_scalar", "minus_scalar", "elemwise_div"):
        raise MXNetError("scatter_op: unknown op %r" % (name,))
    if not isinstance(arr, BaseSparseNDArray):
        if name == "plus_scalar":
            return arr + scalar
        if name == "minus_scalar":
            return arr - scalar
        return arr / other
    if name == "elemwise_div":
        if isinstance(arr, RowSparseNDArray):
            rows = arr.indices._data
            denom = _tensor(other, rows.device)[rows]
            return RowSparseNDArray(NDArray(arr.data._data / denom),
                                    arr.indices, arr.shape)
        raise MXNetError("scatter_elemwise_div: CSR lhs not supported")
    delta = scalar if name == "plus_scalar" else -scalar
    if isinstance(arr, RowSparseNDArray):
        return RowSparseNDArray(NDArray(arr.data._data + delta),
                                arr.indices, arr.shape)
    return CSRNDArray(NDArray(arr.data._data + delta), arr.indices,
                      arr.indptr, arr.shape)


# ---------------------------------------------------------------------------
# the mx.nd functions that reach the sparse paths for sparse inputs (the
# registry ops, which traced graphs run, stay the dense ones)
# ---------------------------------------------------------------------------


def _square_sum_rsp(data, axis=None, keepdims=False):
    """``_square_sum`` of a RowSparseNDArray from its stored rows: the
    dense op's value, without the dense view."""
    from ..ops.utils import paxis, pbool

    vals = data.data._data
    nd_ = len(data.shape)
    ax = paxis(axis)
    dims = tuple(range(nd_)) if ax is None else tuple(
        a % nd_ for a in ((ax,) if isinstance(ax, int) else ax))
    keep = pbool(keepdims)
    sq = vals.square()
    if 0 in dims:
        return NDArray(torch.sum(sq, dim=dims, keepdim=keep))
    part = torch.sum(sq, dim=dims, keepdim=keep)
    out = torch.zeros((data.shape[0],) + tuple(part.shape[1:]),
                      dtype=part.dtype, device=part.device)
    return NDArray(out.index_copy_(0, data.indices._data, part))


def _adagrad_rsp(weight, grad, history, lr=None, epsilon=1e-7,
                 rescale_grad=1.0, clip_gradient=-1.0, wd=0.0, **kw):
    """``_sparse_adagrad_update`` with a row-sparse gradient: only its rows
    of weight and history are read or written (reference
    AdagradUpdateEx, which refuses wd)."""
    from ..ops.utils import pfloat

    if pfloat(wd, 0.0):
        raise MXNetError("sparse adagrad_update does not support wd")
    rows = grad.indices._data
    w, h = weight._data, history._data
    with torch.no_grad():
        g = grad.data._data.to(w.dtype) * pfloat(rescale_grad, 1.0)
        cg = pfloat(clip_gradient, -1.0)
        if cg > 0:
            g = torch.clamp(g, -cg, cg)
        new_h = h[rows] + g.square()
        h.index_copy_(0, rows, new_h)
        w.index_copy_(0, rows, w[rows] - pfloat(lr) * g
                      / (torch.sqrt(new_h) + pfloat(epsilon, 1e-7)))
    return weight


def nd_overrides(namespace):
    """Point the ``mx.nd`` functions of cast_storage, _sparse_retain,
    _square_sum, _sparse_adagrad_update and the three _scatter_ ops at
    the sparse paths when their first array is sparse (cast_storage
    always)."""

    def dispatch(name, sparse_fn, argc):
        dense_fn = namespace[name]

        def fn(*args, **kwargs):
            arrays = [a for a in args if isinstance(a, NDArray)]
            if len(arrays) >= argc and isinstance(
                    arrays[argc - 1], BaseSparseNDArray):
                return sparse_fn(*args, **kwargs)
            return dense_fn(*args, **kwargs)

        fn.__name__ = name
        fn.__doc__ = dense_fn.__doc__
        namespace[name] = fn

    def scalar_of(args, kwargs):
        return float(kwargs.get("scalar", args[1] if len(args) > 1 else 0.0))

    def nd_cast_storage(data, stype="default", **kw):
        return cast_storage(data, stype)

    nd_cast_storage.__name__ = "cast_storage"
    nd_cast_storage.__doc__ = cast_storage.__doc__
    namespace["cast_storage"] = nd_cast_storage
    dispatch("_sparse_retain", lambda data, indices, **kw:
             retain(data, indices), 1)
    dispatch("_square_sum", _square_sum_rsp, 1)
    dispatch("_sparse_adagrad_update", _adagrad_rsp, 2)
    dispatch("_scatter_plus_scalar", lambda *a, **k: scatter_op(
        "plus_scalar", a[0], scalar=scalar_of(a, k)), 1)
    dispatch("_scatter_minus_scalar", lambda *a, **k: scatter_op(
        "minus_scalar", a[0], scalar=scalar_of(a, k)), 1)
    dispatch("_scatter_elemwise_div", lambda lhs, rhs, **k: scatter_op(
        "elemwise_div", lhs, other=rhs), 1)
