"""``mx.nd.contrib`` (parity: mxnet_tpu/contrib/ndarray.py; the
reference's generated mx.nd.contrib namespace): each ``_contrib_*``
registry op under its short and its full name, the control-flow
functions foreach, while_loop and cond, the DGL graph ops (host-side, see
ops/dgl_graph.py) and ``rand_zipfian``."""
import math

import numpy as np
import torch

from ..ndarray.ndarray import NDArray, _invoke_nd as _inv, array
from ..ops.registry import list_ops as _list_ops
from ..ops.control_flow import foreach, while_loop, cond  # noqa: F401
from ..ops.dgl_graph import (  # noqa: F401
    dgl_csr_neighbor_uniform_sample, dgl_csr_neighbor_non_uniform_sample,
    dgl_subgraph, dgl_graph_compact, dgl_adjacency, edge_id)


def _make(name):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        return _inv(name, list(args), kwargs, out=out)

    fn.__name__ = name
    return fn


for _op in _list_ops():
    if _op.startswith("_contrib_"):
        globals()[_op[len("_contrib_"):]] = _make(_op)
        globals()[_op] = _make(_op)
del _op

isnan = _make("isnan")
isinf = _make("isinf")
isfinite = _make("isfinite")


def rand_zipfian(true_classes, num_sampled, range_max, ctx=None):
    """``num_sampled`` draws with replacement from the approximately
    log-uniform (Zipfian) distribution P(k) = (log(k + 2) - log(k + 1)) /
    log(range_max + 1), with the expected counts of the true and of the
    sampled classes (reference python/mxnet/ndarray/contrib.py:36, for
    sampled softmax).  The uniforms come from ``ctx``'s generator (default:
    the current context, or ``true_classes``'s), so ``mx.random.seed``
    governs the draw; the arrays are on ``ctx``."""
    from .. import random as _random
    from ..context import current_context

    if ctx is None:
        ctx = true_classes.context if isinstance(true_classes, NDArray) \
            else current_context()
    device = ctx.torch_device
    log_range = math.log(range_max + 1)
    u = torch.rand(num_sampled, generator=_random.generator(device),
                   device=device).cpu().numpy().astype(np.float64)
    sampled = (np.exp(u * log_range).astype(np.int64) - 1) % range_max
    true_np = (true_classes.asnumpy() if isinstance(true_classes, NDArray)
               else np.asarray(true_classes)).astype(np.float64)
    exp_true = np.log((true_np + 2.0) / (true_np + 1.0)) \
        / log_range * num_sampled
    s64 = sampled.astype(np.float64)
    exp_sampled = np.log((s64 + 2.0) / (s64 + 1.0)) \
        / log_range * num_sampled
    return (array(sampled.astype(np.int32), ctx=ctx),
            array(exp_true.astype(np.float32), ctx=ctx),
            array(exp_sampled.astype(np.float32), ctx=ctx))
