"""INT8 quantization (parity: mxnet_tpu/contrib/quantization.py; the
reference's python/mxnet/contrib/quantization.py: calibration by layer-
output collection :127, KL-divergence thresholds :346, quantize_model
:422; src/operator/quantization/).

``quantize_model`` rewrites each eligible FullyConnected / Convolution
of a symbol onto the int8 ops of ``ops/quantization.py``:
``quantize_v2`` of the activations (a dynamic per-batch range inside the
graph), the int8 x int8 -> int32 layer (``kernels/int8_conv.cu`` on the
card) and ``dequantize_int32``, the weights stored as int8 params and
their range scalars.  The calibration machinery (min/max, KL thresholds,
``LayerOutputCollector``) and the gated serving artifact
(``quantize_serving_artifact``, ``save_artifact``, ``load_artifact``,
``check_artifact``) are the JAX package's, on the port's symbol,
executor, ``model`` and ``checkpoint``.  The arrays that
``quantize_model`` and the gate make live on the context of the
parameters they come from.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array, _invoke_nd

__all__ = ["quantize", "dequantize", "quantize_v2", "requantize",
           "calib_thresholds_kl", "quantize_model", "LayerOutputCollector",
           "quantize_net", "QuantizationGateError", "topk_agreement",
           "quantize_serving_artifact", "save_artifact", "load_artifact",
           "check_artifact", "ARTIFACT_META", "ARTIFACT_PREFIX"]


def quantize(data, min_range, max_range, out_type="int8"):
    return _invoke_nd("_contrib_quantize", [data, min_range, max_range],
                      {"out_type": out_type})


def quantize_v2(data, **kwargs):
    return _invoke_nd("_contrib_quantize_v2", [data], kwargs)


def dequantize(data, min_range, max_range, out_type="float32"):
    return _invoke_nd("_contrib_dequantize", [data, min_range, max_range],
                      {"out_type": out_type})


def requantize(data, min_range, max_range, **kwargs):
    return _invoke_nd("_contrib_requantize", [data, min_range, max_range],
                      kwargs)


def calib_thresholds_kl(hist_data, num_bins=8001, num_quantized_bins=255,
                        layer=None):
    """KL-divergence-optimal threshold (reference: quantization.py:346
    _get_optimal_threshold).

    Empty, constant-zero, or non-finite calibration data has no defined
    KL threshold; instead of a div-by-zero/NaN threshold silently
    poisoning the quantized graph, a typed :class:`MXNetError` naming
    the offending ``layer`` is raised — the calibration run (not the
    serving rollout) is where this must surface."""
    who = " for layer %r" % layer if layer else ""
    data = np.abs(np.asarray(hist_data, dtype=np.float64).ravel())
    if data.size == 0:
        raise MXNetError(
            "calib_thresholds_kl: empty calibration data%s — the "
            "collector recorded no forward-pass outputs (did the "
            "calibration batches run, and does include_layer match?)"
            % who)
    max_val = data.max()
    if not np.isfinite(max_val):
        raise MXNetError(
            "calib_thresholds_kl: non-finite calibration data%s — the "
            "calibration batch is poisoned (NaN/Inf activations); "
            "refusing to derive int8 thresholds from it" % who)
    if max_val == 0:
        raise MXNetError(
            "calib_thresholds_kl: constant-zero calibration data%s — "
            "the KL threshold is undefined (all-zero histogram); check "
            "the calibration batch actually excites this layer" % who)
    hist, edges = np.histogram(data, bins=num_bins, range=(0, max_val))
    thresholds = np.zeros(num_bins // 2)
    divergences = np.full(num_bins // 2, np.inf)
    for i in range(num_quantized_bins // 2, num_bins // 2):
        idx = i - num_quantized_bins // 2
        p = hist[:i].astype(np.float64).copy()
        p[-1] += hist[i:].sum()
        thresholds[idx] = edges[i]
        num_merged = max(i // num_quantized_bins, 1)
        q = np.zeros(i)
        for j in range(num_quantized_bins):
            start = j * num_merged
            stop = min((j + 1) * num_merged, i) if j != num_quantized_bins - 1 else i
            seg = p[start:stop]
            nz = (seg != 0).sum()
            if nz:
                q[start:stop] = np.where(seg != 0, seg.sum() / nz, 0)
        p_sum, q_sum = p.sum(), q.sum()
        if p_sum == 0 or q_sum == 0:
            continue
        pn, qn = p / p_sum, q / q_sum
        mask = (pn != 0) & (qn != 0)
        divergences[idx] = np.sum(pn[mask] * np.log(pn[mask] / qn[mask]))
    best = np.argmin(divergences)
    return float(thresholds[best]) if np.isfinite(divergences[best]) \
        else float(max_val)


class LayerOutputCollector:
    """Collect per-layer outputs during calibration forward passes
    (reference: _LayerOutputCollector:127)."""

    def __init__(self, include_layer=None):
        self.include_layer = include_layer
        self.min_max = {}
        self.samples = {}

    def collect(self, name, arr):
        if self.include_layer is not None and not self.include_layer(name):
            return
        npv = arr.asnumpy() if isinstance(arr, NDArray) else np.asarray(arr)
        mn, mx = float(npv.min()), float(npv.max())
        if name in self.min_max:
            omn, omx = self.min_max[name]
            self.min_max[name] = (min(mn, omn), max(mx, omx))
        else:
            self.min_max[name] = (mn, mx)
        self.samples.setdefault(name, []).append(np.abs(npv).ravel()[:4096])

    def thresholds_kl(self, num_bins=8001, num_quantized_bins=255):
        """Per-layer KL thresholds over everything collected.  Raises a
        typed :class:`MXNetError` NAMING THE LAYER on empty/constant/
        non-finite samples (see :func:`calib_thresholds_kl`) — and on a
        collector that saw no layers at all."""
        if not self.samples:
            raise MXNetError(
                "LayerOutputCollector.thresholds_kl: no layer outputs "
                "collected — run the calibration forward passes first")
        return {name: calib_thresholds_kl(
                    np.concatenate(chunks), num_bins=num_bins,
                    num_quantized_bins=num_quantized_bins, layer=name)
                for name, chunks in self.samples.items()}


_QUANTIZABLE = ("FullyConnected", "Convolution")


def _eligible_nodes(sym, excluded):
    """Quantizable nodes: op type matches, not excluded, weight input is
    a plain variable that no other node consumes (shared or computed
    weights stay fp32 — their producing subgraph must survive)."""
    nodes = sym._topo_nodes()
    var_consumers = {}
    for node in nodes:
        if node.op is None:
            continue
        for (n, _i) in node.inputs:
            if n.op is None:
                var_consumers.setdefault(id(n), set()).add(id(node))
    eligible = set()
    for node in nodes:
        if node.op not in _QUANTIZABLE or node.name in excluded:
            continue
        w_node, _ = node.inputs[1]
        if w_node.op is None and \
                var_consumers.get(id(w_node)) == {id(node)}:
            eligible.add(id(node))
    return eligible


def _quantize_symbol(sym, eligible):
    """Graph rewrite (reference: quantize_graph_pass.cc): every eligible
    FullyConnected/Convolution becomes

        quantize_v2(x) -> int8 kernel (int32 accum) -> dequantize_int32
        [-> broadcast bias add in fp32]

    so the matmul/conv really executes in int8 on the MXU.  Runs on the
    shared graph-rewrite engine (symbol/fusion.py), the same pass
    infrastructure as BN folding and conv+BN+ReLU fusion."""
    from ..symbol import symbol as S
    from ..symbol.fusion import rewrite_graph

    def emit(node, ins, _sub):
        if id(node) in eligible:
            return _emit_quantized(S, node, ins)
        return None

    return rewrite_graph(sym, emit)


def _emit_quantized(S, node, ins):
    data_s = ins[0]
    bias_s = ins[2] if len(ins) > 2 else None
    qd = S._invoke_sym("_contrib_quantize_v2", [data_s], {},
                       name=node.name + "_data_quantize")
    wq = S.var(node.name + "_weight_quantized")
    wmin = S.var(node.name + "_weight_min")
    wmax = S.var(node.name + "_weight_max")
    qop = ("_contrib_quantized_fully_connected"
           if node.op == "FullyConnected" else "_contrib_quantized_conv")
    attrs = {k: v for k, v in node.attrs.items()
             if k not in ("no_bias",)}
    q = S._invoke_sym(qop, [qd[0], wq, qd[1], qd[2], wmin, wmax], attrs,
                      name=node.name + "_quantized")
    out = S._invoke_sym("_contrib_dequantize_int32", [q[0], q[1], q[2]],
                        {}, name=node.name + "_dequantize")
    if bias_s is not None:
        if node.op == "Convolution":
            from ..ops.utils import ptuple

            kernel_nd = len(ptuple(node.attrs.get("kernel"), default=(1, 1)))
            bias_s = S._invoke_sym(
                "Reshape", [bias_s],
                {"shape": (1, -1) + (1,) * kernel_nd},
                name=node.name + "_bias_reshape")
        out = S._invoke_sym("broadcast_add", [out, bias_s], {},
                            name=node.name + "_bias_add")
    return out


def _quantized_layer_weights(sym, eligible):
    """Map weight-param name -> quantized layer name for eligible nodes."""
    out = {}
    for node in sym._topo_nodes():
        if id(node) in eligible:
            w_node, _ = node.inputs[1]
            out[w_node.name] = node.name
    return out


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   ctx=None, excluded_sym_names=None, calib_mode="naive",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", logger=None):
    """Quantize a symbolic model (reference: quantize_model:422).

    Returns (quantized symbol, quantized arg_params, aux_params): the
    symbol is graph-rewritten so eligible layers compute in real int8
    (int32 accumulation), and each quantized layer's weight param is
    replaced by ``<layer>_weight_quantized`` (int8) plus
    ``<layer>_weight_min`` / ``_max`` range scalars.  Activations use
    dynamic per-batch ranges via quantize_v2 inside the graph.
    """
    if quantized_dtype not in ("int8", "auto"):
        raise MXNetError("quantized_dtype %r unsupported (int8 only)"
                         % quantized_dtype)
    excluded = set(excluded_sym_names or [])
    eligible = _eligible_nodes(sym, excluded)
    qsym = _quantize_symbol(sym, eligible)
    wmap = _quantized_layer_weights(sym, eligible)
    qarg_params = {}
    for name, arr in arg_params.items():
        layer = wmap.get(name)
        if layer is None:
            qarg_params[name] = arr
            continue
        npv = arr.asnumpy()
        r = float(np.abs(npv).max()) or 1e-8
        q = np.clip(np.rint(npv * (127.0 / r)), -127, 127) \
            .astype(np.int8)
        where = ctx or arr.context
        qarg_params[layer + "_weight_quantized"] = array(q, ctx=where)
        qarg_params[layer + "_weight_min"] = array(
            np.array(-r, np.float32), ctx=where)
        qarg_params[layer + "_weight_max"] = array(
            np.array(r, np.float32), ctx=where)
    return qsym, qarg_params, dict(aux_params)


def quantize_net(net, calib_data=None, quantized_dtype="int8", **kwargs):
    """Quantize a gluon net in place (weights -> fake-int8)."""
    for _name, p in net.collect_params().items():
        if not p.name.endswith("weight") or p._data is None:
            continue
        npv = p.data().asnumpy()
        r = float(np.abs(npv).max()) or 1e-8
        scale = 127.0 / r
        q = np.clip(np.rint(npv * scale), -127, 127).astype(np.int8)
        p.set_data(array(q.astype(np.float32) / scale,
                         ctx=p.data().context))
    return net


ARTIFACT_META = "meta.json"
ARTIFACT_PREFIX = "model"


class QuantizationGateError(MXNetError):
    """The measured int8 accuracy delta (or a poisoned calibration
    batch) failed the gate — no artifact may be emitted."""


def _params_context(arg_params):
    """The context of the first NDArray among ``arg_params`` (the current
    context when there is none)."""
    from ..context import current_context

    for a in arg_params.values():
        if isinstance(a, NDArray):
            return a.context
    return current_context()


def _forward_symbol(sym, arg_params, aux_params, batch, data_name="data"):
    """One inference forward of ``sym`` over ``batch`` with explicit
    args (quantized graphs carry int8 weights + range scalars whose
    shapes data-only inference cannot derive), on the parameters'
    context.  The graph's function runs eagerly: the gate runs each
    graph once, and a compiled Executor would spend an inductor compile
    (minutes for ResNet-50 on the card) on that one forward."""
    import torch

    ctx = _params_context(arg_params)
    values = {}
    for src in (arg_params, aux_params or {}):
        for n, a in src.items():
            a = a if isinstance(a, NDArray) else array(np.asarray(a), ctx=ctx)
            values[n] = a._data.to(ctx.torch_device)
    values[data_name] = array(np.asarray(batch), ctx=ctx)._data
    fn, _, _ = sym._build_fn()
    # no dtype-policy scope: the gate measures the fp32 model of record
    # and the int8 graph EXACTLY as stored — an ambient policy would
    # re-cast the baseline weights (and the int8 range scalars) and
    # validate numerics nobody will serve
    with torch.inference_mode():
        outs, _ = fn(values, is_train=False, device=ctx.torch_device)
    return outs[0].cpu().numpy()


def topk_agreement(ref_logits, test_logits, k):
    """Mean per-row overlap fraction of the top-``k`` index sets — the
    gate's accuracy-of-record proxy: how much of the fp32 top-k does
    the int8 graph preserve."""
    ref = np.asarray(ref_logits)
    test = np.asarray(test_logits)
    k = min(int(k), ref.shape[-1])
    ref_top = np.argsort(-ref, axis=-1)[..., :k]
    test_top = np.argsort(-test, axis=-1)[..., :k]
    hits = [len(set(r.tolist()) & set(t.tolist())) / float(k)
            for r, t in zip(ref_top.reshape(-1, k),
                            test_top.reshape(-1, k))]
    return float(np.mean(hits))


def quantize_serving_artifact(sym, arg_params, aux_params, calib_batch,
                              data_name="data", excluded_sym_names=None,
                              topk=None, max_delta=None, fold_bn=True,
                              logger=None):
    """The production int8 pipeline: fp32 symbol -> (BN fold) -> int8
    graph rewrite -> measured accuracy gate.

    The ``calib_batch`` is the recorded batch of record: the fp32
    model's top-k on it is the accuracy baseline, and the int8 graph's
    top-k agreement against it is the measured delta.  Raises
    :class:`QuantizationGateError` — and returns nothing — when the
    calibration batch is poisoned (non-finite), the int8 outputs are
    non-finite, or the measured delta exceeds ``max_delta``
    (``MXNET_QUANTIZE_MAX_DELTA`` default): a degraded artifact must
    never be emitted.

    Returns ``(qsym, qarg_params, qaux_params, report)``.
    """
    from .. import config as _config

    log = logger or (lambda *a: None)
    topk = int(topk if topk is not None
               else _config.get("MXNET_QUANTIZE_TOPK"))
    max_delta = float(max_delta if max_delta is not None
                      else _config.get("MXNET_QUANTIZE_MAX_DELTA"))
    calib = np.asarray(calib_batch)
    if calib.size == 0:
        raise QuantizationGateError(
            "quantization gate: empty calibration batch — record a "
            "real serving batch first")
    if np.issubdtype(calib.dtype, np.floating) and \
            not np.all(np.isfinite(calib)):
        raise QuantizationGateError(
            "quantization gate: poisoned calibration batch (NaN/Inf "
            "values) — refusing to calibrate or emit an artifact")
    fp32_out = _forward_symbol(sym, arg_params, aux_params, calib,
                               data_name)
    if not np.all(np.isfinite(fp32_out)):
        raise QuantizationGateError(
            "quantization gate: fp32 model of record produces "
            "non-finite outputs on the calibration batch — fix the "
            "model/batch before quantizing")
    qsrc_sym, qsrc_args, qsrc_aux = sym, dict(arg_params), \
        dict(aux_params or {})
    if fold_bn and qsrc_aux:
        from ..symbol.fusion import fold_batchnorm

        qsrc_sym, qsrc_args, qsrc_aux = fold_batchnorm(
            qsrc_sym, qsrc_args, qsrc_aux)
        log("folded BatchNorm into producer weights "
            "(%d aux entries remain)" % len(qsrc_aux))
    qsym, qargs, qaux = quantize_model(
        qsrc_sym, qsrc_args, qsrc_aux,
        excluded_sym_names=excluded_sym_names, calib_mode="none")
    n_q = sum(1 for n in qargs if n.endswith("_weight_quantized"))
    if n_q == 0:
        raise QuantizationGateError(
            "quantization gate: no eligible layer was quantized "
            "(every FullyConnected/Convolution excluded or shared) — "
            "an 'int8 artifact' that is all-fp32 would be a lie")
    int8_out = _forward_symbol(qsym, qargs, qaux, calib, data_name)
    if not np.all(np.isfinite(int8_out)):
        raise QuantizationGateError(
            "quantization gate: int8 graph produces non-finite outputs "
            "on the calibration batch — calibration is unusable")
    agreement = topk_agreement(fp32_out, int8_out, topk)
    delta = 1.0 - agreement
    report = {
        "dtype_policy": "int8",
        "topk": topk,
        "max_delta": max_delta,
        "agreement": round(agreement, 6),
        "delta": round(delta, 6),
        "calib_rows": int(calib.shape[0]),
        "calib_sha256": hashlib.sha256(
            np.ascontiguousarray(calib).tobytes()).hexdigest(),
        "quantized_layers": n_q,
        "data_name": data_name,
        "data_shape": [int(d) for d in calib.shape],
        "data_dtype": str(calib.dtype),
        "bn_folded": bool(fold_bn and aux_params),
    }
    if delta > max_delta:
        raise QuantizationGateError(
            "quantization gate REFUSED: measured top-%d accuracy delta "
            "%.4f exceeds the %.4f threshold (agreement %.4f on %d "
            "calibration rows) — the int8 artifact would degrade "
            "accuracy of record" % (topk, delta, max_delta, agreement,
                                    calib.shape[0]))
    log("gate passed: top-%d agreement %.4f (delta %.4f <= %.4f), "
        "%d int8 layers" % (topk, agreement, delta, max_delta, n_q))
    return qsym, qargs, qaux, report


def save_artifact(out_dir, qsym, qarg_params, qaux_params, report):
    """Persist one gated int8 serving artifact: symbol json + params
    blob (``model.save_checkpoint``, atomic) and — LAST, as the commit
    point — ``meta.json`` carrying the gate report and the
    ``dtype_policy: int8`` tag the serving/prewarm layers key on."""
    import datetime

    from .. import model as _model
    from ..checkpoint import atomic_write

    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, ARTIFACT_PREFIX)
    _model.save_checkpoint(prefix, 0, qsym, qarg_params,
                           qaux_params or {})
    meta = dict(report)
    meta.setdefault("dtype_policy", "int8")
    meta["created"] = datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")
    atomic_write(os.path.join(out_dir, ARTIFACT_META),
                 json.dumps(meta, indent=2, sort_keys=True).encode())
    return out_dir


def load_artifact(art_dir):
    """Load a quantized serving artifact -> ``(qsym, qarg_params,
    qaux_params, meta)``; raises MXNetError on a missing/torn artifact
    (meta.json is the commit point — no meta, no artifact)."""
    from .. import model as _model

    meta_path = os.path.join(art_dir, ARTIFACT_META)
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except OSError as e:
        raise MXNetError("quantized artifact %s: no %s (%s) — the "
                         "artifact was never committed" %
                         (art_dir, ARTIFACT_META, e))
    except ValueError as e:
        raise MXNetError("quantized artifact %s: malformed %s (%s)"
                         % (art_dir, ARTIFACT_META, e))
    qsym, qargs, qaux = _model.load_checkpoint(
        os.path.join(art_dir, ARTIFACT_PREFIX), 0)
    return qsym, qargs, qaux, meta


def check_artifact(art_dir):
    """Validation problems for an artifact dir (empty list = OK):
    meta present + int8-tagged, gate report complete and within its
    own threshold, model files loadable."""
    problems = []
    try:
        _qsym, qargs, _qaux, meta = load_artifact(art_dir)
    except MXNetError as e:
        return [str(e)]
    if meta.get("dtype_policy") != "int8":
        problems.append("meta dtype_policy %r != 'int8'"
                        % meta.get("dtype_policy"))
    for field in ("topk", "max_delta", "delta", "agreement",
                  "calib_sha256", "quantized_layers"):
        if field not in meta:
            problems.append("meta missing gate field %r" % field)
    if isinstance(meta.get("delta"), (int, float)) and \
            isinstance(meta.get("max_delta"), (int, float)) and \
            meta["delta"] > meta["max_delta"]:
        problems.append("recorded delta %.4f exceeds its own threshold "
                        "%.4f — artifact should never have been emitted"
                        % (meta["delta"], meta["max_delta"]))
    if not any(n.endswith("_weight_quantized") for n in qargs):
        problems.append("params contain no *_weight_quantized entries")
    return problems
