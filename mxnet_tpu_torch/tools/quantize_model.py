"""Quantize a model to a gated int8 serving artifact (the port's copy of
tools/quantize_model.py).

Drive the int8 graph rewrite of ``contrib.quantization`` from a recorded
calibration batch, measure the top-k accuracy delta against the f32
model of record, and emit an artifact only when the gate passes — a run
that degrades accuracy writes nothing (exit code 3).  The artifact
(symbol json + int8 params + ``meta.json``, the commit point) serves
through ``serving.Predictor.from_symbol`` / ``AsyncPredictor``, where
every quantized layer runs ``kernels/int8_conv.cu`` on the card::

    # quantize the built-in symbolic ResNet-50 at serving shapes
    python -m mxnet_tpu_torch.tools.quantize_model --model resnet50 \\
        --batch 32 --out art/ [--calib recorded_batch.npy]

    # or any saved checkpoint (model.save_checkpoint files)
    python -m mxnet_tpu_torch.tools.quantize_model --symbol m-symbol.json \\
        --params m-0000.params --out art/ --calib batch.npy

    # validate / smoke-serve an artifact
    python -m mxnet_tpu_torch.tools.quantize_model --check art/
    python -m mxnet_tpu_torch.tools.quantize_model --serve-smoke art/

Everything runs on the card unless ``--device cpu`` is given.  The
built-in models take Xavier-like weights from ``--seed`` (no trained
weights ship with the repository).  Exit codes: 0 = OK, 1 = malformed
input or artifact, 3 = accuracy gate refused (no artifact written).
``--json`` prints one machine-parsable summary line on stdout.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

__all__ = ["build_mlp", "build_resnet50", "init_params", "MODELS", "main"]


def log(msg):
    print("[quantize] %s" % msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# built-in symbolic model registry
# ---------------------------------------------------------------------------


def build_mlp(classes=10, dim=16, hidden=64):
    """The small calibration-speed model (tests, walkthroughs)."""
    from .. import symbol as S

    data = S.var("data")
    h = S.FullyConnected(data, num_hidden=hidden, name="fc1")
    h = S.Activation(h, act_type="relu")
    h = S.FullyConnected(h, num_hidden=hidden, name="fc2")
    h = S.Activation(h, act_type="relu")
    out = S.FullyConnected(h, num_hidden=classes, name="fc3")
    return out, (8, dim)


def build_resnet50(classes=1000):
    """Symbolic ResNet-50 v1 at the resnet50_serving shapes: the int8 path
    of record.  BN folds into the convolutions at quantize time
    (``fold_batchnorm``), so the rewritten graph is int8 conv to conv."""
    from .. import symbol as S

    def conv(d, name, nf, kernel, stride=(1, 1), pad=(0, 0)):
        return S.Convolution(d, num_filter=nf, kernel=kernel, stride=stride,
                             pad=pad, no_bias=True, name=name)

    def bn(d, name):
        return S.BatchNorm(d, fix_gamma=False, eps=2e-5, name=name)

    def relu(d):
        return S.Activation(d, act_type="relu")

    def bottleneck(d, name, nf, stride, dim_match):
        b = relu(bn(conv(d, name + "_conv1", nf // 4, (1, 1)),
                    name + "_bn1"))
        b = relu(bn(conv(b, name + "_conv2", nf // 4, (3, 3), stride,
                         (1, 1)), name + "_bn2"))
        b = bn(conv(b, name + "_conv3", nf, (1, 1)), name + "_bn3")
        sc = d if dim_match else bn(
            conv(d, name + "_sc", nf, (1, 1), stride), name + "_scbn")
        return relu(S.elemwise_add(b, sc))

    data = S.var("data")
    body = relu(bn(conv(data, "conv0", 64, (7, 7), (2, 2), (3, 3)), "bn0"))
    body = S.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="max")
    for stage, (units, nf) in enumerate(
            zip((3, 4, 6, 3), (256, 512, 1024, 2048))):
        for unit in range(units):
            stride = (1, 1) if stage == 0 or unit > 0 else (2, 2)
            body = bottleneck(body, "stage%d_unit%d" % (stage, unit),
                              nf, stride, dim_match=unit > 0)
    body = S.Pooling(body, global_pool=True, pool_type="avg", kernel=(7, 7))
    body = S.Flatten(body)
    return S.FullyConnected(body, num_hidden=classes,
                            name="fc1000"), (4, 3, 224, 224)


MODELS = {"mlp": build_mlp, "resnet50": build_resnet50}


def init_params(sym, data_shape, seed=0, ctx=None):
    """Deterministic Xavier-like random parameters for a built-in model
    (the same numpy draws as the JAX package's tool), on ``ctx``
    (default: the current context)."""
    from .. import ndarray as nd

    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    args, auxs = {}, {}
    for name, shp in zip(sym.list_arguments(), arg_shapes):
        if name == "data":
            continue
        if name.endswith("_gamma"):
            v = np.ones(shp, np.float32)
        elif name.endswith(("_beta", "_bias")):
            v = np.zeros(shp, np.float32)
        else:
            fan_in = int(np.prod(shp[1:])) or 1
            v = (rng.randn(*shp) * np.sqrt(2.0 / fan_in)) \
                .astype(np.float32)
        args[name] = nd.array(v, ctx=ctx)
    for name, shp in zip(sym.list_auxiliary_states(), aux_shapes):
        v = np.ones(shp, np.float32) if name.endswith("_moving_var") \
            else np.zeros(shp, np.float32)
        auxs[name] = nd.array(v, ctx=ctx)
    return args, auxs


def _context(args):
    from ..context import cpu, gpu

    return cpu() if args.device == "cpu" else gpu(0)


def _load_calib(args, data_shape):
    if args.calib:
        try:
            batch = np.load(args.calib)
        except (OSError, ValueError) as e:
            raise SystemExit("--calib %s: cannot load (%s)"
                             % (args.calib, e))
        log("calibration batch of record: %s %s from %s"
            % (batch.shape, batch.dtype, args.calib))
        return batch
    rng = np.random.RandomState(args.seed + 1)
    batch = rng.rand(*data_shape).astype(np.float32)
    log("no --calib given: synthetic seeded batch %s (record a real "
        "serving batch for production gates)" % (batch.shape,))
    return batch


def run_quantize(args):
    from ..contrib import quantization as q

    ctx = _context(args)
    if args.symbol:
        from .. import ndarray as nd
        from .. import symbol as S

        if not args.params:
            raise SystemExit("--symbol needs --params")
        if not args.calib:
            # a loaded checkpoint carries no data-shape hint to
            # synthesize a batch from
            raise SystemExit("--symbol mode needs --calib (a recorded "
                             "calibration batch .npy)")
        sym = S.load(args.symbol)
        blob = nd.load(args.params, ctx=ctx)
        arg_params = {k.split(":", 1)[1]: v for k, v in blob.items()
                      if k.startswith("arg:")}
        aux_params = {k.split(":", 1)[1]: v for k, v in blob.items()
                      if k.startswith("aux:")}
        data_shape = None
    else:
        builder = MODELS.get(args.model)
        if builder is None:
            raise SystemExit("unknown --model %r; registered: %s "
                             "(or use --symbol/--params)"
                             % (args.model, ", ".join(sorted(MODELS))))
        sym, data_shape = builder()
        if args.batch:
            data_shape = (int(args.batch),) + tuple(data_shape[1:])
        arg_params, aux_params = init_params(sym, data_shape,
                                             seed=args.seed, ctx=ctx)
        log("built %s (%d args, %d aux) on %s"
            % (args.model, len(arg_params), len(aux_params), ctx))
    calib = _load_calib(args, data_shape)
    try:
        qsym, qargs, qaux, report = q.quantize_serving_artifact(
            sym, arg_params, aux_params, calib,
            data_name=args.data_name,
            excluded_sym_names=args.exclude or None,
            topk=args.topk, max_delta=args.max_delta, logger=log)
    except q.QuantizationGateError as e:
        log("REFUSED: %s" % e)
        if args.json:
            print(json.dumps({"status": "refused", "error": str(e)}))
        return 3
    q.save_artifact(args.out, qsym, qargs, qaux, report)
    log("artifact committed to %s (top-%d agreement %.4f, delta %.4f "
        "<= %.4f)" % (args.out, report["topk"], report["agreement"],
                      report["delta"], report["max_delta"]))
    if args.json:
        print(json.dumps(dict(report, status="emitted", out=args.out)))
    return 0


def run_check(args):
    from ..contrib import quantization as q

    problems = q.check_artifact(args.check)
    if not problems:
        _s, _a, _x, meta = q.load_artifact(args.check)
        print("%s: OK (int8, %d quantized layers, top-%s delta %s <= %s)"
              % (args.check, meta.get("quantized_layers", 0),
                 meta.get("topk"), meta.get("delta"),
                 meta.get("max_delta")))
        return 0
    for p in problems:
        print("MALFORMED: %s" % p, file=sys.stderr)
    return 1


def run_serve_smoke(args):
    """Load the artifact and serve one batch end to end through
    Predictor.from_symbol — the path AsyncPredictor replicas take."""
    from ..contrib import quantization as q
    from ..serving import Predictor

    qsym, qargs, qaux, meta = q.load_artifact(args.serve_smoke)
    shape = tuple(meta.get("data_shape") or ())
    dtype = np.dtype(meta.get("data_dtype") or "float32")
    if not shape:
        raise SystemExit("%s: meta carries no data_shape" %
                         args.serve_smoke)
    pred = Predictor.from_symbol(
        qsym, qargs, qaux, data_name=meta.get("data_name", "data"),
        chain=args.chain, batch_shape=shape, batch_dtype=dtype,
        device=_context(args), aot_policy_tag="int8")
    rng = np.random.RandomState(args.seed)
    batch = rng.rand(*shape).astype(dtype) \
        if np.issubdtype(dtype, np.floating) else \
        rng.randint(0, 255, shape).astype(dtype)
    out = list(pred.predict([batch]))[0]
    ok = bool(np.all(np.isfinite(np.asarray(out, np.float32))))
    log("served %d rows -> output %s %s (finite=%s)"
        % (shape[0], out.shape, out.dtype, ok))
    if args.json:
        print(json.dumps({"status": "served" if ok else "nonfinite",
                          "rows": int(shape[0]),
                          "out_shape": [int(d) for d in out.shape]}))
    return 0 if ok else 1


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Quantize a model to a gated int8 serving artifact "
                    "(or --check / --serve-smoke an existing one)")
    p.add_argument("--model", default="mlp",
                   help="built-in symbolic model: %s"
                        % ", ".join(sorted(MODELS)))
    p.add_argument("--batch", type=int, default=None,
                   help="batch rows of a built-in model's calibration "
                        "batch and serving contract (default: the "
                        "model's own, 8 for mlp and 4 for resnet50)")
    p.add_argument("--symbol", help="saved symbol json (with --params; "
                                    "overrides --model)")
    p.add_argument("--params", help="saved params blob "
                                    "(model.save_checkpoint layout)")
    p.add_argument("--out", help="artifact output directory")
    p.add_argument("--calib", help="recorded calibration batch (.npy); "
                                   "default: synthetic seeded batch")
    p.add_argument("--data-name", default="data")
    p.add_argument("--exclude", action="append",
                   help="layer name to keep fp32 (repeatable)")
    p.add_argument("--topk", type=int, default=None,
                   help="accuracy-gate top-k (default: "
                        "MXNET_QUANTIZE_TOPK)")
    p.add_argument("--max-delta", type=float, default=None,
                   help="max tolerated top-k delta (default: "
                        "MXNET_QUANTIZE_MAX_DELTA)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chain", type=int, default=2,
                   help="--serve-smoke dispatch chain")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs (default: the card)")
    p.add_argument("--check", metavar="DIR",
                   help="validate an artifact instead of quantizing")
    p.add_argument("--serve-smoke", metavar="DIR",
                   help="serve one batch from an artifact through "
                        "Predictor.from_symbol")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON summary line on stdout")
    args = p.parse_args(argv)
    if args.check:
        return run_check(args)
    if args.serve_smoke:
        return run_serve_smoke(args)
    if not args.out:
        p.error("--out is required in quantize mode (or use --check / "
                "--serve-smoke)")
    return run_quantize(args)


if __name__ == "__main__":
    sys.exit(main())
