"""INT8 quantization-calibration walkthrough, the port's copy of
examples/quantize_calibrate.py (the reference's example/quantization,
imagenet_gen_qsym.py + imagenet_inference.py): train fp32 -> collect
calibration statistics -> naive / entropy thresholds -> int8 graph
rewrite -> measure the accuracy delta.

    python -m mxnet_tpu_torch.examples.quantize_calibrate --calib-mode entropy

The int8 path is real: the FullyConnected layers run as int8 x int8 ->
int32 on ``kernels/int8_conv.cu`` (contrib/quantization.py).  Prints the
fp32 and int8 accuracies and "QUANTIZE OK fp32=... int8=... drop=...";
``main`` returns 0 when the fp32 accuracy is above 0.9, the drop at most
``--max-drop`` and at least 3 layers are int8, else 1.  The same flags as
the JAX example plus ``--cpu``; it runs on ``gpu(0)`` unless ``--cpu``
(or a ``ctx``) is given.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.contrib import quantization as qmod


def make_blobs(rng, n, centers):
    """Well-separated gaussian blobs: a small net gets ~100% fp32
    accuracy, so the int8 delta is attributable to quantization.
    `centers` is shared between train and test draws, the task."""
    y = rng.randint(0, len(centers), n)
    x = centers[y] + rng.randn(n, centers.shape[1]) * 0.6
    return x.astype(np.float32), y.astype(np.float32)


def build_symbol(num_classes):
    data = mx.sym.var("data")
    h = mx.sym.FullyConnected(data, num_hidden=64, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=64, name="fc2")
    h = mx.sym.Activation(h, act_type="relu")
    return mx.sym.FullyConnected(h, num_hidden=num_classes, name="fc3")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-classes", type=int, default=5)
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--train-steps", type=int, default=200)
    p.add_argument("--calib-mode", default="naive",
                   choices=["naive", "entropy"])
    p.add_argument("--calib-batches", type=int, default=8)
    p.add_argument("--max-drop", type=float, default=0.02)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def main(argv=None, ctx=None):
    args = parse_args(argv)
    ctx = ctx or (mx.cpu() if args.cpu else mx.gpu(0))
    with ctx:
        return _main(args, ctx)


def _main(args, ctx):
    rng = np.random.RandomState(5)
    centers = rng.randn(args.num_classes, args.dim) * 3.0
    xtr, ytr = make_blobs(rng, 512, centers)
    xte, yte = make_blobs(rng, 256, centers)

    # 1. train fp32 (Module API, the reference's training surface)
    sym = build_symbol(args.num_classes)
    train_sym = mx.sym.SoftmaxOutput(sym, mx.sym.var("softmax_label"),
                                     name="softmax")
    mod = mx.mod.Module(train_sym, data_names=["data"],
                        label_names=["softmax_label"], context=ctx)
    it = mx.io.NDArrayIter(xtr, ytr, batch_size=64, shuffle=True,
                           label_name="softmax_label")
    mod.fit(it, num_epoch=max(1, args.train_steps // 8),
            optimizer="sgd", initializer=mx.init.Xavier(),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    arg_params, aux_params = mod.get_params()

    def accuracy(symbol, argp, auxp):
        # direct bind with explicit args: quantized graphs carry int8
        # weights + range scalars whose shapes data-only inference
        # cannot derive; Module.get_params keeps its copies on the host
        args = {k: v.as_in_context(ctx) for k, v in argp.items()}
        aux = {k: v.as_in_context(ctx) for k, v in auxp.items()}
        ex = symbol.bind(ctx=ctx, args=dict(args, data=nd.array(xte,
                                                                ctx=ctx)),
                         aux_states=aux or None, grad_req="null")
        pred = ex.forward(is_train=False)[0].asnumpy()
        return float((pred.argmax(1) == yte).mean())

    fp32_acc = accuracy(sym, arg_params, aux_params)
    print("fp32 accuracy: %.4f" % fp32_acc)

    # 2. calibrate + rewrite to int8
    calib = mx.io.NDArrayIter(xtr[:64 * args.calib_batches],
                              ytr[:64 * args.calib_batches],
                              batch_size=64)
    t0 = time.time()
    qsym, qargs, qaux = qmod.quantize_model(
        sym, arg_params, aux_params, data_names=("data",),
        calib_mode=args.calib_mode, calib_data=calib,
        num_calib_examples=64 * args.calib_batches)
    print("quantized in %.1fs (calib_mode=%s)" % (time.time() - t0,
                                                  args.calib_mode))
    n_q = sum(1 for name in qargs if name.endswith("_weight_quantized"))
    print("int8 layers: %d" % n_q)

    # 3. int8 accuracy + the delta gate
    int8_acc = accuracy(qsym, qargs, qaux)
    drop = fp32_acc - int8_acc
    print("int8 accuracy: %.4f (drop %.4f)" % (int8_acc, drop))
    print("QUANTIZE OK fp32=%.4f int8=%.4f drop=%.4f" % (
        fp32_acc, int8_acc, drop))
    return 0 if fp32_acc > 0.9 and drop <= args.max_drop and n_q >= 3 \
        else 1


if __name__ == "__main__":
    sys.exit(main())
