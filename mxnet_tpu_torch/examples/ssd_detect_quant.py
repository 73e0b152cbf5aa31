"""SSD detection + INT8 quantization, the port's copy of
examples/ssd_detect_quant.py (the reference's example/ssd +
example/quantization flow, BASELINE config 5):

    python -m mxnet_tpu_torch.examples.ssd_detect_quant \\
        --num-classes 20 --width 64 --image-size 300 --batch-size 32

Builds a VGG16-style SSD detector symbolically (two prediction scales),
trains it briefly on synthetic boxes through the in-graph MultiBoxTarget
+ SoftmaxOutput / smooth_l1 losses with ``mx.mod.Module`` (the compiled
Executor), then runs MultiBoxDetection inference in fp32, int8-quantizes
the convolutions with ``contrib.quantization.quantize_model`` (int8 x
int8 -> int32 on ``kernels/int8_conv.cu``, NMS on ``kernels/nms.cu``) and
compares detections and times.  Data come from a synthetic-JPEG detection
``.rec`` through ``ImageDetIter`` (``--no-rec``: in-memory tensors).  The
same functions, flags and defaults as the JAX example, plus ``--width``
(``build_ssd``'s width, 64 for VGG16's) and ``--cpu``; everything runs on
``gpu(0)`` unless ``--cpu`` (or a ``ctx``) is given.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.contrib import quantization as qmod
from mxnet_tpu_torch.io.io import DataBatch


def vgg_stage(data, num_filter, layers, name):
    """VGG block: `layers` 3x3 convs + relu, then 2x2 max pool."""
    h = data
    for i in range(layers):
        h = mx.sym.Convolution(h, kernel=(3, 3), pad=(1, 1),
                               num_filter=num_filter,
                               name="%s_conv%d" % (name, i))
        h = mx.sym.Activation(h, act_type="relu")
    return mx.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max")


def build_ssd(num_classes, sizes=((0.2, 0.35), (0.5, 0.75)),
              ratios=(1.0, 2.0, 0.5), width=32):
    """Two-scale SSD over a reduced VGG16 trunk.

    Returns (anchors, cls_preds, loc_preds) symbols, the SSD triple that
    both the training and detection graphs are built from."""
    data = mx.sym.var("data")
    h = vgg_stage(data, width, 2, "stage1")       # /2
    h = vgg_stage(h, width * 2, 2, "stage2")      # /4
    f1 = h                                        # first prediction scale
    f2 = vgg_stage(h, width * 4, 3, "stage3")     # /8, second scale

    num_anchors = len(sizes[0]) + len(ratios) - 1
    anchors, cls_heads, loc_heads = [], [], []
    for i, feat in enumerate((f1, f2)):
        anchors.append(mx.sym.Flatten(mx.sym.contrib.MultiBoxPrior(
            feat, sizes=sizes[i], ratios=ratios)))
        cls = mx.sym.Convolution(
            feat, kernel=(3, 3), pad=(1, 1),
            num_filter=num_anchors * (num_classes + 1),
            name="cls_head%d" % i)
        loc = mx.sym.Convolution(
            feat, kernel=(3, 3), pad=(1, 1), num_filter=num_anchors * 4,
            name="loc_head%d" % i)
        # (N, A*C, H, W) -> (N, H*W*A, C) rows per anchor
        cls_heads.append(mx.sym.Flatten(
            mx.sym.transpose(cls, axes=(0, 2, 3, 1))))
        loc_heads.append(mx.sym.Flatten(
            mx.sym.transpose(loc, axes=(0, 2, 3, 1))))
    anchors = mx.sym.Reshape(mx.sym.Concat(*anchors, dim=1),
                             shape=(1, -1, 4))
    cls_preds = mx.sym.transpose(
        mx.sym.Reshape(mx.sym.Concat(*cls_heads, dim=1),
                       shape=(0, -1, num_classes + 1)), axes=(0, 2, 1))
    loc_preds = mx.sym.Concat(*loc_heads, dim=1)
    return anchors, cls_preds, loc_preds


def training_symbol(num_classes, width=32):
    """SSD training graph: MultiBoxTarget encodes gt boxes in-graph,
    SoftmaxOutput + smooth_l1 give the joint objective (the reference
    example/ssd/symbol/symbol_builder.py shape)."""
    anchors, cls_preds, loc_preds = build_ssd(num_classes, width=width)
    label = mx.sym.var("label")
    loc_t, loc_mask, cls_t = mx.sym.contrib.MultiBoxTarget(
        anchors, label, cls_preds, overlap_threshold=0.5,
        negative_mining_ratio=3.0, negative_mining_thresh=0.5)
    cls_loss = mx.sym.SoftmaxOutput(cls_preds, cls_t, ignore_label=-1,
                                    use_ignore=True,
                                    multi_output=True,
                                    normalization="valid",
                                    name="cls_prob")
    loc_diff = mx.sym.smooth_l1(loc_mask * (loc_preds - loc_t), scalar=1.0)
    loc_loss = mx.sym.MakeLoss(mx.sym.mean(loc_diff), name="loc_loss")
    return mx.sym.Group([cls_loss, loc_loss])


def detection_symbol(num_classes, width=32):
    anchors, cls_preds, loc_preds = build_ssd(num_classes, width=width)
    cls_prob = mx.sym.softmax(cls_preds, axis=1)
    return mx.sym.contrib.MultiBoxDetection(
        cls_prob, loc_preds, anchors, nms_threshold=0.45,
        nms_topk=100)


def synthetic_batch(rng, batch, num_classes, size):
    """Images with one bright square each; the label encodes its box."""
    x = rng.rand(batch, 3, size, size).astype(np.float32) * 0.1
    labels = np.full((batch, 1, 5), -1, np.float32)
    for b in range(batch):
        cls = rng.randint(num_classes)
        w = rng.uniform(0.2, 0.5)
        x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - w)
        px = slice(int(y1 * size), int((y1 + w) * size))
        py = slice(int(x1 * size), int((x1 + w) * size))
        x[b, cls % 3, px, py] = 1.0
        labels[b, 0] = [cls, x1, y1, x1 + w, y1 + w]
    return x, labels


def make_synthetic_rec(prefix, n, size, num_classes, rng):
    """Write a synthetic-JPEG detection RecordIO (the on-disk format
    im2rec produces for SSD: packed JPEG + flat det label)."""
    from mxnet_tpu_torch import recordio

    writer = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "w")
    for i in range(n):
        img = (rng.rand(size, size, 3) * 25).astype(np.uint8)
        cls = rng.randint(num_classes)
        w = rng.uniform(0.2, 0.5)
        x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - w)
        ys = slice(int(y1 * size), int((y1 + w) * size))
        xs = slice(int(x1 * size), int((x1 + w) * size))
        img[ys, xs, cls % 3] = 255
        label = np.array([2, 5, cls, x1, y1, x1 + w, y1 + w], np.float32)
        hdr = recordio.IRHeader(0, label, i, 0)
        writer.write_idx(i, recordio.pack_img(hdr, img, quality=95,
                                              img_fmt=".jpg"))
    writer.close()
    return prefix + ".rec"


def det_iter_batches(it):
    """Endless (data, label) stream from an ImageDetIter: decoded JPEG
    pixels scaled to [0,1] NCHW, labels (B, max_obj, 5)."""
    while True:
        try:
            b = next(it)
        except StopIteration:
            it.reset()
            b = next(it)
        yield b.data[0].asnumpy() / 255.0, b.label[0].asnumpy()


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--train-steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--width", type=int, default=32,
                   help="build_ssd's width (VGG16's is 64)")
    p.add_argument("--data-rec", default="",
                   help="detection .rec (im2rec det layout); a synthetic-"
                        "JPEG one is generated when empty")
    p.add_argument("--no-rec", action="store_true",
                   help="skip the RecordIO path and train from in-memory "
                        "synthetic tensors")
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def _sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize(ctx.torch_device)


def _on(params, ctx):
    """``params`` (Module.get_params keeps its copies on the host) on
    ``ctx``, the executor's device."""
    return {k: v.as_in_context(ctx) for k, v in params.items()}


def _timed_forward(ex, ctx):
    """(outputs as numpy, seconds) of one forward, to its last result."""
    t0 = time.perf_counter()
    out = ex.forward()[0]
    _sync(ctx)
    dt = time.perf_counter() - t0
    return out.asnumpy(), dt


def run(args, ctx=None, step_hook=None):
    """The example's flow on ``ctx`` (``gpu(0)`` unless ``--cpu``).
    Returns a dict: ``loc_loss`` and ``cls_prob_max`` (each step's loss
    and mean max class probability, read after the loop), ``step_s``
    (each step's seconds, ending in a device synchronize) and ``wait_s``
    (each step's seconds in ``next()`` on the data), ``train_compile_s``,
    the fp32 and int8 detections (``det_fp32``, ``det_int8``) with the
    seconds of their first (compiling) and second forward, the executors
    ``dex`` and ``qex``, ``n_q`` quantized layers, and the top-1
    ``same_cls`` and ``box_err`` of image 0.  ``step_hook(i)`` runs after
    training step ``i``.  ``ctx`` is also the current context meanwhile
    (ImageDetIter's batches are made there)."""
    ctx = ctx or (mx.cpu() if args.cpu else mx.gpu(0))
    with ctx:
        return _run(args, ctx, step_hook)


def _run(args, ctx, step_hook):
    rng = np.random.RandomState(0)

    # real-data path: decoded JPEGs + bbox-aware augmenters through
    # ImageDetIter (reference example/ssd train flow)
    batches = None
    if not args.no_rec:
        rec = args.data_rec
        if not rec:
            rec = make_synthetic_rec(
                os.path.join(tempfile.mkdtemp(prefix="ssdrec"), "train"),
                4 * args.batch_size, args.image_size, args.num_classes,
                rng)
            logging.info("generated synthetic-JPEG rec: %s", rec)
        det_it = mx.image.ImageDetIter(
            batch_size=args.batch_size,
            data_shape=(3, args.image_size, args.image_size),
            path_imgrec=rec, shuffle=True, rand_mirror=True)
        batches = det_iter_batches(det_it)
        X, L = next(batches)
    else:
        X, L = synthetic_batch(rng, args.batch_size, args.num_classes,
                               args.image_size)

    # train the detector briefly
    tsym = training_symbol(args.num_classes, width=args.width)
    mod = mx.mod.Module(tsym, data_names=("data",), label_names=("label",),
                        context=ctx)
    mod.bind(data_shapes=[("data", X.shape)],
             label_shapes=[("label", L.shape)], for_training=True)
    mod.init_params(mx.init.Xavier(magnitude=2.0))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": args.lr,
                                         "momentum": 0.9})
    loc_loss, cls_max, step_s, wait_s = [], [], [], []
    for step in range(args.train_steps):
        t0 = time.perf_counter()
        if batches is not None:
            X, L = next(batches)
        else:
            X, L = synthetic_batch(rng, args.batch_size, args.num_classes,
                                   args.image_size)
        t1 = time.perf_counter()
        batch = DataBatch(data=[nd.array(X, ctx=ctx)],
                          label=[nd.array(L, ctx=ctx)])
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        outs = mod.get_outputs()
        cls_max.append(outs[0]._data.amax(dim=1).mean())
        loc_loss.append(outs[1]._data.reshape(-1)[0])
        _sync(ctx)
        wait_s.append(t1 - t0)
        step_s.append(time.perf_counter() - t0)
        if step % 10 == 0:
            logging.info("step %d  mean max cls prob %.3f", step,
                         float(cls_max[-1]))
        if step_hook is not None:
            step_hook(step)
    arg_params, aux_params = mod.get_params()
    train_compile_s = sum(e.compile_seconds for e in mod._exec_group.execs)

    # fp32 detection
    dsym = detection_symbol(args.num_classes, width=args.width)
    if batches is not None:
        Xv, _ = next(batches)
    else:
        Xv, _ = synthetic_batch(rng, args.batch_size, args.num_classes,
                                args.image_size)
    dex = dsym.bind(ctx=ctx, args=dict(_on(arg_params, ctx),
                                       data=nd.array(Xv, ctx=ctx)))
    _, fp32_first = _timed_forward(dex, ctx)      # compile + warm
    det_fp32, fp32_s = _timed_forward(dex, ctx)
    kept = det_fp32[0][det_fp32[0, :, 0] >= 0]
    logging.info("fp32 detections (img 0, top 3): %s",
                 np.round(kept[:3], 3).tolist())

    # INT8: graph rewrite + weight quantization, then re-bind
    qsym, qargs, qaux = qmod.quantize_model(
        dsym, arg_params, aux_params, calib_mode="none")
    n_q = sum(1 for k in qargs if k.endswith("_weight_quantized"))
    logging.info("quantized %d conv/fc layers to int8", n_q)
    qex = qsym.bind(ctx=ctx, args=dict(_on(qargs, ctx),
                                       data=nd.array(Xv, ctx=ctx)))
    _, int8_first = _timed_forward(qex, ctx)      # compile + warm
    det_int8, int8_s = _timed_forward(qex, ctx)
    kept_q = det_int8[0][det_int8[0, :, 0] >= 0]
    logging.info("int8 detections (img 0, top 3): %s",
                 np.round(kept_q[:3], 3).tolist())

    # int8 should agree with fp32 on the top detection's class and
    # roughly on its box
    same_cls = box_err = None
    if len(kept) and len(kept_q):
        same_cls = bool(kept[0][0] == kept_q[0][0])
        box_err = float(np.abs(kept[0][2:] - kept_q[0][2:]).max())
        logging.info("top-1 agreement: class %s, box err %.3f", same_cls,
                     box_err)
    return {"loc_loss": np.array([float(v) for v in loc_loss]),
            "cls_prob_max": np.array([float(v) for v in cls_max]),
            "step_s": step_s, "wait_s": wait_s,
            "train_compile_s": train_compile_s, "mod": mod,
            "det_fp32": det_fp32, "det_int8": det_int8,
            "fp32_first_s": fp32_first, "fp32_s": fp32_s,
            "int8_first_s": int8_first, "int8_s": int8_s,
            "dex": dex, "qex": qex, "n_q": n_q, "data": Xv,
            "arg_params": arg_params, "aux_params": aux_params,
            "same_cls": same_cls, "box_err": box_err}


def main(argv=None, ctx=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    res = run(args, ctx)
    print("fp32 %.3fs  int8 %.3fs  (batch %d)  quantized_layers=%d"
          % (res["fp32_s"], res["int8_s"], args.batch_size, res["n_q"]))
    return 0


if __name__ == "__main__":
    main()
