"""Fine-tuning from an exported checkpoint, the port's copy of
examples/fine_tune.py (the reference's
example/image-classification/fine-tune.py): load a trained symbol and
its parameters, graft a fresh classifier head onto the feature
extractor, train the head fast and the backbone slow.

1. "pretrain": a model-zoo network (``--network``, Xavier weights) on
   ``--pretrain-classes`` classes, exported (it stands in for a
   downloaded checkpoint);
2. :func:`get_fine_tune_model` cuts the symbol at its flatten layer and
   appends a new ``FullyConnected`` + ``SoftmaxOutput`` for
   ``--classes``;
3. a ``Module`` binds the new task, takes the backbone's weights by
   ``set_params(allow_missing=True)`` and trains with sgd, the
   backbone's learning rate ``--backbone-lr-mult`` times the head's
   (``Optimizer.set_lr_mult``).

Usage::

    python -m mxnet_tpu_torch.examples.fine_tune [--epochs 2] [--cpu]

Everything runs on ``gpu(0)`` unless ``--cpu`` (or a ``ctx``) is given.
:func:`train` returns the per-batch cross-entropy losses and the
accuracies.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd

__all__ = ["parse_args", "get_fine_tune_model", "synthetic_iter",
           "pretrained", "fine_tune_module", "train", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--network", default="resnet18_v1")
    p.add_argument("--image-shape", default="3,32,32")
    p.add_argument("--pretrain-classes", type=int, default=10)
    p.add_argument("--classes", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--backbone-lr-mult", type=float, default=0.1)
    p.add_argument("--train-batches", type=int, default=16)
    p.add_argument("--val-batches", type=int, default=4)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def get_fine_tune_model(sym, arg_params, num_classes,
                        layer_name="flatten"):
    """Cut ``sym`` after ``layer_name``, append a fresh FC + softmax, and
    keep the parameters the new graph reuses (the backbone's)."""
    internals = sym.get_internals()
    outputs = [n for n in internals.list_outputs()
               if n.endswith(layer_name + "_output")
               or layer_name in n and n.endswith("_output")]
    if not outputs:
        raise ValueError("no internal output matching %r" % layer_name)
    feat = internals[outputs[-1]]
    net = mx.sym.FullyConnected(feat, num_hidden=num_classes,
                                name="fc_new")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    new_args = {k: v for k, v in arg_params.items()
                if not k.startswith("fc_new")}
    return net, new_args


def synthetic_iter(num_classes, batch_size, n_batches, seed, shape,
                   ctx=None):
    """Seeded separable images (pixels shifted by the class id) as an
    ``NDArrayIter`` whose batches lie on ``ctx``."""
    rng = np.random.RandomState(seed)
    X = rng.rand(batch_size * n_batches, *shape).astype(np.float32)
    Y = rng.randint(0, num_classes, batch_size * n_batches)
    X += Y[:, None, None, None] * 0.15
    with ctx or mx.current_context():
        return mx.io.NDArrayIter(nd.array(X), nd.array(Y.astype(np.float32)),
                                 batch_size, shuffle=True,
                                 label_name="softmax_label")


def pretrained(network, classes, shape, directory, ctx):
    """The stand-in checkpoint: ``network`` with Xavier weights, exported
    under ``directory`` and read back as (symbol, arg_params,
    aux_params)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.get_model(network, classes=classes)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(nd.array(np.zeros((1,) + shape, np.float32), ctx=ctx))
    prefix = os.path.join(directory, "base")
    net.export(prefix)
    sym = mx.sym.load(prefix + "-symbol.json")
    loaded = nd.load(prefix + "-0000.params", ctx=ctx)
    arg_params = {k.split(":", 1)[1]: v for k, v in loaded.items()
                  if k.startswith("arg:")}
    aux_params = {k.split(":", 1)[1]: v for k, v in loaded.items()
                  if k.startswith("aux:")}
    return sym, arg_params, aux_params


def fine_tune_module(tuned_sym, backbone_args, aux_params, data_iter, ctx,
                     lr, backbone_lr_mult, head_params=None):
    """A bound ``Module`` of the grafted graph: Xavier head (or
    ``head_params``), the backbone's weights, sgd with momentum 0.9 and
    the backbone's ``lr_mult``."""
    mod = mx.mod.Module(tuned_sym, context=ctx)
    mod.bind(data_shapes=data_iter.provide_data,
             label_shapes=data_iter.provide_label)
    mod.init_params(mx.init.Xavier())
    args = dict(backbone_args)
    if head_params:
        args.update(head_params)
    mod.set_params(args, aux_params, allow_missing=True, allow_extra=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": lr, "momentum": 0.9})
    mod._optimizer.set_lr_mult(
        {k: backbone_lr_mult for k in backbone_args})
    return mod


def _cross_entropy(mod, label):
    probs = mod.get_outputs()[0].asnumpy()
    y = label.asnumpy().astype(np.int64)
    return float(-np.mean(np.log(np.maximum(
        probs[np.arange(len(y)), y], 1e-30))))


def train(argv=None, ctx=None):
    """Run the three stages; returns ``{"losses": per-batch cross-entropy,
    "train_acc": per epoch, "val_acc": ...}``."""
    args = parse_args(argv)
    if ctx is None:
        ctx = mx.cpu() if args.cpu else mx.gpu(0)
    shape = tuple(int(v) for v in args.image_shape.split(","))
    with tempfile.TemporaryDirectory() as d:
        sym, arg_params, aux_params = pretrained(
            args.network, args.pretrain_classes, shape, d, ctx)
    tuned_sym, backbone_args = get_fine_tune_model(sym, arg_params,
                                                   args.classes)
    train_it = synthetic_iter(args.classes, args.batch_size,
                              args.train_batches, 0, shape, ctx)
    val_it = synthetic_iter(args.classes, args.batch_size,
                            args.val_batches, 1, shape, ctx)
    mod = fine_tune_module(tuned_sym, backbone_args, aux_params, train_it,
                           ctx, args.lr, args.backbone_lr_mult)
    metric = mx.metric.Accuracy()
    out = {"losses": [], "train_acc": []}
    for epoch in range(args.epochs):
        train_it.reset()
        metric.reset()
        for batch in train_it:
            mod.forward(batch, is_train=True)
            out["losses"].append(_cross_entropy(mod, batch.label[0]))
            mod.update_metric(metric, batch.label)
            mod.backward()
            mod.update()
        name, acc = metric.get()
        out["train_acc"].append(acc)
        print("epoch %d train-%s=%.3f loss=%.4f"
              % (epoch, name, acc, out["losses"][-1]))
    metric.reset()
    val_it.reset()
    for batch in val_it:
        mod.forward(batch, is_train=False)
        mod.update_metric(metric, batch.label)
    out["val_acc"] = metric.get()[1]
    print("val-%s=%.3f" % metric.get())
    return out


def main(argv=None):
    return train(argv)["val_acc"]


if __name__ == "__main__":
    main()
