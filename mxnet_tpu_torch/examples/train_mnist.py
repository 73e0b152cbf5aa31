"""MNIST training, the port's copy of examples/train_mnist.py (the
reference's example/image-classification/train_mnist.py), with the same
two paths:

    python -m mxnet_tpu_torch.examples.train_mnist --api module
    python -m mxnet_tpu_torch.examples.train_mnist --api gluon

``--api module`` trains the MLP symbol (784-128-64-10, ``SoftmaxOutput``)
with ``Module.fit`` (sgd, momentum 0.9, Xavier magnitude 2, a
``Speedometer``); ``--api gluon`` trains a hybridized LeNet with a gluon
``Trainer``.  Both read ``io.MNISTIter``: the idx-ubyte files in
``--data-dir`` when they are there, else its seeded stand-in digits.
Everything runs on ``gpu(0)`` unless ``--cpu`` (or a ``ctx``) is given.
There is no distributed path.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon import nn

__all__ = ["parse_args", "get_iters", "mlp_symbol", "lenet_gluon",
           "train_module", "train_gluon", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--api", choices=["module", "gluon", "both"],
                        default="both")
    parser.add_argument("--data-dir", default=".",
                        help="directory of the idx-ubyte files")
    parser.add_argument("--cpu", action="store_true")
    return parser.parse_args(argv)


def _ctx(args, ctx):
    if ctx is not None:
        return ctx
    return mx.cpu() if args.cpu else mx.gpu(0)


def get_iters(batch_size, data_dir=".", ctx=None):
    """Train and validation ``MNISTIter``s (the same files, the latter
    unshuffled) whose batches lie on ``ctx``."""
    files = dict(image=os.path.join(data_dir, "train-images-idx3-ubyte"),
                 label=os.path.join(data_dir, "train-labels-idx1-ubyte"))
    with ctx or mx.current_context():
        train = mx.io.MNISTIter(batch_size=batch_size, shuffle=True,
                                flat=False, **files)
        val = mx.io.MNISTIter(batch_size=batch_size, shuffle=False,
                              flat=False, **files)
    return train, val


def mlp_symbol():
    data = mx.sym.var("data")
    net = mx.sym.Flatten(data)
    net = mx.sym.FullyConnected(net, num_hidden=128, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc3")
    return mx.sym.SoftmaxOutput(net, mx.sym.var("softmax_label"),
                                name="softmax")


def lenet_gluon():
    net = nn.HybridSequential()
    net.add(nn.Conv2D(20, 5, activation="relu"), nn.MaxPool2D(2, 2),
            nn.Conv2D(50, 5, activation="relu"), nn.MaxPool2D(2, 2),
            nn.Flatten(), nn.Dense(500, activation="relu"), nn.Dense(10))
    return net


def train_module(args, ctx=None, batch_end_callback=None, initializer=None):
    """``Module.fit`` of the MLP for ``args.epochs`` epochs; returns the
    module and its validation accuracy pairs.  ``batch_end_callback``
    (one or a list) runs after the ``Speedometer``; ``initializer``
    defaults to Xavier at magnitude 2."""
    ctx = _ctx(args, ctx)
    train, val = get_iters(args.batch_size, args.data_dir, ctx)
    callbacks = [mx.callback.Speedometer(args.batch_size, 50)]
    if batch_end_callback is not None:
        callbacks += batch_end_callback if isinstance(
            batch_end_callback, list) else [batch_end_callback]
    mod = mx.mod.Module(mlp_symbol(), context=ctx)
    mod.fit(train, eval_data=val, optimizer="sgd",
            optimizer_params={"learning_rate": args.lr, "momentum": 0.9},
            num_epoch=args.epochs,
            # fit()'s default Uniform(0.01) stalls this MLP for many
            # epochs; the reference example passes Xavier too
            initializer=initializer or mx.init.Xavier(magnitude=2.0),
            batch_end_callback=callbacks)
    return mod, mod.score(val, "acc")


def train_gluon(args, ctx=None, net=None, max_steps=None):
    """The hybridized LeNet's loop for ``args.epochs`` epochs (or
    ``max_steps`` steps).  Returns a dict: ``losses`` (each step's mean
    loss, read after the loop), ``step_s`` (each step's seconds, ending
    in a device synchronize), ``metric`` (train accuracy pairs) and the
    ``net``."""
    ctx = _ctx(args, ctx)
    train, _ = get_iters(args.batch_size, args.data_dir, ctx)
    if net is None:
        net = lenet_gluon()
        net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": args.lr, "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    losses, step_s = [], []
    sync = torch.cuda.synchronize if ctx.device_type == "gpu" \
        else (lambda: None)
    for epoch in range(args.epochs):
        train.reset()
        metric.reset()
        for batch in train:
            if max_steps is not None and len(losses) == max_steps:
                break
            t0 = time.perf_counter()
            x = batch.data[0].as_in_context(ctx)
            y = batch.label[0].as_in_context(ctx)
            with autograd.record():
                out = net(x)
                loss = loss_fn(out, y)
            loss.backward()
            trainer.step(args.batch_size)
            sync()
            step_s.append(time.perf_counter() - t0)
            losses.append(loss.mean()._data)
            metric.update([y], [out])
        logging.info("gluon epoch %d %s", epoch, metric.get())
    losses = [float(v) for v in losses]
    return {"losses": np.array(losses), "step_s": step_s,
            "metric": metric.get(), "net": net}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    if args.api in ("module", "both"):
        print("module:", train_module(args)[1])
    if args.api in ("gluon", "both"):
        print("gluon:", train_gluon(args)["metric"])


if __name__ == "__main__":
    main()
