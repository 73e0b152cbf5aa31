"""ImageNet training, the port's copy of examples/train_imagenet.py (the
reference's example/image-classification/train_imagenet.py), with the
same flags.

    python -m mxnet_tpu_torch.examples.train_imagenet --benchmark 1 \
        --network resnet50_v1 --batch-size 32 --steps 30

    python -m mxnet_tpu_torch.examples.train_imagenet \
        --data-train train.rec --network resnet50_v1 --batch-size 128

``--benchmark 1`` trains on one synthetic batch drawn from
``RandomState(0)``: through gluon (``hybridize()``, ``Trainer``,
``autograd.record``, ``backward``, ``step``), or with ``--sharded``
through the one-card ``parallel.ShardedTrainer``.  sgd, momentum 0.9,
one warm-up step, then ``--steps`` timed steps, each ending in a device
synchronize.

``--data-train`` is the example's real loop (examples/train_imagenet.py
:89-118, line for line): ``io.ImageRecordIter`` over the .rec (shuffle,
rand_crop, rand_mirror), a gluon ``Trainer`` (sgd, momentum 0.9, wd
1e-4, ``--kv-store``), ``metric.Accuracy``, ``--num-epochs`` epochs,
each after ``reset()``; each step ends in a device synchronize.

``--kv-store dist_sync`` / ``dist_device_sync`` / ``dist_async`` trains
data-parallel through the parameter server, each worker started by the
port's launcher (examples/train_imagenet.py:5):

    python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local \
        python -m mxnet_tpu_torch.examples.train_imagenet --benchmark 1 \
        --kv-store dist_device_sync --network resnet50_v1 --batch-size 32

``train(argv)`` is the loop itself: it returns the losses and step times
(and, for ``--data-train``, each epoch's images/s and accuracy).  It runs
on ``gpu(0)`` unless the caller passes ``ctx=mx.cpu()``.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision

__all__ = ["parse_args", "train", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--network", default="resnet50_v1")
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--image-shape", default="3,224,224")
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--num-epochs", type=int, default=1)
    parser.add_argument("--benchmark", type=int, default=0)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--kv-store", default="device")
    parser.add_argument("--sharded", action="store_true",
                        help="use the one-card ShardedTrainer")
    parser.add_argument("--data-train", default=None,
                        help=".rec file for real training")
    return parser.parse_args(argv)


def _load_weights(net, arg_params, shape, batch_size, ctx):
    """Infer ``net``'s shapes from a zero batch, then load ``arg_params``
    ({parameter name: numpy array})."""
    with autograd.pause():
        net(mx.nd.zeros((batch_size,) + shape, ctx=ctx))
    mx.convert.load_from_numpy(net, arg_params)


def train(argv=None, ctx=None, arg_params=None, step_hook=None,
          hybridize=True):
    """Run the loop of ``argv`` (the command's flags) on ``ctx`` (default
    ``gpu(0)``), from Xavier weights or, given ``arg_params`` ({parameter
    name: numpy array}), from those.  Returns a dict: ``losses``, the mean
    loss of each step (numpy, read after the loop; with ``--benchmark``
    the warm-up step first); ``step_s``, the host seconds of each timed
    step; ``images_per_sec``; and the ``net`` and ``trainer``.  With
    ``--data-train`` also ``data_wait_s`` (each step's seconds in
    ``next()`` of the iterator), ``epochs`` (a dict an epoch: images/s,
    accuracy, batches, seconds) and the closed ``iterator``; there
    ``step_hook(i)``, when given, is called after step ``i`` ends (a
    profiler's start and stop around chosen steps).  The network is
    hybridized (compiled) as in the example unless ``hybridize`` is
    False, which keeps the eager gluon loop."""
    args = parse_args(argv)
    if not args.benchmark and not args.data_train:
        raise MXNetError("provide --data-train .rec or use --benchmark 1")
    ctx = ctx or mx.gpu(0)
    shape = tuple(int(x) for x in args.image_shape.split(","))
    net = vision.get_model(args.network, classes=args.num_classes)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    if not args.benchmark:
        return _train_records(args, ctx, net, loss_fn, shape, arg_params,
                              step_hook, hybridize)
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(args.batch_size, *shape).astype(np.float32),
                    ctx=ctx)
    y = mx.nd.array(rng.randint(0, args.num_classes, args.batch_size)
                    .astype(np.float32), ctx=ctx)
    if arg_params is not None:
        _load_weights(net, arg_params, shape, args.batch_size, ctx)
    opt_params = {"learning_rate": args.lr, "momentum": 0.9}
    if args.sharded:
        trainer = parallel.ShardedTrainer(
            net, lambda o, l: loss_fn(o, l), optimizer="sgd",
            optimizer_params=opt_params)

        def step():
            return trainer.step([x], y)
    else:
        net.hybridize(hybridize)
        trainer = gluon.Trainer(net.collect_params(), "sgd", opt_params,
                                kvstore=args.kv_store)

        def step():
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(args.batch_size)
            return loss._data.detach().mean()

    device = ctx.torch_device
    losses, times = [], []
    for _ in range(1 + args.steps):
        t0 = time.perf_counter()
        losses.append(step())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    losses = torch.stack([torch.as_tensor(v).reshape(()) for v in losses])
    step_s = times[1:]
    return {"losses": losses.float().cpu().numpy(), "step_s": step_s,
            "images_per_sec": args.batch_size * len(step_s) / sum(step_s)
            if step_s else float("nan"),
            "net": net, "trainer": trainer}


def _train_records(args, ctx, net, loss_fn, shape, arg_params, step_hook,
                   hybridize):
    """examples/train_imagenet.py:89-118 on the port, with its losses,
    times and per-epoch accuracy kept."""
    if arg_params is not None:
        _load_weights(net, arg_params, shape, args.batch_size, ctx)
    train_iter = mx.io.ImageRecordIter(
        path_imgrec=args.data_train, data_shape=shape,
        batch_size=args.batch_size, shuffle=True, rand_crop=True,
        rand_mirror=True, ctx=ctx)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": args.lr, "momentum": 0.9,
                             "wd": 1e-4}, kvstore=args.kv_store)
    metric = mx.metric.Accuracy()
    net.hybridize(hybridize)
    device = ctx.torch_device
    losses, step_s, wait_s, epochs = [], [], [], []
    try:
        for epoch in range(args.num_epochs):
            train_iter.reset()
            metric.reset()
            tic = time.perf_counter()
            i = 0
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(train_iter)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                x, y = batch.data[0], batch.label[0]
                with autograd.record():
                    out = net(x)
                    loss = loss_fn(out, y)
                loss.backward()
                trainer.step(args.batch_size)
                metric.update([y], [out])
                losses.append(loss._data.detach().mean())
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t2 = time.perf_counter()
                wait_s.append(t1 - t0)
                step_s.append(t2 - t0)
                if step_hook is not None:
                    step_hook(len(step_s) - 1)
                if i % 20 == 0:
                    logging.info("epoch %d batch %d %s %.1f img/s", epoch, i,
                                 metric.get(), args.batch_size * (i + 1)
                                 / (t2 - tic))
                i += 1
            seconds = time.perf_counter() - tic
            epochs.append({"images_per_sec": args.batch_size * i / seconds,
                           "accuracy": metric.get()[1], "batches": i,
                           "seconds": seconds})
    finally:
        train_iter.close()
    losses = torch.stack([v.reshape(()) for v in losses]) if losses \
        else torch.zeros(0)
    total_s = sum(e["seconds"] for e in epochs)
    return {"losses": losses.cpu().numpy(), "step_s": step_s,
            "data_wait_s": wait_s, "epochs": epochs,
            "images_per_sec": args.batch_size * len(step_s) / total_s
            if total_s else float("nan"),
            "net": net, "trainer": trainer, "iterator": train_iter}


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    res = train(argv)
    print("speed: %.2f images/sec" % res["images_per_sec"])


if __name__ == "__main__":
    main(sys.argv[1:])
