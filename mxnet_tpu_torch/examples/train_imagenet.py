"""ImageNet training, the port's copy of examples/train_imagenet.py (the
reference's example/image-classification/train_imagenet.py), with the
same flags.

    python -m mxnet_tpu_torch.examples.train_imagenet --benchmark 1 \
        --network resnet50_v1 --batch-size 32 --steps 30

``--benchmark 1`` trains on one synthetic batch drawn from
``RandomState(0)``: through gluon (``hybridize()``, ``Trainer``,
``autograd.record``, ``backward``, ``step``), or with ``--sharded``
through the one-card ``parallel.ShardedTrainer``.  sgd, momentum 0.9,
one warm-up step, then ``--steps`` timed steps, each ending in a device
synchronize.  ``train(argv)`` is the loop itself: it returns the losses
and step times.  It runs on ``gpu(0)`` unless the caller passes
``ctx=mx.cpu()``.  ``--data-train`` (io.ImageRecordIter) and
``--kv-store dist*`` (tools/launch.py's parameter server) are not
ported yet and raise.
"""
from __future__ import annotations

import argparse
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
                        help=".rec file for real training (not ported)")
    return parser.parse_args(argv)


def train(argv=None, ctx=None, arg_params=None):
    """Run the benchmark loop of ``argv`` (the command's flags) on ``ctx``
    (default ``gpu(0)``), from Xavier weights or, given ``arg_params``
    ({parameter name: numpy array}), from those.  Returns a dict:
    ``losses``, the mean loss of the warm-up step and of each timed step
    (numpy, read after the loop); ``step_s``, the host seconds of each
    timed step; ``images_per_sec``; and the ``net`` and ``trainer``."""
    args = parse_args(argv)
    if args.data_train:
        raise MXNetError("--data-train is not ported yet: it needs "
                         "io.ImageRecordIter")
    if args.kv_store.startswith("dist"):
        raise MXNetError("--kv-store %s is not ported yet: it needs "
                         "tools/launch.py's parameter server"
                         % args.kv_store)
    if not args.benchmark:
        raise MXNetError("provide --data-train .rec or use --benchmark 1")
    ctx = ctx or mx.gpu(0)
    shape = tuple(int(x) for x in args.image_shape.split(","))
    net = vision.get_model(args.network, classes=args.num_classes)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.rand(args.batch_size, *shape).astype(np.float32),
                    ctx=ctx)
    y = mx.nd.array(rng.randint(0, args.num_classes, args.batch_size)
                    .astype(np.float32), ctx=ctx)
    if arg_params is not None:
        with autograd.pause():
            net(x)
        mx.convert.load_from_numpy(net, arg_params)
    opt_params = {"learning_rate": args.lr, "momentum": 0.9}
    if args.sharded:
        trainer = parallel.ShardedTrainer(
            net, lambda o, l: loss_fn(o, l), optimizer="sgd",
            optimizer_params=opt_params)

        def step():
            return trainer.step([x], y)
    else:
        net.hybridize()
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


def main(argv=None):
    res = train(argv)
    print("speed: %.2f images/sec" % res["images_per_sec"])


if __name__ == "__main__":
    main(sys.argv[1:])
