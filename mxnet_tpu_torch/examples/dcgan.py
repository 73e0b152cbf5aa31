"""DCGAN, the port's copy of examples/dcgan.py (the reference's
example/gluon/dcgan.py): generator and discriminator trained against
each other with two Adam Trainers, Deconvolution upsampling and the
alternating update, on the same synthetic 16x16 "real" images.

    python -m mxnet_tpu_torch.examples.dcgan [--epochs 1] [--batch-size 32]

``train`` is the loop; it runs on ``gpu(0)`` unless the caller passes
``ctx=mx.cpu()``, and starts from ``Normal(0.02)`` weights or, given
``arg_params`` ({parameter name: numpy array}), from those (through
``init.Load``).  Its history holds each epoch's mean losses and, beside
them, every step's.
"""
from __future__ import annotations

import argparse

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon import Trainer, nn
from mxnet_tpu_torch.gluon.loss import SigmoidBinaryCrossEntropyLoss

__all__ = ["build_generator", "build_discriminator", "real_batch", "train"]


def build_generator(ngf=16, nc=1):
    net = nn.HybridSequential()
    net.add(
        # latent (B, nz, 1, 1) -> (B, ngf*2, 4, 4)
        nn.Conv2DTranspose(ngf * 2, 4, strides=1, padding=0,
                           use_bias=False),
        nn.BatchNorm(), nn.Activation("relu"),
        # -> (B, ngf, 8, 8)
        nn.Conv2DTranspose(ngf, 4, strides=2, padding=1, use_bias=False),
        nn.BatchNorm(), nn.Activation("relu"),
        # -> (B, nc, 16, 16)
        nn.Conv2DTranspose(nc, 4, strides=2, padding=1, use_bias=False),
        nn.Activation("tanh"),
    )
    return net


def build_discriminator(ndf=16):
    net = nn.HybridSequential()
    net.add(
        nn.Conv2D(ndf, 4, strides=2, padding=1, use_bias=False),
        nn.LeakyReLU(0.2),
        nn.Conv2D(ndf * 2, 4, strides=2, padding=1, use_bias=False),
        nn.BatchNorm(), nn.LeakyReLU(0.2),
        nn.Conv2D(1, 4, strides=1, padding=0, use_bias=False),
        # (B, 1, 1, 1) logits
    )
    return net


def real_batch(rng, batch_size):
    """Structured 'real' images in [-1, 1]: a smooth vertical gradient
    plus horizontal stripes."""
    y = np.linspace(-1, 1, 16, dtype=np.float32)
    base = np.tile(y[None, None, :, None], (batch_size, 1, 1, 16))
    phase = rng.rand(batch_size, 1, 1, 1).astype(np.float32)
    stripes = np.sin(
        2 * np.pi * (np.arange(16, dtype=np.float32)[None, None, None]
                     / 8.0 + phase))
    return np.clip(0.6 * base + 0.4 * stripes, -1, 1)


def train(epochs=1, batch_size=32, nz=16, steps_per_epoch=24, lr=2e-4,
          seed=0, verbose=True, ctx=None, arg_params=None):
    """Train for ``epochs`` x ``steps_per_epoch`` steps on ``ctx``
    (default ``gpu(0)``).  Returns (generator, discriminator, history):
    history's ``d`` and ``g`` are each epoch's mean losses, ``d_steps``
    and ``g_steps`` each step's."""
    ctx = ctx or mx.gpu(0)
    rng = np.random.RandomState(seed)
    mx.random.seed(seed)
    gen, disc = build_generator(), build_discriminator()
    init = mx.init.Normal(0.02)
    if arg_params is not None:
        init = mx.init.Load(arg_params, default_init=init)
    gen.initialize(init, ctx=ctx)
    disc.initialize(init, ctx=ctx)
    loss_fn = SigmoidBinaryCrossEntropyLoss()
    g_tr = Trainer(gen.collect_params(), "adam",
                   {"learning_rate": lr, "beta1": 0.5})
    d_tr = Trainer(disc.collect_params(), "adam",
                   {"learning_rate": lr, "beta1": 0.5})
    ones = nd.array(np.ones((batch_size,), np.float32), ctx=ctx)
    zeros = nd.array(np.zeros((batch_size,), np.float32), ctx=ctx)
    history = {"d": [], "g": [], "d_steps": [], "g_steps": []}
    for epoch in range(epochs):
        d_sum = g_sum = 0.0
        for _ in range(steps_per_epoch):
            real = nd.array(real_batch(rng, batch_size), ctx=ctx)
            z = nd.array(rng.randn(batch_size, nz, 1, 1)
                         .astype(np.float32), ctx=ctx)
            # --- D step: maximize log D(x) + log(1 - D(G(z)))
            fake = gen(z).detach()
            with autograd.record():
                out_r = disc(real).reshape((-1,))
                out_f = disc(fake).reshape((-1,))
                d_loss = loss_fn(out_r, ones) + loss_fn(out_f, zeros)
            d_loss.backward()
            d_tr.step(batch_size)
            # --- G step: maximize log D(G(z))
            z = nd.array(rng.randn(batch_size, nz, 1, 1)
                         .astype(np.float32), ctx=ctx)
            with autograd.record():
                out = disc(gen(z)).reshape((-1,))
                g_loss = loss_fn(out, ones)
            g_loss.backward()
            g_tr.step(batch_size)
            history["d_steps"].append(float(d_loss.mean().asnumpy()))
            history["g_steps"].append(float(g_loss.mean().asnumpy()))
            d_sum += history["d_steps"][-1]
            g_sum += history["g_steps"][-1]
        history["d"].append(d_sum / steps_per_epoch)
        history["g"].append(g_sum / steps_per_epoch)
        if verbose:
            print("epoch %d  d_loss=%.3f  g_loss=%.3f"
                  % (epoch, history["d"][-1], history["g"][-1]))
    return gen, disc, history


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=32)
    args = p.parse_args(argv)
    train(epochs=args.epochs, batch_size=args.batch_size)


if __name__ == "__main__":
    main()
