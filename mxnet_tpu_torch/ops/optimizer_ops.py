"""Optimizer update ops (parity: mxnet_tpu/ops/optimizer_ops.py:20-177;
reference src/operator/optimizer_op.cc).

Each op computes the JAX op's expression in the same order, then writes
the new weight and states into the input tensors listed in
``mutate_inputs`` (``copy_`` under ``torch.no_grad``), as the reference's
kernels update in place; it returns those same tensors, so the NDArray
handles keep their buffers.  The ``mp_`` variants keep an f32 master copy
of an f16 or bf16 weight.
"""
from __future__ import annotations

import torch

from .registry import register
from .utils import pfloat

__all__ = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "nag_mom_update", "adam_update",
           "signsgd_update", "signum_update", "rmsprop_update",
           "rmspropalex_update", "ftrl_update", "ftml_update",
           "adamw_update"]


def _clip(g, clip_gradient):
    cg = pfloat(clip_gradient, -1.0)
    if cg is not None and cg > 0:
        g = torch.clamp(g, -cg, cg)
    return g


def _prep(grad, rescale_grad, clip_gradient, wd, weight):
    """rescale -> clip -> + wd * weight."""
    g = _clip(grad * pfloat(rescale_grad, 1.0), clip_gradient)
    return g + pfloat(wd, 0.0) * weight


def _write(dsts, srcs):
    for d, s in zip(dsts, srcs):
        d.copy_(s)
    return dsts[0] if len(dsts) == 1 else tuple(dsts)


@register("sgd_update", num_inputs=2, mutate_inputs=(0,),
          differentiable=False)
def sgd_update(weight, grad, lr=None, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True, **kw):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    return _write([weight], [weight - pfloat(lr) * g])


@register("sgd_mom_update", num_inputs=3, mutate_inputs=(0, 2),
          differentiable=False)
def sgd_mom_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                   **kw):
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = pfloat(momentum, 0.0) * mom - pfloat(lr) * g
    return _write([weight, mom], [weight + new_mom, new_mom])


@register("mp_sgd_update", num_inputs=3, mutate_inputs=(0, 2),
          differentiable=False)
def mp_sgd_update(weight, grad, weight32, lr=None, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True, **kw):
    g = _prep(grad.to(torch.float32), rescale_grad, clip_gradient, wd,
              weight32)
    w32 = weight32 - pfloat(lr) * g
    return _write([weight, weight32], [w32.to(weight.dtype), w32])


@register("mp_sgd_mom_update", num_inputs=4, mutate_inputs=(0, 2, 3),
          differentiable=False)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=None, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True, **kw):
    g = _prep(grad.to(torch.float32), rescale_grad, clip_gradient, wd,
              weight32)
    new_mom = pfloat(momentum, 0.0) * mom - pfloat(lr) * g
    w32 = weight32 + new_mom
    return _write([weight, mom, weight32], [w32.to(weight.dtype), new_mom,
                                            w32])


@register("nag_mom_update", num_inputs=3, mutate_inputs=(0, 2),
          differentiable=False)
def nag_mom_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, **kw):
    lr = pfloat(lr)
    mu = pfloat(momentum, 0.0)
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = mu * mom + g
    return _write([weight, mom], [weight - lr * (g + mu * new_mom), new_mom])


@register("adam_update", num_inputs=4, mutate_inputs=(0, 2, 3),
          differentiable=False)
def adam_update(weight, grad, mean, var, lr=None, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True, **kw):
    b1, b2 = pfloat(beta1, 0.9), pfloat(beta2, 0.999)
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_mean = b1 * mean + (1 - b1) * g
    new_var = b2 * var + (1 - b2) * torch.square(g)
    w = weight - pfloat(lr) * new_mean / (torch.sqrt(new_var)
                                         + pfloat(epsilon, 1e-8))
    return _write([weight, mean, var], [w, new_mean, new_var])


@register("signsgd_update", num_inputs=2, mutate_inputs=(0,),
          differentiable=False)
def signsgd_update(weight, grad, lr=None, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, **kw):
    g = _prep(grad, rescale_grad, clip_gradient, 0.0, weight)
    return _write([weight], [weight - pfloat(lr) * (
        torch.sign(g) + pfloat(wd, 0.0) * weight)])


@register("signum_update", num_inputs=3, mutate_inputs=(0, 2),
          differentiable=False)
def signum_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, **kw):
    mu = pfloat(momentum, 0.0)
    g = _prep(grad, rescale_grad, clip_gradient, pfloat(wd, 0.0), weight)
    new_mom = mu * mom - (1 - mu) * g
    w = weight + pfloat(lr) * (torch.sign(new_mom)
                               - pfloat(wd_lh, 0.0) * weight)
    return _write([weight, mom], [w, new_mom])


@register("rmsprop_update", num_inputs=3, mutate_inputs=(0, 2),
          differentiable=False)
def rmsprop_update(weight, grad, n, lr=None, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0, **kw):
    g1 = pfloat(gamma1, 0.95)
    g = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = (1 - g1) * torch.square(g) + g1 * n
    w = weight - pfloat(lr) * g / torch.sqrt(new_n + pfloat(epsilon, 1e-8))
    cw = pfloat(clip_weights, -1.0)
    if cw and cw > 0:
        w = torch.clamp(w, -cw, cw)
    return _write([weight, n], [w, new_n])


@register("rmspropalex_update", num_inputs=5, mutate_inputs=(0, 2, 3, 4),
          differentiable=False)
def rmspropalex_update(weight, grad, n, g, delta, lr=None, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0, **kw):
    g1, g2 = pfloat(gamma1, 0.95), pfloat(gamma2, 0.9)
    gr = _prep(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = (1 - g1) * torch.square(gr) + g1 * n
    new_g = (1 - g1) * gr + g1 * g
    new_delta = g2 * delta - pfloat(lr) * gr / torch.sqrt(
        new_n - torch.square(new_g) + pfloat(epsilon, 1e-8))
    return _write([weight, n, g, delta],
                  [weight + new_delta, new_n, new_g, new_delta])


@register("ftrl_update", num_inputs=4, mutate_inputs=(0, 2, 3),
          differentiable=False)
def ftrl_update(weight, grad, z, n, lr=None, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, **kw):
    # a product with 1 / lr, not a quotient: CUDA divides a tensor by a
    # scalar as that product, the CPU does not, and the L1 step's
    # cancellation (|z| - lamda1) magnifies their last-bit difference
    inv_lr = 1.0 / pfloat(lr)
    l1 = pfloat(lamda1, 0.01)
    b = pfloat(beta, 1.0)
    g = _clip(grad * pfloat(rescale_grad, 1.0), clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) * inv_lr
    new_z = z + g - sigma * weight
    w = torch.where(
        torch.abs(new_z) <= l1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * l1)
        / ((b + torch.sqrt(new_n)) * inv_lr + pfloat(wd, 0.0)))
    return _write([weight, z, n], [w, new_z, new_n])


@register("ftml_update", num_inputs=5, mutate_inputs=(0, 2, 3, 4),
          differentiable=False)
def ftml_update(weight, grad, d, v, z, lr=None, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0, t=1,
                **kw):
    b1, b2 = pfloat(beta1, 0.6), pfloat(beta2, 0.999)
    lr = pfloat(lr)
    t = pfloat(t, 1)
    g = _clip(grad * pfloat(rescale_grad, 1.0) + pfloat(wd, 0.0) * weight,
              clip_grad)
    new_v = b2 * v + (1 - b2) * torch.square(g)
    d_t = (1 - b1 ** t) / lr * (torch.sqrt(new_v / (1 - b2 ** t))
                                + pfloat(epsilon, 1e-8))
    sigma = d_t - b1 * d
    new_z = b1 * z + (1 - b1) * g - sigma * weight
    return _write([weight, d, v, z], [-new_z / d_t, d_t, new_v, new_z])


@register("adamw_update", num_inputs=5, mutate_inputs=(0, 2, 3),
          differentiable=False,
          aliases=("_contrib_adamw_update", "_adamw_update"))
def adamw_update(weight, grad, mean, var, rescale_grad_arr=None, lr=None,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 rescale_grad=1.0, clip_gradient=-1.0, **kw):
    """Adam with decoupled weight decay; the rescale comes from the
    optional fifth input (a tensor) or ``rescale_grad``."""
    b1, b2 = pfloat(beta1, 0.9), pfloat(beta2, 0.999)
    scale = rescale_grad_arr if rescale_grad_arr is not None \
        else pfloat(rescale_grad, 1.0)
    g = _clip(grad * scale, clip_gradient)
    new_mean = b1 * mean + (1 - b1) * g
    new_var = b2 * var + (1 - b2) * torch.square(g)
    w = weight - pfloat(eta, 1.0) * (
        pfloat(lr) * new_mean / (torch.sqrt(new_var) + pfloat(epsilon, 1e-8))
        + pfloat(wd, 0.0) * weight)
    return _write([weight, mean, var], [w, new_mean, new_var])
