"""Shared reference runs for the port's zoo tests (not a test module):
one network per vision family, built, run and trained one sgd step in
the JAX package, hybridized so that each graph is one compile.

DenseNet's training runs use DenseNet(32, 16, [2, 2, 2, 2]), the family's
class at a depth whose JAX compile fits the CPU test budget; its logits
and names use densenet121 itself."""
import contextlib
import functools

import numpy as np

import jax
import mxnet_tpu as jmx
from mxnet_tpu.gluon import block as jblock
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ops import registry as jregistry

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

# family -> (network, smallest input side, has BatchNorm).  The smallest
# input each architecture takes: 32x32 where it can, 224 for AlexNet,
# 299 for Inception.
FAMILIES = {
    "resnet_v1": ("resnet18_v1", 32, True),
    "resnet_v2": ("resnet18_v2", 32, True),
    "vgg": ("vgg11_bn", 32, True),
    "alexnet": ("alexnet", 224, False),
    "densenet": ("densenet121", 32, True),
    "squeezenet": ("squeezenet1.1", 32, False),
    "inception": ("inceptionv3", 299, True),
    "mobilenet": ("mobilenet0.25", 32, True),
    "mobilenet_v2": ("mobilenetv2_0.25", 32, True),
}
# the families with BatchNorm and no Dropout, which also train one step
# in training mode, at 64x64: at 32x32 their last BatchNorms see 1x1
# maps, 2 values a channel at batch 2
BN_TRAIN = ("resnet_v1", "resnet_v2", "densenet", "mobilenet",
            "mobilenet_v2")
BN_SIDE = 64
SMALL_DENSENET = dict(num_init_features=32, growth_rate=16,
                      block_config=[2, 2, 2, 2])
CLASSES, BATCH = 10, 2
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


def batch(side, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, 3, side, side).astype(np.float32)
    y = rng.randint(0, CLASSES, BATCH).astype(np.float32)
    return x, y


def _np_params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def build(pkg, family, small):
    """``family``'s network in ``pkg`` (classes 10) under a fresh name
    scope; ``small`` takes the small DenseNet."""
    vision = jvision if pkg is jmx else tvision
    with pkg.name.NameManager():
        if small and family == "densenet":
            return vision.DenseNet(classes=CLASSES, **SMALL_DENSENET)
        return vision.get_model(FAMILIES[family][0], classes=CLASSES)


@contextlib.contextmanager
def reference_relu_gradient():
    """Inside, the JAX package's relu (``Activation(act_type='relu')``
    and ``relu``) has the reference MXNet's derivative at 0, which is 0
    (mshadow_op::relu_grad, a > 0); the port's is the same (F.relu).  The
    JAX op is jnp.maximum(x, 0), whose derivative at a tie is 1/2.  It
    differs only where a relu input is exactly 0, and in the zoo that is
    common: a dead channel (all zeros after a relu) stays exactly zero
    through a bias-free convolution and a BatchNorm, in predict mode and
    in training (its batch mean and variance are 0).  There the JAX
    package passes half the gradient and the reference none; the tests
    of the zoo's gradients hold the port to the reference's rule."""
    act, relu = jregistry.get_op("Activation"), jregistry.get_op("relu")
    fns = act.fn, relu.fn

    def activation(data, act_type="relu", **kw):
        if (act_type or "relu") == "relu":
            return jax.nn.relu(data)
        return fns[0](data, act_type=act_type, **kw)

    act.fn, relu.fn = activation, lambda data, **kw: jax.nn.relu(data)
    try:
        yield
    finally:
        act.fn, relu.fn = fns


@functools.lru_cache(maxsize=None)
def jax_step(family, train):
    """One hybridized JAX sgd step of ``family`` from Xavier (magnitude
    2, seed 0) weights, relu's derivative at 0 the reference's.  With
    ``train`` False: densenet121 at the smallest input, under
    ``record(train_mode=False)`` (BatchNorm on its moving stats, Dropout
    off), so the forward gives the predict-mode logits.  With ``train``:
    the small DenseNet, at 64x64, in training mode.  Returns the initial
    weights, the logits, the loss, the gradients and the weights after
    the step (moving stats included)."""
    side = BN_SIDE if train else FAMILIES[family][1]
    x, y = batch(side, seed=1)
    jmx.random.seed(0)
    net = build(jmx, family, small=train)
    net.initialize(jmx.init.Xavier(magnitude=2))
    jblock._abstract_eval_forward(net, [jmx.nd.array(x)])
    w0 = _np_params(net)
    net.hybridize()
    trainer = jmx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with reference_relu_gradient():
        with jmx.autograd.record(train_mode=train):
            out = net(jmx.nd.array(x))
            loss = loss_fn(out, jmx.nd.array(y))
        loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in
             net.collect_params().items() if p.grad_req != "null"}
    trainer.step(BATCH)
    return {"w0": w0, "logits": out.asnumpy(), "loss": loss.asnumpy(),
            "grads": grads, "w1": _np_params(net), "x": x, "y": y}


def port_step(family, train, ref):
    """The port's network of ``family`` on the CPU from ``ref``'s initial
    weights, and the same step: returns (net, trainer, logits, loss)."""
    net = build(tmx, family, small=train)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    x = tmx.nd.array(ref["x"], ctx=tmx.cpu())
    with tmx.autograd.pause():
        net(x)
    tmx.convert.load_from_numpy(net, ref["w0"])
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record(train_mode=train):
        out = net(x)
        loss = loss_fn(out, tmx.nd.array(ref["y"], ctx=tmx.cpu()))
    loss.backward()
    return net, trainer, out.asnumpy(), loss.asnumpy()


def assert_close_to_largest(got, want, rel, what, scale=None):
    """|got - want| <= rel * scale elementwise, the scale max|want| unless
    given (a scale for values that cross zero)."""
    if scale is None:
        scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= rel * scale, "%s: max |d| %g > %g x %g" % (
        what, err, rel, scale)
    return err / scale
