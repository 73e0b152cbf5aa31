"""Rematerialisation on the card: the eager ShardedTrainer's recompute
runs on the autograd engine's device thread there, and ``offload_dots``
parks its dot outputs in pinned host memory, neither of which a CPU run
reaches.  The small bottleneck ResNet of ``test_torch_remat.py`` with a
Dropout at rate 0.5, batch 4, 3 sgd steps on the card with deterministic
cuDNN: every policy's losses, parameters and moving stats bit-equal to
remat off.  Skips without a CUDA card; on the card::

    python -m pytest --noconftest -q tests/test_torch_remat_cuda.py
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.name import NameManager

POLICIES = ["full", "nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable", "everything_saveable",
            "offload_dots"]


def _run(policy):
    mx.random.seed(0)
    with NameManager():
        net = vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                              [16, 32, 64, 128, 256], classes=10)
    net.features.add(mx.gluon.nn.Dropout(0.5))
    ctx = mx.gpu(0)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    rng = np.random.RandomState(0)
    xs = [mx.nd.array(rng.randn(4, 3, 32, 32).astype(np.float32), ctx=ctx)
          for _ in range(3)]
    ys = [mx.nd.array(rng.randint(0, 10, 4).astype(np.float32), ctx=ctx)
          for _ in range(3)]
    with mx.autograd.pause():
        net(xs[0][0:2])
    tr = parallel.ShardedTrainer(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
        remat_policy=policy)
    losses = [float(tr.step([x], y)) for x, y in zip(xs, ys)]
    return losses, [a.clone() for a in tr.param_arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_on_the_card_is_bit_equal_to_remat_off(policy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = _run(None)
        got = _run(policy)
    finally:
        torch.backends.cudnn.deterministic = prev
    assert got[0] == ref[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
    assert all(np.isfinite(got[0]))
