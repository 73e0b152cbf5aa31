"""The port's vision model zoo against the JAX package's on CPU.

Every one of the 34 ``get_model`` names builds in both packages (classes
1000); after the forward at the smallest input the architecture takes
(32x32 where it can, 224 for AlexNet, 299 for Inception; batch 1), the
port's parameter names, shapes and grad_reqs equal the JAX model's,
whose shapes come from its own deferred-init pass
(``_abstract_eval_forward``, the first stage of its first forward:
shapes only, no compile).  Each family's logits and training step are
in test_torch_zoo_train.py and test_torch_zoo_bn_train.py."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.gluon import block as jblock
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

NAMES = sorted(jvision._models)


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def _side(name):
    return {"alexnet": 224, "inceptionv3": 299}.get(name, 32)


def test_the_zoo_has_the_34_names_of_the_jax_zoo():
    assert len(NAMES) == 34
    assert sorted(tvision._models) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_param_names_and_shapes_match_jax(name):
    x = np.zeros((1, 3, _side(name), _side(name)), np.float32)
    with jmx.name.NameManager():
        jnet = jvision.get_model(name)
    jnet.initialize(jmx.init.Zero())
    jblock._abstract_eval_forward(jnet, [jmx.nd.array(x)])
    with tmx.name.NameManager():
        tnet = tvision.get_model(name)
    tnet.initialize(tmx.init.Zero(), ctx=tmx.cpu())
    with tmx.autograd.pause():
        out = tnet(tmx.nd.array(x, ctx=tmx.cpu()))
    assert out.shape == (1, 1000)
    want = {n: tuple(p.shape) for n, p in jnet.collect_params().items()}
    got = {n: tuple(p.shape) for n, p in tnet.collect_params().items()}
    assert list(got) == list(want)
    assert got == want
    grad_reqs = {n: p.grad_req for n, p in jnet.collect_params().items()}
    assert {n: p.grad_req for n, p in tnet.collect_params().items()} \
        == grad_reqs


def test_get_model_refuses_pretrained_and_unknown_names(tmp_path,
                                                        monkeypatch):
    # pretrained=True with no weights under root and no mirror
    monkeypatch.delenv("MXNET_GLUON_REPO", raising=False)
    with pytest.raises(MXNetError, match="no download mirror"):
        tvision.get_model("resnet18_v1", pretrained=True, root=str(tmp_path))
    with pytest.raises(MXNetError, match="no download mirror"):
        tvision.densenet121(pretrained=True, root=str(tmp_path))
    with pytest.raises(ValueError, match="not supported"):
        tvision.get_model("resnet19_v1")


def test_densenet_and_squeezenet_arguments_match_jax():
    kw = dict(num_init_features=16, growth_rate=8, block_config=[2, 3],
              bn_size=2, dropout=0.1, classes=7)
    x = np.zeros((1, 3, 32, 32), np.float32)
    nets = []
    for pkg, vision in ((tmx, tvision), (jmx, jvision)):
        with pkg.name.NameManager():
            nets.append(vision.DenseNet(**kw))
    nets[0].initialize(ctx=tmx.cpu())
    nets[1].initialize()
    nets[0](tmx.nd.array(x, ctx=tmx.cpu()))
    jblock._abstract_eval_forward(nets[1], [jmx.nd.array(x)])
    assert {n: p.shape for n, p in nets[0].collect_params().items()} == \
        {n: p.shape for n, p in nets[1].collect_params().items()}
    drops = [b for b in nets[0].features[4].body
             if isinstance(b, tmx.gluon.nn.Dropout)]
    assert len(drops) == 1 and drops[0]._rate == 0.1
    with pytest.raises(ValueError):
        tvision.SqueezeNet("1.2")
