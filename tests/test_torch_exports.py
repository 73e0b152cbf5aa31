"""Faults 11 and 12 of the port: every name the JAX package exports in
the top-level, ``contrib``, ``gluon``, ``gluon.utils``, ``context``,
``operator``, ``rtc`` and ``contrib.onnx`` namespaces resolves after
``import mxnet_tpu_torch as mx``, except the deliberate exclusions below; and ``cpu_pinned``, ``num_gpus``,
``default_context`` and ``device`` behave as the JAX package's on CPU.
"""
import ast

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx

# names the port leaves out on purpose, with the reason
EXCLUDED = {
    "": {
        "tpu": "names a device this card is not",
        "num_tpus": "names a device this card is not",
        "MXTpuError": "the TPU spelling of MXNetError",
    },
    "context": {
        "tpu": "names a device this card is not",
        "num_tpus": "names a device this card is not",
    },
}
NAMESPACES = ["", "contrib", "gluon", "gluon.utils", "context", "operator",
              "rtc", "contrib.onnx"]


def _module(pkg, path):
    for part in filter(None, path.split(".")):
        pkg = getattr(pkg, part)
    return pkg


def _exported(module):
    """The names ``module`` exports: its ``__all__``, or for a package the
    names its ``__init__`` binds (imports and assignments), so that
    submodules imported later by other code do not count."""
    if not module.__file__.endswith("__init__.py"):
        return set(module.__all__)
    tree = ast.parse(open(module.__file__).read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
    return {n for n in out if not n.startswith("_")}


@pytest.mark.parametrize("path", NAMESPACES)
def test_every_jax_name_exists_in_the_port(path):
    want = _exported(_module(jmx, path))
    got = set(dir(_module(tmx, path)))
    excluded = EXCLUDED.get(path, {})
    assert sorted(want - got - set(excluded)) == []
    # an exclusion that the JAX package no longer exports is stale
    assert set(excluded) <= want
    assert not set(excluded) & got


@pytest.mark.parametrize("name", [
    "Symbol", "Optimizer", "Monitor", "FeedForward", "NameManager"])
def test_exported_classes_are_the_ported_ones(name):
    src = {"Symbol": tmx.symbol, "Optimizer": tmx.optimizer,
           "Monitor": tmx.monitor, "FeedForward": tmx.model,
           "NameManager": tmx.name}[name]
    assert getattr(tmx, name) is getattr(src, name)


def test_aliases_and_submodules():
    assert tmx.rnd is tmx.random and tmx.viz is tmx.visualization
    assert tmx.test_utils.__name__ == "mxnet_tpu_torch.test_utils"
    x = tmx.nd.array(np.arange(6, dtype=np.float32), ctx=tmx.cpu())
    outs = tmx.contrib.ndarray.foreach(lambda d, s: (d * 2, s), x, [])
    np.testing.assert_array_equal(outs[0].asnumpy(),
                                  np.arange(6, dtype=np.float32) * 2)
    assert tmx.gluon.Constant is tmx.gluon.parameter.Constant


@pytest.mark.parametrize("pkg", [jmx, tmx], ids=["jax", "torch"])
def test_shape_is_known(pkg):
    f = pkg.gluon.utils.shape_is_known
    assert f((2, 3)) and f(())
    assert not f(None) and not f((2, 0)) and not f((None, 3))


def test_context_names_match_jax():
    for mx in (jmx, tmx):
        c = mx.cpu_pinned(1)
        assert (c.device_type, c.device_typeid, c.device_id) == \
            ("cpu_pinned", 3, 1)
        assert str(c) == "cpu_pinned(1)"
        assert mx.context.device is mx.Context
        assert mx.Context("cpu_pinned") == mx.cpu_pinned()
        assert mx.cpu_pinned() != mx.cpu()
    assert tmx.num_gpus() == torch.cuda.device_count()
    assert tmx.context.default_context() == tmx.gpu(0)
    assert tmx.current_context() == tmx.gpu(0)
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()


def test_cpu_pinned_arrays_live_on_the_host():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    a = tmx.nd.array(x, ctx=tmx.cpu_pinned())
    j = jmx.nd.array(x, ctx=jmx.cpu_pinned())
    np.testing.assert_array_equal(a.asnumpy(), j.asnumpy())
    assert a._data.device.type == "cpu"
    z = tmx.nd.zeros((2, 2), ctx=tmx.cpu_pinned())
    assert z._data.device.type == "cpu"
    c = tmx.nd.array(x, ctx=tmx.cpu()).copyto(tmx.cpu_pinned())
    np.testing.assert_array_equal(c.asnumpy(), x)
    # page-locked only where a card is present
    assert a._data.is_pinned() == torch.cuda.is_available()
    assert a.context == (tmx.cpu_pinned() if torch.cuda.is_available()
                         else tmx.cpu())


@pytest.mark.cuda
def test_cpu_pinned_is_page_locked_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = tmx.nd.array(np.ones((4, 4), np.float32), ctx=tmx.cpu_pinned())
    assert a._data.is_pinned() and a.context == tmx.cpu_pinned()
    g = a.copyto(tmx.gpu(0))
    assert g._data.is_cuda and g.context == tmx.gpu(0)
