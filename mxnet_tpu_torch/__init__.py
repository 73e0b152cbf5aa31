"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

Import as ``import mxnet_tpu_torch as mx``: the same MXNet-shaped surface
(``mx.nd``, ``mx.autograd``, ``mx.gluon``, ``mx.kv``, ``mx.optimizer``,
``mx.init``) on ``torch.Tensor`` storage.  Entry points run on
``gpu(0)`` (``cuda:0``) unless the caller passes ``mx.cpu()``.  This
package imports neither jax nor mxnet_tpu.

Ported so far: the gluon training path ``Trainer`` -> ``KVStore`` ->
``GradientCompression`` over the ResNet v1 model zoo, with the two 2-bit
compression kernels written by hand in CUDA (``kernels/``); flash
attention (``ops.attention``, its forward a CUDA kernel) and the ring and
Ulysses sequence-parallel engines over a ``torch.distributed`` device
mesh (``parallel``); ``parallel.ShardedTrainer`` on one card under the
``dtype_policy`` precision policies (``bf16_mixed``: bf16 compute, f32
master parameters, dynamic loss scaling); the op registry with ``mx.nd``
generated from it, and the transformer LM's serving path
(``examples.transformer_lm`` -> ``generate.GenerationEngine``, the ring
KV-cache engine, and ``generate.PagedGenerationEngine`` ->
``generate.TokenServer``, with the typed errors of ``serving_async``);
the vision model zoo (34 networks) and the eager gluon training loop of
``examples.train_imagenet``, with ``gluon.nn``, ``gluon.loss``, the 15
optimizers, ``lr_scheduler``, ``metric`` and the Trainer's fused SGD
update; the imperative core (the whole NDArray with ``save``/``load`` in
both formats, ``autograd.grad`` and ``Function``, the ``engine`` facade,
``runtime.Features``, ``util``, the aliases, ``linalg_*``, ordering and
random ops of the registry and ``mx.random``'s samplers) and the weight
store (``Parameter``/``Block`` save, load, cast and ``reset_ctx``, the
initializers, ``gluon.utils.download`` and ``model_zoo.model_store``
behind ``get_model(pretrained=True)``), with ``examples.dcgan``; and the
data pipeline: ``recordio``, ``image`` (decode, augmenters, ``ImageIter``,
the detection augmenters and ``ImageDetIter``), ``io`` (``NDArrayIter``,
the file iterators, ``ImageRecordIter`` with its uint8 upload and
normalization on the card, ``DevicePrefetcher``), ``native`` and
``storage`` (the C++ record reader and JPEG batch decoder, built on
first use into ``_build/``) and ``gluon.data`` (datasets, samplers,
``DataLoader``, vision datasets and transforms), behind
``examples.train_imagenet --data-train``; and the symbolic API with
``hybridize()``: ``mx.sym`` (``symbol``), ``executor``, ``mx.mod``
(``module``), ``model``, ``callback``, ``monitor.Monitor``,
``visualization``, the output ops, and ``CachedOp``, ``export`` and
``SymbolBlock`` over ``torch.compile`` (``jit``), behind both paths of
``examples.train_mnist``; and the recurrent family and graph fusion: the
``RNN`` op (cuDNN's RNN a layer on the card), the Sequence ops, control
flow (``mx.nd.contrib``/``mx.sym.contrib`` foreach, while_loop, cond),
``gluon.rnn``, ``gluon.contrib``, ``mx.rnn``, the fused ops, the
fusion passes (``mx.sym.fusion``) and their cost table
(``fusion_cost``), behind ``examples.word_language_model`` and
``examples.rnn_bucketing``; and the observability layer: ``telemetry``
(the metric registry, its scrape endpoint and ``/statusz``), ``tracing``
(spans, the Chrome trace and the flight recorder), ``profiler`` (over
``torch.profiler``), ``events`` (wide events), ``perf_ledger``,
``goodput`` and ``fleet``, fed by the trainers, the engines and
``TokenServer``; and ``remat`` (activation rematerialisation on
``torch.utils.checkpoint`` for ShardedTrainer, hybridize, Executor and
Module), the persistent compile cache (``config.enable_compile_cache``,
on at import unless ``MXNET_COMPILE_CACHE=0``), ``cpu_pinned`` and the
small ``contrib`` modules (autograd, io, tensorboard, tensorrt,
svrg_optimization, text), behind ``examples.fine_tune`` and
``tools.im2rec``; and fault-tolerant checkpointing: ``CheckpointManager``
(dense and sharded, digest-verified, async, preemption flush) behind
``ShardedTrainer.attach_checkpoint_manager`` and
``Module.fit(checkpoint_manager=)``, the fault-injection helpers of
``testing.faults`` and the observability CLIs under ``tools``.
"""
from .base import MXNetError  # noqa: F401
from .context import (Context, cpu, gpu, cpu_pinned, current_context,  # noqa: F401
                      num_gpus)
from . import name  # noqa: F401
from .name import NameManager  # noqa: F401
from . import random  # noqa: F401
from . import random as rnd  # noqa: F401
from . import config  # noqa: F401
from . import engine  # noqa: F401
from . import runtime  # noqa: F401
from . import util  # noqa: F401
from . import dtype_policy  # noqa: F401
from . import autograd  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from . import lr_scheduler  # noqa: F401
from . import metric  # noqa: F401
from . import contrib  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import gluon  # noqa: F401
from . import convert  # noqa: F401
from . import parallel  # noqa: F401
from . import serving_async  # noqa: F401
from . import generate  # noqa: F401
from . import recordio  # noqa: F401
from . import native  # noqa: F401
from . import storage  # noqa: F401
from . import image  # noqa: F401
from . import io  # noqa: F401
from . import attribute  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from .symbol import Symbol  # noqa: F401
from . import executor  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from . import model  # noqa: F401
from .model import FeedForward  # noqa: F401
from . import callback  # noqa: F401
from . import monitor  # noqa: F401
from .monitor import Monitor  # noqa: F401
from . import visualization  # noqa: F401
from . import visualization as viz  # noqa: F401
from . import test_utils  # noqa: F401
from . import remat  # noqa: F401
from . import fusion_cost  # noqa: F401
from . import rnn  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from . import profiler  # noqa: F401
from . import telemetry  # noqa: F401  (MXNET_TELEMETRY enables at import)
from . import tracing  # noqa: F401  (MXNET_TRACE / MXNET_FLIGHT_RECORDER)
from . import events  # noqa: F401  (MXNET_EVENTS wide-event layer)
from . import checkpoint  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401

config.warn_unknown()
if config.get("MXNET_PROFILER_AUTOSTART"):
    profiler.start()
if config.get("MXNET_COMPILE_CACHE"):
    # the persistent compile cache (inductor's FX-graph and AOTAutograd
    # caches on disk): a second process compiling the same graph loads
    # it.  MXNET_COMPILE_CACHE=0 opts out; MXNET_COMPILE_CACHE_DIR moves
    # it.
    config.enable_compile_cache()
else:
    config.disable_compile_cache()
