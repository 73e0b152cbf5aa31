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
KV-cache engine -> ``generate.TokenServer``, with the typed errors of
``serving_async``).
"""
from .base import MXNetError  # noqa: F401
from .context import Context, cpu, gpu, current_context  # noqa: F401
from . import name  # noqa: F401
from . import random  # noqa: F401
from . import config  # noqa: F401
from . import dtype_policy  # noqa: F401
from . import autograd  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import optimizer  # noqa: F401
from . import contrib  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import gluon  # noqa: F401
from . import convert  # noqa: F401
from . import parallel  # noqa: F401
from . import serving_async  # noqa: F401
from . import generate  # noqa: F401
