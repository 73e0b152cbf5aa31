"""Parallelism over a ``torch.distributed`` device mesh (counterpart of
``mxnet_tpu/parallel``): named-axis meshes, ``shard_map`` and collectives
by axis name, the ring and Ulysses sequence-parallel attention engines,
and ``ShardedTrainer`` on one card.  The rest of the JAX package's
``parallel/`` (the sharded trainer over a mesh, layouts, pipeline,
mixture of experts, multi-host bootstrap) is not ported yet.
"""
from .mesh import (make_mesh, local_mesh, MeshConfig, shard_map, P,  # noqa: F401
                   PartitionSpec, parse_mesh, require_axes, mesh_shape,
                   MESH_AXES, DATA_AXES)
from . import collectives  # noqa: F401
from .ring_attention import (ring_attention, ring_attention_sharded,  # noqa: F401
                             local_attention)
from .ulysses import ulysses_attention, ulysses_attention_sharded  # noqa: F401
from .train import ShardedTrainer, sgd_init, adam_init  # noqa: F401
