"""Parallelism primitives over ``torch.distributed``: mesh construction,
sharding rules, collectives, pipeline stages and ring attention (port of
``skypilot_tpu/parallel/``)."""
from skypilot_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from skypilot_tpu_torch.parallel.sharding import (ShardingRules,
                                                  logical_sharding,
                                                  shard_pytree)

__all__ = ['MeshSpec', 'build_mesh', 'ShardingRules', 'logical_sharding',
           'shard_pytree']
