"""Parallelism over torch.distributed: the process mesh (dp/pp/sp/ep/tp),
partition specs, the collectives with their gradients, the multi-process
bootstrap and the GPipe pipeline (the reference's parallel/).

Where the reference declares shardings and lets XLA's SPMD partitioner
insert the collectives, here every rank holds its local shards and the
model places each collective itself (models/transformer.py,
ops/ring_attention.py, ops/ulysses_attention.py, parallel/pipeline.py),
over gloo on the CPU and NCCL on the card.
"""

from .mesh import MeshConfig, create_mesh  # noqa: F401
from .sharding import param_shardings, shard_params  # noqa: F401
