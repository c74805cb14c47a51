"""Device mesh and placement helpers of the port, in one process or
across processes over ``torch.distributed``
(:func:`initialize_distributed`), and the multi-process test harness
:mod:`brainiak_tpu_torch.parallel.testing`.

The JAX package's jax shim ``parallel/compat.py`` has no counterpart.
"""

from .mesh import (DEFAULT_SUBJECT_AXIS, DEFAULT_VOXEL_AXIS, Mesh,
                   Sharded, axis_devices, axis_ranks, fetch_replicated,
                   initialize_distributed, make_mesh, max_divisible_shards,
                   place_on_mesh, replicated, shard_along,
                   subject_voxel_mesh)

__all__ = ["DEFAULT_SUBJECT_AXIS", "DEFAULT_VOXEL_AXIS", "Mesh",
           "Sharded", "axis_devices", "axis_ranks", "fetch_replicated",
           "initialize_distributed", "make_mesh", "max_divisible_shards",
           "place_on_mesh", "replicated", "shard_along",
           "subject_voxel_mesh"]
