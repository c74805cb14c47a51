"""Device mesh and placement helpers of the port (single process).

The JAX package's multi-process pieces (``initialize_distributed``,
the multi-process branches of ``fetch_replicated`` and
``place_on_mesh``) and its jax shims (``parallel/compat.py``,
``parallel/testing.py``) have no counterpart yet.
"""

from .mesh import (DEFAULT_SUBJECT_AXIS, DEFAULT_VOXEL_AXIS, Mesh,
                   Sharded, axis_devices, fetch_replicated, make_mesh,
                   max_divisible_shards, replicated, shard_along,
                   subject_voxel_mesh)

__all__ = ["DEFAULT_SUBJECT_AXIS", "DEFAULT_VOXEL_AXIS", "Mesh",
           "Sharded", "axis_devices", "fetch_replicated", "make_mesh",
           "max_divisible_shards", "replicated", "shard_along",
           "subject_voxel_mesh"]
