"""Ring-split pairwise correlation over the voxel dimension.

PyTorch counterpart of ``brainiak_tpu.ops.ring``: the single-axis entry
point to the SUMMA ring of :mod:`brainiak_tpu_torch.ops.distla`.  The
voxel axis is split over the mesh's ``axis_name`` positions; each keeps
its columns resident while the others' panels visit it, so a position
holds O(V/n) of the data and O(V^2/n) of the result.
"""

from .distla import summa_gram

__all__ = ["ring_correlation"]


def ring_correlation(data, mesh, data_b=None, axis_name="voxel"):
    """All-pairs Pearson correlation of the columns of ``data`` (against
    the columns of ``data_b`` when given) with the voxel axis split
    around a ring.

    data : [T, V] (V divisible by the mesh axis size); data_b :
    optional [T, V], for corr[i, j] = r(data[:, i], data_b[:, j]).
    Returns corr [V, V] float32 on the mesh's first device.
    """
    n_shards = mesh.shape[axis_name]
    v = data.shape[1]
    if v % n_shards:
        raise ValueError(
            f"voxel count {v} must be divisible by the {axis_name} axis "
            f"size ({n_shards})")
    if data_b is not None and tuple(data_b.shape) != tuple(data.shape):
        raise ValueError("data_b must have the same shape as data")
    return summa_gram(data, mesh, data_b=data_b, axis_names=(axis_name,))
