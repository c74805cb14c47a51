"""A single-process device mesh and the placement helpers around it.

PyTorch counterpart of ``brainiak_tpu/parallel/mesh.py``.  A
:class:`Mesh` names the axes of an array of ``torch.device``; the
helpers lay an array out along some of those axes, one piece per mesh
position.  One process drives every device of the mesh, so the ring
and the per-voxel computations of :mod:`brainiak_tpu_torch.ops.distla`
and :mod:`brainiak_tpu_torch.isc` run each piece on its device in a
Python loop; there are no collectives.

A device may be repeated: ``make_mesh(("voxel",), (4,),
devices=["cuda"] * 4)`` is a 4-position mesh on one card, and
``devices=["cpu"] * 4`` one on the CPU.  One device then stands in for
n, as the JAX package's tests stand a CPU in for 8 devices
(``--xla_force_host_platform_device_count=8``): the programs run with
the same shard count and the same data movement between positions,
which on one device is a hand-over with no copy.
"""

import numpy as np
import torch

__all__ = [
    "DEFAULT_SUBJECT_AXIS",
    "DEFAULT_VOXEL_AXIS",
    "Mesh",
    "Sharded",
    "axis_devices",
    "fetch_replicated",
    "make_mesh",
    "max_divisible_shards",
    "replicated",
    "shard_along",
    "subject_voxel_mesh",
]

DEFAULT_SUBJECT_AXIS = "subject"
DEFAULT_VOXEL_AXIS = "voxel"


class Mesh:
    """Named axes over an array of ``torch.device``.

    ``devices`` is a numpy object array whose dimensions are the axes,
    ``axis_names`` their names and ``shape`` the mapping axis -> size
    (as ``jax.sharding.Mesh.shape``).
    """

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"{devices.ndim}-D device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def _visible_cuda_devices():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh spans every visible CUDA device by default and none "
            "is available; pass devices=['cpu'] * n for a CPU mesh")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _as_device(dev):
    dev = torch.device(dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {dev} needs CUDA, which is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def max_divisible_shards(axis_length, devices=None):
    """Largest shard count that divides ``axis_length`` and fits the
    devices (default: every visible CUDA device)."""
    n = len(_visible_cuda_devices() if devices is None else devices)
    return max(d for d in range(1, n + 1) if axis_length % d == 0)


def make_mesh(axis_names, axis_sizes, devices=None):
    """A :class:`Mesh` with the given axes over ``devices`` (default:
    every visible CUDA device; raises ``RuntimeError`` when there is
    none).  ``axis_sizes`` may hold one -1, filled with the remaining
    devices.  A device may be repeated (see the module docstring)."""
    devices = _visible_cuda_devices() if devices is None \
        else [_as_device(d) for d in devices]
    sizes = list(axis_sizes)
    n = len(devices)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if known <= 0 or n % known:
            raise ValueError(
                f"Cannot infer -1 axis from {n} devices and sizes {sizes}")
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"Mesh of {sizes} needs {total} devices, have {n}")
    grid = np.empty(total, dtype=object)
    grid[:] = devices[:total]
    return Mesh(grid.reshape(sizes), axis_names)


def subject_voxel_mesh(n_subject_shards=-1, n_voxel_shards=1,
                       devices=None):
    """The standard 2-D mesh ``('subject', 'voxel')``."""
    return make_mesh((DEFAULT_SUBJECT_AXIS, DEFAULT_VOXEL_AXIS),
                     (n_subject_shards, n_voxel_shards), devices)


def _axis_tuple(axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_devices(mesh, axes):
    """The device of each position along ``axes`` (one name, or
    several flattened row-major in the order given), the other axes at
    their first position."""
    axes = _axis_tuple(axes)
    missing = [a for a in axes if a not in mesh.shape]
    if missing:
        raise ValueError(f"axes {missing} not in mesh axes "
                         f"{mesh.axis_names}")
    sub = mesh.devices[tuple(slice(None) if a in axes else 0
                             for a in mesh.axis_names)]
    kept = [a for a in mesh.axis_names if a in axes]
    sub = np.transpose(sub, [kept.index(a) for a in axes])
    return list(sub.reshape(-1))


class Sharded:
    """An array laid out on a mesh: ``chunks[k]`` is its k-th piece
    along ``dim``, split over the mesh axes ``axes`` (empty: one whole
    piece, replicated), a tensor on ``devices[k]``.

    One process computes each piece once, so a piece lives on the first
    device of the mesh slice that holds it; its replicas along the
    other axes are not materialised.
    """

    def __init__(self, chunks, devices, dim, axes):
        self.chunks = list(chunks)
        self.devices = list(devices)
        self.dim = dim
        self.axes = tuple(axes)


def shard_along(array, mesh, axis_name, array_dim=0):
    """Lay ``array`` (numpy or tensor) out on ``mesh``, split along
    ``array_dim`` over ``axis_name`` (a name or a tuple of names, as in
    a ``PartitionSpec``).  The dimension must divide the axis size.
    Each piece is a contiguous tensor of the array's dtype on its
    device.  Returns a :class:`Sharded`."""
    axes = _axis_tuple(axis_name)
    devices = axis_devices(mesh, axes)
    x = torch.as_tensor(array)
    n = len(devices)
    if x.shape[array_dim] % n:
        raise ValueError(
            f"dimension {array_dim} of size {x.shape[array_dim]} does not "
            f"divide the {n} positions of mesh axes {axes}")
    pieces = torch.tensor_split(x, n, dim=array_dim)
    chunks = [p.to(dev).contiguous() for p, dev in zip(pieces, devices)]
    return Sharded(chunks, devices, array_dim, axes)


def replicated(array, mesh):
    """``array`` whole on ``mesh`` (a :class:`Sharded` of one piece on
    the mesh's first device)."""
    dev = mesh.devices.flat[0]
    return Sharded([torch.as_tensor(array).to(dev)], [dev], 0, ())


def fetch_replicated(x, mesh=None):
    """Host numpy array of ``x``: a :class:`Sharded` (its pieces
    concatenated), a tensor or anything ``np.asarray`` takes.  One
    process holds every piece, so ``mesh`` is not needed; it is kept
    for the JAX package's signature."""
    del mesh
    if isinstance(x, Sharded):
        parts = [c.detach().cpu().numpy() for c in x.chunks]
        return parts[0] if len(parts) == 1 else \
            np.concatenate(parts, axis=x.dim)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
