"""A device mesh, in one process or across processes, and the
placement helpers around it.

PyTorch counterpart of ``brainiak_tpu/parallel/mesh.py``.  A
:class:`Mesh` names the axes of an array of ``torch.device``; the
helpers lay an array out along some of those axes, one piece per mesh
position.

In one process, the process drives every device of the mesh, so the
ring and the per-voxel computations of
:mod:`brainiak_tpu_torch.ops.distla`, :mod:`brainiak_tpu_torch.isc` and
:class:`~brainiak_tpu_torch.fcma.voxelselector.VoxelSelector` run each
piece on its device in a Python loop, with no collective.

A device may be repeated: ``make_mesh(("voxel",), (4,),
devices=["cuda"] * 4)`` is a 4-position mesh on one card, and
``devices=["cpu"] * 4`` one on the CPU.  One device then stands in for
n, as the JAX package's tests stand a CPU in for 8 devices
(``--xla_force_host_platform_device_count=8``): the programs run with
the same shard count and the same data movement between positions,
which on one device is a hand-over with no copy.

Across processes (after :func:`initialize_distributed`, the analog of
``MPI_Init``), :func:`make_mesh` is a collective: the ranks exchange
their local device lists once, and the mesh spans every rank's
devices, each position recording its owning rank in ``Mesh.ranks``.
Each rank then computes only the pieces of its own positions; a
:class:`Sharded` holds ``None`` for the others.  :func:`fetch_replicated`
gathers the pieces (one ``all_gather``), and the callers reduce or
hand panels on with ``torch.distributed`` (NCCL between CUDA devices,
gloo between CPU processes).
"""

import numpy as np
import torch

from ..resilience.retry import retry

__all__ = [
    "DEFAULT_SUBJECT_AXIS",
    "DEFAULT_VOXEL_AXIS",
    "Mesh",
    "Sharded",
    "all_sum",
    "axis_devices",
    "axis_ranks",
    "cat_pieces",
    "comm_device",
    "fetch_replicated",
    "fetch_rows",
    "gather_rows",
    "initialize_distributed",
    "laid_out_rows",
    "local_pieces",
    "local_rows",
    "make_mesh",
    "max_divisible_shards",
    "place_on_mesh",
    "process_index",
    "replicated",
    "shard_along",
    "spans_processes",
    "split_rows",
    "subject_voxel_mesh",
]

DEFAULT_SUBJECT_AXIS = "subject"
DEFAULT_VOXEL_AXIS = "voxel"

#: this rank's devices, the positions it adds to a mesh built with
#: ``devices=None`` (set by :func:`initialize_distributed`)
_local_devices = None


def _dist():
    """``torch.distributed`` while a group of more than one rank is
    up, else None."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return dist
    return None


def process_index():
    """This process's rank (0 without a process group)."""
    dist = _dist()
    return 0 if dist is None else dist.get_rank()


def comm_device():
    """The device of the tensors a collective of this process group
    takes: this rank's CUDA device under NCCL, else the CPU."""
    if torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _transient(exc):
    """A ``RuntimeError`` is retried only when it reads as a transient
    connect failure; a deterministic one (already initialized, a bad
    configuration) propagates at once."""
    if not isinstance(exc, RuntimeError):
        return True
    msg = str(exc).lower()
    return any(tok in msg for tok in
               ("deadline", "unavailable", "connect", "timed out",
                "timeout"))


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None, device="cuda",
                           local_devices=None):
    """Join the process group of a multi-process run: the analog of
    ``MPI_Init`` (the JAX package's ``jax.distributed.initialize``).

    A no-op unless ``num_processes > 1``.  Otherwise it calls
    ``torch.distributed.init_process_group`` at ``coordinator_address``
    (``host:port`` or a URL such as ``tcp://host:port``; ``None`` reads
    ``MASTER_ADDR`` / ``MASTER_PORT``), retried with exponential backoff
    on a transient connect failure: on a fresh or restarted job the
    workers often come up before the coordinator listens.

    backend : ``"nccl"`` for ``device="cuda"``, ``"gloo"`` for
        ``device="cpu"`` when None; a backend this PyTorch lacks
        raises ``RuntimeError``.
    device : ``"cuda"``: the rank takes ``cuda:(rank % device_count)``;
        ``"cpu"``: CPU positions.  ``process_id=None`` reads the rank
        from ``RANK``, as ``init_method="env://"`` does.
    local_devices : the positions this rank adds to a mesh that
        :func:`make_mesh` builds with ``devices=None`` (default: its
        one device).
    """
    global _local_devices
    if num_processes is None or num_processes <= 1:
        return
    dist = torch.distributed
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    available = {"nccl": dist.is_available() and dist.is_nccl_available(),
                 "gloo": dist.is_available() and dist.is_gloo_available()}
    if not available.get(backend, dist.is_available()):
        raise RuntimeError(f"torch.distributed backend {backend!r} is "
                           "not available in this PyTorch")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed(device='cuda') needs "
                           "a CUDA device; pass device='cpu' for CPU "
                           "processes")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    connect = retry(dist.init_process_group, retries=4, backoff=1.0,
                    retriable=(OSError, ConnectionError, RuntimeError),
                    retry_if=_transient,
                    name="torch.distributed.init_process_group")
    connect(backend=backend, init_method=init_method,
            world_size=num_processes,
            rank=-1 if process_id is None else process_id)
    if dev.type == "cuda":
        dev = torch.device("cuda",
                           dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _local_devices = [torch.device(d) for d in local_devices] \
        if local_devices is not None else [dev]


class Mesh:
    """Named axes over an array of ``torch.device``.

    ``devices`` is a numpy object array whose dimensions are the axes,
    ``axis_names`` their names and ``shape`` the mapping axis -> size
    (as ``jax.sharding.Mesh.shape``).  ``ranks`` is None for a mesh of
    one process, else an int array of ``devices``' shape: the rank that
    owns each position.
    """

    def __init__(self, devices, axis_names, ranks=None):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"{devices.ndim}-D device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.ranks = None if ranks is None else \
            np.asarray(ranks, dtype=int).reshape(devices.shape)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def local_devices(self):
        """The distinct devices of this process's positions, in
        position order."""
        if self.ranks is None:
            return list(dict.fromkeys(self.devices.flat))
        me = process_index()
        return list(dict.fromkeys(
            d for d, r in zip(self.devices.flat, self.ranks.flat)
            if r == me))

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


def _default_devices():
    if _dist() is not None and _local_devices is not None:
        return [_as_device(d) for d in _local_devices]
    return _visible_cuda_devices()


def max_divisible_shards(axis_length, devices=None):
    """Largest shard count that divides ``axis_length`` and fits the
    devices (default: every visible CUDA device)."""
    n = len(_visible_cuda_devices() if devices is None else devices)
    return max(d for d in range(1, n + 1) if axis_length % d == 0)


def make_mesh(axis_names, axis_sizes, devices=None):
    """A :class:`Mesh` with the given axes over ``devices`` (default:
    every visible CUDA device, or this rank's devices in a
    multi-process run; raises ``RuntimeError`` when there is none).
    ``axis_sizes`` may hold one -1, filled with the remaining devices.
    A device may be repeated (see the module docstring).

    In a multi-process run every rank calls it (a collective):
    ``devices`` are the rank's own, and the mesh takes the ranks'
    lists in rank order, each position owned by the rank that gave
    its device.  Every rank must own a position.
    """
    devices = _default_devices() if devices is None \
        else [_as_device(d) for d in devices]
    ranks = None
    dist = _dist()
    if dist is not None:
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, [str(d) for d in devices])
        me = dist.get_rank()
        devices = [devices[i] if r == me else torch.device(s)
                   for r, names in enumerate(gathered)
                   for i, s in enumerate(names)]
        ranks = [r for r, names in enumerate(gathered) for _ in names]
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
    if ranks is not None:
        missing = set(range(dist.get_world_size())) - set(ranks[:total])
        if missing:
            raise ValueError(f"a mesh of {sizes} leaves ranks "
                             f"{sorted(missing)} without a position")
        ranks = np.asarray(ranks[:total]).reshape(sizes)
    return Mesh(grid.reshape(sizes), axis_names, ranks)


def subject_voxel_mesh(n_subject_shards=-1, n_voxel_shards=1,
                       devices=None):
    """The standard 2-D mesh ``('subject', 'voxel')``."""
    return make_mesh((DEFAULT_SUBJECT_AXIS, DEFAULT_VOXEL_AXIS),
                     (n_subject_shards, n_voxel_shards), devices)


def _axis_tuple(axes):
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _along(mesh, grid, axes):
    """The entries of ``grid`` (an array of the mesh's shape) at each
    position along ``axes`` (flattened row-major in the order given),
    the other axes at their first position."""
    axes = _axis_tuple(axes)
    missing = [a for a in axes if a not in mesh.shape]
    if missing:
        raise ValueError(f"axes {missing} not in mesh axes "
                         f"{mesh.axis_names}")
    sub = grid[tuple(slice(None) if a in axes else 0
                     for a in mesh.axis_names)]
    kept = [a for a in mesh.axis_names if a in axes]
    sub = np.transpose(sub, [kept.index(a) for a in axes])
    return list(sub.reshape(-1))


def axis_devices(mesh, axes):
    """The device of each position along ``axes`` (one name, or
    several flattened row-major in the order given), the other axes at
    their first position."""
    return _along(mesh, mesh.devices, axes)


def axis_ranks(mesh, axes):
    """The owning rank of each position of :func:`axis_devices`, or
    None for a mesh of one process."""
    if mesh.ranks is None:
        _along(mesh, mesh.devices, axes)   # the same check of the axes
        return None
    return [int(r) for r in _along(mesh, mesh.ranks, axes)]


class Sharded:
    """An array laid out on a mesh: ``chunks[k]`` is its k-th piece
    along ``dim``, split over the mesh axes ``axes`` (empty: whole
    copies, one on each device in ``devices``), a tensor on
    ``devices[k]``.

    A piece lives on the first position of the mesh slice that holds
    it; its replicas along the other axes are not materialised.
    ``ranks`` is None in one process; across processes it holds the
    owning rank of each piece, and ``chunks[k]`` is None where another
    rank owns it.  ``shape``, when given, is the array's shape, which
    the concatenated pieces may exceed by a zero pad (sliced off by
    :func:`fetch_replicated`).
    """

    def __init__(self, chunks, devices, dim, axes, ranks=None,
                 shape=None):
        self.chunks = list(chunks)
        self.devices = list(devices)
        self.dim = dim
        self.axes = tuple(axes)
        self.ranks = None if ranks is None else list(ranks)
        self.shape = None if shape is None else tuple(shape)

    def map(self, fn, dim=None, shape=None):
        """``fn`` on each piece this process holds (the others stay
        None): a :class:`Sharded` of the results along ``dim``
        (default: this one's)."""
        return Sharded([None if c is None else fn(c) for c in self.chunks],
                       self.devices, self.dim if dim is None else dim,
                       self.axes, self.ranks, shape)

    def local(self):
        """``[(k, piece, device)]`` of the pieces this process holds."""
        return [(k, c, d) for k, (c, d) in
                enumerate(zip(self.chunks, self.devices)) if c is not None]

    def on(self, device):
        """The whole copy on ``device`` of a replicated array."""
        if self.axes:
            raise ValueError("a split array has no whole copy")
        return self.chunks[self.devices.index(torch.device(device))]


def place_on_mesh(array, mesh, spec=()):
    """Lay ``array`` (numpy or tensor; this process's own copy) out on
    ``mesh`` by ``spec``, a ``PartitionSpec``-like tuple: an entry per
    leading dimension, ``None`` or the mesh axis name(s) it is split
    over; at most one dimension is split, and it must divide the
    positions.  Returns a :class:`Sharded`: with a split, one
    contiguous piece a position along its axes; without one, a whole
    copy on each distinct device of this process's positions.

    Across processes each rank fills only the positions it owns, from
    its own copy: the MPI-replica semantic (every rank holds its own
    logically equal replica).  The copies are not compared, since float
    reductions in another order may legally differ in the last ulp.
    """
    x = torch.as_tensor(array)
    split = [(d, a) for d, a in enumerate(tuple(spec)) if a is not None]
    if len(split) > 1:
        raise ValueError(f"spec {tuple(spec)} splits {len(split)} "
                         "dimensions; a Sharded splits one")
    multi = mesh.ranks is not None and _dist() is not None
    me = process_index()
    if not split:
        devices = mesh.local_devices()
        return Sharded([x.to(d) for d in devices], devices, 0, (),
                       [me] * len(devices) if multi else None,
                       tuple(x.shape))
    dim, axes = split[0]
    axes = _axis_tuple(axes)
    devices = axis_devices(mesh, axes)
    ranks = axis_ranks(mesh, axes) if multi else None
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(
            f"dimension {dim} of size {x.shape[dim]} does not divide "
            f"the {n} positions of mesh axes {axes}")
    pieces = torch.tensor_split(x, n, dim=dim)
    chunks = [p.to(dev).contiguous() if ranks is None or ranks[k] == me
              else None
              for k, (p, dev) in enumerate(zip(pieces, devices))]
    if all(c is None for c in chunks):
        raise ValueError(f"rank {me} owns no position along mesh axes "
                         f"{axes}; every rank must hold a piece")
    return Sharded(chunks, devices, dim, axes, ranks, tuple(x.shape))


def shard_along(array, mesh, axis_name, array_dim=0):
    """Lay ``array`` (numpy or tensor) out on ``mesh``, split along
    ``array_dim`` over ``axis_name`` (a name or a tuple of names, as in
    a ``PartitionSpec``).  The dimension must divide the axis size.
    Each piece is a contiguous tensor of the array's dtype on its
    device.  Returns a :class:`Sharded` (see :func:`place_on_mesh`)."""
    spec = [None] * (array_dim + 1)
    spec[array_dim] = axis_name
    return place_on_mesh(array, mesh, spec)


def replicated(array, mesh):
    """``array`` whole on ``mesh``: a copy on each distinct device of
    this process's positions (a :class:`Sharded` with no axes)."""
    return place_on_mesh(array, mesh)


def _gather_pieces(x):
    """The pieces of a multi-process :class:`Sharded`, each on this
    rank, from one ``all_gather``: every rank sends its own pieces,
    stacked (zero-padded up to the most any rank owns), on the process
    group's device."""
    dist = torch.distributed
    me, world = dist.get_rank(), dist.get_world_size()
    held = [c for _, c, _ in x.local()]
    if not held:
        raise ValueError(f"rank {me} holds no piece of the array")
    counts = [x.ranks.count(r) for r in range(world)]
    dev = comm_device()
    buf = torch.zeros((max(counts),) + tuple(held[0].shape),
                      dtype=held[0].dtype, device=dev)
    for j, c in enumerate(c for c in x.chunks if c is not None):
        buf[j] = c.to(dev)
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    seen = [0] * world
    pieces = []
    for r in x.ranks:
        pieces.append(parts[r][seen[r]])
        seen[r] += 1
    return pieces


def fetch_replicated(x, mesh=None):
    """Host numpy array of ``x``: a :class:`Sharded` (its pieces
    concatenated; a replicated one, this process's copy), a tensor or
    anything ``np.asarray`` takes.  Across processes the pieces come
    from one ``all_gather`` (CUDA tensors under NCCL, CPU tensors under
    gloo), and every rank gets the whole array: the analog of the
    reference's MPI gather of results to all ranks.  ``mesh`` is not
    needed; it is kept for the JAX package's signature."""
    del mesh
    if isinstance(x, Sharded):
        if not x.axes:
            return x.local()[0][1].detach().cpu().numpy()
        pieces = x.chunks if x.ranks is None else _gather_pieces(x)
        parts = [c.detach().cpu().numpy() for c in pieces]
        out = parts[0] if len(parts) == 1 else \
            np.concatenate(parts, axis=x.dim)
        if x.shape is not None and out.shape != x.shape:
            out = out[tuple(slice(0, s) for s in x.shape)]
        return out
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- the rows of a stack split along its first dimension ---------------
#
# An estimator over subjects holds its stacked data ``x`` either as one
# tensor or as a Sharded split along dim 0, and each per-subject
# ``leaf`` (W, S, rho2) as a tensor of the rows this process holds, in
# order.  These helpers take either form of ``x``; in one process they
# hand the leaf back as it is.


def cat_pieces(parts):
    """``parts`` concatenated along dim 0 (one part: itself, no copy)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def local_pieces(x):
    """The pieces of ``x`` that this process holds: each of its
    positions' of a :class:`Sharded`, or the tensor itself."""
    if isinstance(x, Sharded):
        return [c for c in x.chunks if c is not None]
    return [x]


def spans_processes(x):
    """Whether ``x`` is laid out across processes."""
    return isinstance(x, Sharded) and x.ranks is not None


def _local_row_ids(x):
    """The rows of ``x`` (split along dim 0 across processes) that this
    process holds, in order: the pieces' bounds by
    ``torch.tensor_split``'s rule, which :func:`place_on_mesh` cuts
    by."""
    n, k = x.shape[0], len(x.chunks)
    sizes = [n // k + (i < n % k) for i in range(k)]
    starts = np.cumsum([0] + sizes)
    return [i for j, c in enumerate(x.chunks) if c is not None
            for i in range(starts[j], starts[j + 1])]


def local_rows(x, leaf):
    """This process's rows of ``leaf`` [n, ...], held whole."""
    if not spans_processes(x):
        return leaf
    return leaf[torch.tensor(_local_row_ids(x), device=leaf.device)]


def split_rows(x, leaf):
    """This process's rows ``leaf`` cut as ``x`` is laid out: each of
    its positions' rows on that position's device, or ``[leaf]``."""
    if not isinstance(x, Sharded):
        return [leaf]
    pieces = local_pieces(x)
    parts = torch.split(leaf, [c.shape[0] for c in pieces])
    return [p.to(c.device) for p, c in zip(parts, pieces)]


def laid_out_rows(x, leaf):
    """This process's rows ``leaf`` as a :class:`Sharded` laid out as
    ``x`` (None at the positions of other ranks)."""
    parts = iter(split_rows(x, leaf))
    return Sharded([None if c is None else next(parts) for c in x.chunks],
                   x.devices, 0, x.axes, x.ranks,
                   (x.shape[0],) + tuple(leaf.shape[1:]))


def gather_rows(x, leaf):
    """Every row of ``leaf`` from this process's rows, on the leaf's
    device: one ``all_gather`` across processes, the leaf itself
    otherwise."""
    if not spans_processes(x):
        return leaf
    return cat_pieces([p.to(leaf.device)
                       for p in _gather_pieces(laid_out_rows(x, leaf))])


def fetch_rows(x, leaf):
    """Host numpy array of every row of ``leaf`` from this process's
    rows (:func:`fetch_replicated` across processes)."""
    return fetch_replicated(laid_out_rows(x, leaf)
                            if spans_processes(x) else leaf)


def all_sum(x, total):
    """A sum over this process's rows completed over every process's:
    one ``all_reduce`` across processes, ``total`` itself otherwise."""
    if not spans_processes(x):
        return total
    summed = total.to(comm_device())
    torch.distributed.all_reduce(summed)
    return summed.to(total.device)
