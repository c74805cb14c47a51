"""The SUMMA ring Gram and the budget dispatcher.

PyTorch counterpart of the ring part of ``brainiak_tpu/ops/distla.py``.
A whole-brain [V, V] correlation matrix need not be computed on one
device with the whole [T, V] data beside it: the voxel axis is split
over a ring of mesh positions, each position keeps its columns
resident, the other positions' panels visit it one step at a time, and
each step places one [V/n, V/n] block of the position's output rows.

- :func:`summa_gram` / :func:`summa_matmul`: the ring.  Both operands
  are split over the ring axes (a 2-D ``('subject', 'voxel')`` mesh
  flattens into one ring), the output is the [V, V] matrix whose row
  slab i position i wrote.  Each step is :func:`ring_mma
  <brainiak_tpu_torch.ops.kernels.ring.ring_mma>`: kernel K5 on a CUDA
  tensor.
- :func:`gram`: the replicated product while the working set fits
  :func:`replicated_budget_bytes`, the ring over it.
- :func:`panel_gram`: the checkpointable variant.  Row panels are
  driven from the host through
  :func:`~brainiak_tpu_torch.resilience.guards.run_resilient_loop`,
  so a preempted Gram resumes at the last completed panel.
- :func:`block_gram`: FCMA's per-voxel Gram of a voxel block against
  epoch data split over the mesh's voxel axis (kernel K1 a position,
  the partial Grams summed), the path of
  ``VoxelSelector(use_distla=)``.
- :func:`shard_vmap`, :func:`batched_eigh` and
  :func:`batched_cholesky_solve`: per-subject small solves laid out
  along a mesh's subject axis (SRM's W updates), in one process or
  across processes.

The ring is a Python loop over the n steps; at each step every position
launches one ring step, and then hands its panel to the next position
(``Tensor.to`` its device; on the same device the panel is handed on
with no copy).  When every position sits on one device the positions
write their row slabs into one preallocated [V, V] buffer, so no
concatenation follows.  Over several devices each position fills its
own [V/n, V] slab, and the slabs are gathered on the first device at
the end: one more [V, V] buffer there, and each slab copied once over
the link between the cards.

Across processes (a mesh of :func:`~brainiak_tpu_torch.parallel.mesh
.initialize_distributed`), each rank runs the steps of its own
positions; a panel that crosses to a position of another rank goes by
``torch.distributed.batch_isend_irecv`` (for K5 the hi / lo pair of its
split), within a rank it is handed on as above.  Each rank keeps its
own row slabs: :func:`summa_gram` then returns a
:class:`~brainiak_tpu_torch.parallel.mesh.Sharded` of them, which
:func:`~brainiak_tpu_torch.parallel.mesh.fetch_replicated` gathers.

``ring_step`` takes the JAX package's names: ``None`` is K5 on CUDA and
``"fused"`` on the CPU; ``"pallas"`` names K5 (a CPU tensor raises);
``"fused"`` is the in-place step of :func:`ring_mma` (K5 on CUDA, its
plain version on the CPU); ``"unfused"`` is the reference's three-stage
formulation (per-step products stacked, transposed and scattered) with
``torch.matmul`` on either device.

:func:`shard_vmap` (and so :func:`batched_eigh` and
:func:`batched_cholesky_solve`) runs across processes too: each rank
maps its own positions' slices of the batch, and a whole batch comes
back whole on every rank by one ``all_gather``.
"""

import logging
import math
import os

import numpy as np
import torch

from ..device import matmul_precision, resolve_device
from ..obs import spans as obs_spans
from ..parallel.mesh import (DEFAULT_SUBJECT_AXIS, DEFAULT_VOXEL_AXIS,
                             Sharded, _gather_pieces, axis_devices,
                             axis_ranks, comm_device, fetch_replicated,
                             process_index, shard_along)
from ..resilience.guards import array_digest, run_resilient_loop
from .fcma_kernels import fcma_gram
from .kernels.ring import Split, ring_mma, split

logger = logging.getLogger(__name__)

__all__ = [
    "BUDGET_ENV",
    "DEFAULT_REPLICATED_BUDGET",
    "RING_STEPS",
    "batched_cholesky_solve",
    "batched_eigh",
    "block_gram",
    "gram",
    "panel_gram",
    "replicated_budget_bytes",
    "shard_vmap",
    "summa_gram",
    "summa_matmul",
]

#: Env override for the per-device replicated-operand budget (the
#: JAX package's name: it picks between two paths of the reference).
BUDGET_ENV = "BRAINIAK_TPU_DISTLA_BUDGET_BYTES"

#: Default per-device budget for replicating an operand (bytes).
DEFAULT_REPLICATED_BUDGET = 8 << 30

#: The ring-step names of the reference.
RING_STEPS = ("pallas", "fused", "unfused")


def replicated_budget_bytes():
    """The per-device byte budget above which :func:`gram` takes the
    ring (``BRAINIAK_TPU_DISTLA_BUDGET_BYTES`` overrides the 8 GiB
    default)."""
    env = os.environ.get(BUDGET_ENV)
    if env:
        try:
            return int(float(env))
        except ValueError:
            logger.warning("ignoring unparseable %s=%r", BUDGET_ENV, env)
    return DEFAULT_REPLICATED_BUDGET


def _zscore_cols(data):
    """Column z-score (population std) and ``1/sqrt(T)``, so that a dot
    of two columns is their Pearson r: 0 for constant and zero-pad
    columns, NaN for a column holding a NaN."""
    t = data.shape[0]
    mean = data.mean(dim=0, keepdim=True)
    std = data.std(dim=0, keepdim=True, correction=0)
    safe_std = torch.where(std > 0, std, torch.ones_like(std))
    z = torch.where(std > 0, (data - mean) / (safe_std * math.sqrt(t)),
                    torch.zeros_like(data))
    return torch.where(torch.isnan(std), torch.full_like(z, math.nan), z)


def _ring_axes(mesh, axis_names):
    """The ring axes (``None``: every axis of the mesh, flattened
    row-major), the axis argument as the reference spells it, and the
    ring size."""
    names = tuple(mesh.axis_names) if axis_names is None \
        else tuple(axis_names)
    missing = [a for a in names if a not in mesh.shape]
    if not names or missing:
        raise ValueError(
            f"ring axes {names} not all present in mesh axes "
            f"{tuple(mesh.axis_names)}")
    size = int(np.prod([mesh.shape[a] for a in names]))
    axis = names if len(names) > 1 else names[0]
    return names, axis, size


def _ring_step_for(ring_step, devices):
    """The ring step for a ring over ``devices``: the caller's choice,
    validated, else K5 (``"pallas"``) on CUDA and ``"fused"`` on the
    CPU."""
    on_cuda = all(d.type == "cuda" for d in devices)
    if ring_step is None:
        return "pallas" if on_cuda else "fused"
    if ring_step not in RING_STEPS:
        raise ValueError(
            f"ring_step must be one of {RING_STEPS}; got {ring_step!r}")
    if ring_step == "pallas" and not on_cuda:
        raise ValueError(
            "ring_step='pallas' names the CUDA kernel K5; the ring is "
            "not on CUDA devices (use 'fused' or 'unfused')")
    return ring_step


def _f32(x):
    """A float32 tensor of ``x`` (numpy or tensor), on its device."""
    return torch.as_tensor(x).to(torch.float32)


def _pad_cols(arr, multiple):
    """Zero-pad the last axis of a tensor up to ``multiple``."""
    pad = (-arr.shape[-1]) % multiple
    if not pad:
        return arr, 0
    return torch.nn.functional.pad(arr, (0, pad)), pad


def _panels(x):
    """The tensors that carry a ring panel: a split's hi and lo, or
    the tensor."""
    return (x.hi, x.lo) if isinstance(x, Split) else (x,)


def _hand_on(rotating, devices, ranks):
    """Each position's panel after one ring step: position i takes
    position i - 1's.  On one rank a panel is handed on as
    ``.to(device)`` (itself on the same device); a panel that crosses
    ranks goes by one ``batch_isend_irecv`` of every crossing, ordered
    by the receiving position on both sides (NCCL matches the messages
    of a pair of ranks in order, gloo by their tags)."""
    n = len(rotating)
    if ranks is None:
        return [rotating[(i - 1) % n].to(devices[i]) for i in range(n)]
    dist = torch.distributed
    me = process_index()
    dev = comm_device()
    template = next(p for p in rotating if p is not None)
    out, ops, received = [None] * n, [], []
    for i in range(n):
        src = (i - 1) % n
        if ranks[i] == me and ranks[src] == me:
            out[i] = rotating[src].to(devices[i])
        elif ranks[i] == me:
            bufs = [torch.empty_like(t, device=dev)
                    for t in _panels(template)]
            ops += [dist.P2POp(dist.irecv, b, ranks[src], tag=2 * i + j)
                    for j, b in enumerate(bufs)]
            received.append((i, bufs))
        elif ranks[src] == me:
            ops += [dist.P2POp(dist.isend, t.to(dev).contiguous(),
                               ranks[i], tag=2 * i + j)
                    for j, t in enumerate(_panels(rotating[src]))]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for i, bufs in received:
        bufs = [b.to(devices[i]) for b in bufs]
        out[i] = Split(*bufs, template.n_trs) \
            if isinstance(template, Split) else bufs[0]
    return out


def _ring(z, z_b, ring_step, precision):
    """The ring program on two :class:`Sharded` operands ([T, B] on
    each of n positions): the [n B, n B] product ``z.T @ z_b`` on the
    first position's device, or, across processes, a
    :class:`Sharded` of its row slabs, each on its position.  On CUDA
    it holds, beside the output, each operand's shards split for K5's
    kernel: 8 * t_pad bytes a column (``kernels.ring.Split``; one split
    when ``z_b`` is ``z``)."""
    n = len(z.chunks)
    devices, ranks = z.devices, z.ranks
    block = next(c for c in z_b.chunks if c is not None).shape[1]
    width = n * block
    if ranks is None and len(set(devices)) == 1:
        full = torch.empty((width, width), dtype=torch.float32,
                           device=devices[0])
        outs = [full[i * block:(i + 1) * block] for i in range(n)]
    else:
        full = None
        outs = [None if c is None else
                torch.empty((block, width), dtype=torch.float32, device=d)
                for c, d in zip(z.chunks, devices)]
    resident, rotating = list(z.chunks), list(z_b.chunks)
    if ring_step != "unfused" and all(d.type == "cuda" for d in devices):
        # K5's kernel reads its operands split: split each shard once
        resident = [None if c is None else split(c) for c in resident]
        rotating = list(resident) if z_b is z else \
            [None if c is None else split(c) for c in rotating]
    local = [i for i in range(n) if outs[i] is not None]
    products = [[] for _ in range(n)]
    for s in range(n):
        for i in local:
            if ring_step == "unfused":
                with matmul_precision(precision) as dtype:
                    products[i].append(torch.matmul(
                        resident[i].T.to(dtype),
                        rotating[i].to(dtype)).float())
            else:
                # the panel seen at step s came from position i - s
                ring_mma(outs[i], resident[i], rotating[i], (i - s) % n,
                         n_shards=n, precision=precision)
        if s + 1 < n:
            rotating = _hand_on(rotating, devices, ranks)
    if ring_step == "unfused":
        for i in local:
            owners = [(i - s) % n for s in range(n)]
            stacked = torch.stack(products[i])
            outs[i].view(block, n, block)[:, owners, :] = \
                stacked.transpose(0, 1)
    if full is not None:
        return full
    if ranks is not None:
        return Sharded(outs, devices, 0, z.axes, ranks, (width, width))
    return torch.cat([o.to(devices[0]) for o in outs])


def _cut(out, v):
    """The [v, v] leading block of the ring's padded product (a view),
    or, across processes, the row slabs marked to be cut so."""
    if isinstance(out, Sharded):
        out.shape = (v, v)
        return out
    return out[:v, :v]


def summa_matmul(a, mesh, b=None, axis_names=None, precision=None,
                 ring_step=None):
    """``C = a.T @ b`` with both operands split over the mesh ring: the
    raw SUMMA primitive.

    a, b : [T, V] arrays or tensors (``b`` defaults to ``a``), computed
        in float32; V is zero-padded up to the ring size and the pad
        sliced off the result.
    mesh : :class:`~brainiak_tpu_torch.parallel.mesh.Mesh`;
        ``axis_names`` the ring axes (default: all, flattened
        row-major).
    ring_step : see the module docstring.
    Returns C [V, V] float32 on the mesh's first device (a view of the
    padded product when V does not divide the ring).
    """
    names, _, n_shards = _ring_axes(mesh, axis_names)
    v = a.shape[1]
    if b is not None and tuple(b.shape) != tuple(a.shape):
        raise ValueError(
            f"operand shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    a_p, pad = _pad_cols(_f32(a), n_shards)
    za = shard_along(a_p, mesh, names, 1)
    zb = za if b is None else shard_along(
        _pad_cols(_f32(b), n_shards)[0], mesh, names, 1)
    mode = _ring_step_for(ring_step, za.devices)
    out = _ring(za, zb, mode, precision)
    return _cut(out, v) if pad else out


def _normalized(x, n_shards, mesh, names, norm):
    return shard_along(_pad_cols(_f32(x), n_shards)[0], mesh, names,
                       1).map(norm)


def summa_gram(data, mesh, data_b=None, axis_names=None,
               precision=None, normalize=True, ring_step=None):
    """All-pairs Pearson correlation of the columns of ``data`` (against
    ``data_b`` when given) by the SUMMA ring over ``mesh``.

    The columns are split first and z-scored piece by piece
    (:func:`_zscore_cols`: 0 for constant columns, NaN rows and columns
    for a NaN column), so the whole [T, V] array is never normalized in
    one place.  ``normalize=False`` skips the z-score: the result is
    ``data.T @ data_b``.  Returns [V, V] float32 as
    :func:`summa_matmul`.  With :mod:`brainiak_tpu_torch.obs` enabled
    it runs under a ``distla.gram`` span (``kind`` ``"summa"``), which
    times the launches: no span synchronizes the card.
    """
    names, _, n_shards = _ring_axes(mesh, axis_names)
    v = data.shape[1]
    if data_b is not None and tuple(data_b.shape) != tuple(data.shape):
        raise ValueError(f"data_b shape {tuple(data_b.shape)} != data "
                         f"shape {tuple(data.shape)}")
    norm = _zscore_cols if normalize else (lambda z: z)
    with obs_spans.span("distla.gram",
                        attrs={"n_voxels": int(v),
                               "n_shards": int(n_shards),
                               "kind": "summa"}):
        z = _normalized(data, n_shards, mesh, names, norm)
        z_b = z if data_b is None else _normalized(data_b, n_shards,
                                                   mesh, names, norm)
        mode = _ring_step_for(ring_step, z.devices)
        out = _ring(z, z_b, mode, precision)
    return _cut(out, v) if v % n_shards else out


def _itemsize(x):
    if isinstance(x, torch.Tensor):
        return x.element_size()
    return np.asarray(x).dtype.itemsize


def gram(data, mesh=None, data_b=None, axis_names=None, precision=None,
         budget_bytes=None, force=None, normalize=True, device="cuda"):
    """Pearson Gram with budget-based dispatch.

    While the replicated working set (the [T, V] operands and the
    [V, V] output, at the input's item size) fits ``budget_bytes``
    (default :func:`replicated_budget_bytes`), one ``torch.matmul`` on
    ``device`` computes it; over the budget, and with a mesh, the SUMMA
    ring does.  ``force='replicated'`` raises instead of exceeding the
    budget; ``force='summa'`` always takes the ring, which holds the
    [V, V] output and, on CUDA, the split operands of K5's kernel
    (8 * T bytes a voxel and operand, T rounded up to 32).
    ``normalize=False`` returns the raw ``data.T @ data_b``.  ``device``
    defaults to ``"cuda"`` and raises without a card.  The replicated
    product runs under a ``distla.gram`` span (``kind``
    ``"replicated"``) while :mod:`brainiak_tpu_torch.obs` is enabled.
    """
    dev = resolve_device(device)
    if force not in (None, "replicated", "summa"):
        raise ValueError(
            f"force must be None, 'replicated' or 'summa'; got "
            f"{force!r}")
    # one contract on every branch, not only past the budget
    if data_b is not None and tuple(data_b.shape) != tuple(data.shape):
        raise ValueError(f"data_b shape {tuple(data_b.shape)} != data "
                         f"shape {tuple(data.shape)}")
    v = data.shape[1]
    itemsize = _itemsize(data)
    need = (2 if data_b is not None else 1) * math.prod(data.shape) \
        * itemsize + v * v * itemsize
    budget = replicated_budget_bytes() if budget_bytes is None \
        else int(budget_bytes)
    over = need > budget
    if force == "replicated":
        if over:
            raise ValueError(
                f"replicated Gram needs ~{need} bytes per device, "
                f"over the {budget}-byte budget; use the SUMMA path "
                "(pass a mesh) or raise the budget")
        use_summa = False
    else:
        use_summa = force == "summa" or (over and mesh is not None)
    if use_summa:
        if mesh is None:
            raise ValueError("the SUMMA path needs a mesh")
        return summa_gram(data, mesh, data_b=data_b,
                          axis_names=axis_names, precision=precision,
                          normalize=normalize)
    if over:
        logger.warning(
            "replicated Gram working set (~%d bytes) exceeds the "
            "%d-byte budget and no mesh was given; computing "
            "replicated anyway", need, budget)
    norm = _zscore_cols if normalize else (lambda z: z)
    with obs_spans.span("distla.gram",
                        attrs={"n_voxels": int(v), "n_shards": 1,
                               "kind": "replicated"}):
        z = norm(_f32(data).to(dev))
        z_b = z if data_b is None else norm(_f32(data_b).to(dev))
        with matmul_precision(precision) as dtype:
            return torch.matmul(z.T.to(dtype), z_b.to(dtype)).float()


# -- checkpointable panel Gram ---------------------------------------

def panel_gram(data, mesh, data_b=None, axis_name=DEFAULT_VOXEL_AXIS,
               panel_size=None, checkpoint_dir=None,
               checkpoint_every=1, precision=None,
               name="distla.panel_gram"):
    """Pearson Gram computed panel by panel under the resilient loop:
    the checkpointable SUMMA variant.

    The column-split operand (``data_b``, default ``data``) is
    z-scored once on its mesh positions and stays there for the whole
    loop; each step z-scores one host row panel of ``data``,
    multiplies it against every position's columns (``torch.matmul``,
    float32, TF32 off under the default precision) and lands the
    finished [panel, V] rows in host state.  With ``checkpoint_dir``
    the accumulated rows are saved every ``checkpoint_every`` panels
    and a preempted run resumes at the last completed panel.  Each
    panel runs under a ``distla.panel_chunk`` span (attributes
    ``panel`` and ``rows``).  Returns the [V, V] float32 host array.
    Across processes each rank multiplies a panel against its own
    positions' columns and one ``all_gather`` a panel brings every rank
    the whole rows (give each rank its own ``checkpoint_dir``).

    panel_size : rows a step (default: one shard width,
        ``V_padded / n_shards``).
    """
    n_shards = mesh.shape[axis_name]
    data = np.asarray(data)
    data_b = data if data_b is None else np.asarray(data_b)
    if data_b.shape != data.shape:
        raise ValueError(
            f"data_b shape {data_b.shape} != data shape {data.shape}")
    t, v = data.shape
    z_b = _normalized(data_b, n_shards, mesh, axis_name, _zscore_cols)
    if panel_size is None:
        panel_size = max(1, z_b.local()[0][1].shape[1])
    n_panels = -(-v // panel_size)

    fingerprint = None
    if checkpoint_dir is not None:
        # data_b participates: a resume against the same data but
        # another cross-correlation target must restart
        fingerprint = np.array(
            [array_digest(data), array_digest(data_b), float(t),
             float(v), float(panel_size), float(n_shards)])

    def run_chunk(state, step, n_steps):
        # copy-on-write: the loop keeps the previous state as its
        # rollback target.  The host reads are the point of this loop
        # (finished rows land in checkpointable host state); the ring
        # (summa_gram) is the path without them.
        out = np.array(state["out"], copy=True)
        for p in range(step, step + n_steps):
            start = p * panel_size
            stop = min(start + panel_size, v)
            panel = np.zeros((t, panel_size), dtype=np.float32)
            panel[:, :stop - start] = data[:, start:stop]
            with obs_spans.span("distla.panel_chunk",
                                attrs={"panel": p,
                                       "rows": stop - start}):
                rows = fetch_replicated(z_b.map(
                    lambda zc: _panel_rows(panel, zc, precision)))
            out[start:stop, :] = rows[:stop - start, :v]
        return {"out": out}, False

    # guard_skip: NaN rows are the propagation semantics for NaN
    # voxels, not divergence; the loop is used for checkpoint and
    # resume here, not for its non-finite guard
    state, _ = run_resilient_loop(
        run_chunk, {"out": np.zeros((v, v), dtype=np.float32)},
        n_panels, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, fingerprint=fingerprint,
        name=name, guard_skip=("out",))
    return state["out"]


def _panel_rows(panel, z_local, precision):
    """The z-scored host ``panel`` [T, P] against one position's
    z-scored columns: [P, V/n] on its device."""
    zp = _zscore_cols(torch.from_numpy(panel).to(z_local.device))
    with matmul_precision(precision) as dtype:
        return torch.matmul(zp.T.to(dtype), z_local.to(dtype)).float()


# -- FCMA block x all-voxel contraction ------------------------------

def block_gram(blk, data2, mesh, epochs_per_subj,
               axis_name=DEFAULT_VOXEL_AXIS, precision=None):
    """Per-voxel SVM Gram of a voxel block against epoch data split
    over the mesh's ``axis_name``: the path of FCMA's
    ``VoxelSelector(use_distla=)`` when replicating ``data2`` would
    exceed the device budget.

    Each position runs kernel K1 (:func:`~brainiak_tpu_torch.ops
    .fcma_kernels.fcma_gram`; its plain version on the CPU) on the
    block and its own voxels of ``data2``.  The within-subject
    normalization of a correlation is local to its voxel, so the Gram
    is a sum over ``data2``'s voxels and the positions' partial Grams
    add up to it: they are summed in position order on this process's
    first position's device (the JAX package's ``psum``), and across
    processes by one ``all_reduce`` of each rank's sum.

    blk : [E, T, B] (numpy, tensor, or a replicated
        :class:`~brainiak_tpu_torch.parallel.mesh.Sharded` with a copy
        on each device of the axis).
    data2 : [E, T, V] numpy or tensor, zero-padded here along V up to a
        multiple of the axis size and split over it (a zero pad column
        normalizes to zero and adds nothing to the Gram), or a
        :class:`~brainiak_tpu_torch.parallel.mesh.Sharded` already
        split along dim 2 over ``axis_name``.
    Returns the unshrunk kernels [B, E, E] float32 (the caller applies
    FCMA's magnitude shrink), whole on every process.
    """
    if not isinstance(data2, Sharded):
        data2 = shard_along(_pad_cols(_f32(data2),
                                      mesh.shape[axis_name])[0],
                            mesh, axis_name, 2)
    copies = {}

    def on(dev):
        if dev not in copies:
            copies[dev] = blk.on(dev) if isinstance(blk, Sharded) \
                else _f32(blk).to(dev)
        return copies[dev]

    total = None
    for _, shard, dev in data2.local():
        part = fcma_gram(on(dev), shard, epochs_per_subj,
                         precision=precision)
        total = part if total is None else total + part.to(total.device)
    if data2.ranks is not None:
        dist = torch.distributed
        summed = total.to(comm_device())
        dist.all_reduce(summed)
        total = summed.to(total.device)
    return total


# -- sharded batched small-matrix solves -----------------------------

def _per_output(outs):
    """Each position's output of a vmap (a tensor or a tuple, None for
    a position of another rank) as one list of pieces per output, and
    whether the outputs are tuples."""
    first = next(o for o in outs if o is not None)
    if isinstance(first, torch.Tensor):
        return [outs], False
    return [[None if o is None else o[i] for o in outs]
            for i in range(len(first))], True


def shard_vmap(fn, mesh, axis_name, n_batch):
    """``torch.func.vmap(fn)`` with the leading batch dimension laid
    out along the mesh's ``axis_name``: each position runs the vmap on
    its slice of the batch, on its own device (positions may repeat a
    device; a process runs its positions one after another).  The
    returned function takes either of two batches:

    - the whole batch (tensors; across processes every rank holds all
      of it, the MPI-replica semantic): the output's slices are
      concatenated along dim 0, in position order, on the first device
      of this process's positions.  Across processes each rank maps
      only its own positions' slices, and one ``all_gather`` an output
      brings every rank the whole output.
    - a batch already laid out along the axis (each argument a
      :class:`~brainiak_tpu_torch.parallel.mesh.Sharded` split along
      dim 0 over ``axis_name``, one piece a position, as SRM's subject
      stack is): each piece this process holds is mapped on its
      device, and each output is a :class:`Sharded` of the same layout
      (across processes, with this rank's pieces only), which the
      caller fetches with :func:`~brainiak_tpu_torch.parallel.mesh
      .fetch_replicated` when it needs the whole.

    Without a mesh, or when the axis is absent or trivial or does not
    divide ``n_batch``, the plain vmap over the whole batch (every rank
    maps all of it), as in the JAX package."""
    mapped = torch.func.vmap(fn)
    if mesh is None or axis_name not in getattr(mesh, "shape", {}) \
            or mesh.shape[axis_name] <= 1 \
            or n_batch % mesh.shape[axis_name]:
        return mapped
    devices = axis_devices(mesh, axis_name)
    ranks = axis_ranks(mesh, axis_name)
    n = len(devices)
    me = process_index()

    def laid_out(args):
        lay = args[0]
        if any(len(a.chunks) != n for a in args):
            raise ValueError(f"a batch laid out on {len(lay.chunks)} "
                             f"positions for the {n} of mesh axis "
                             f"{axis_name!r}")
        outs = [None if c[0] is None else mapped(*c)
                for c in zip(*(a.chunks for a in args))]
        lists, is_tuple = _per_output(outs)
        res = [Sharded(o, lay.devices, 0, lay.axes, lay.ranks,
                       (n_batch,) + tuple(next(
                           c for c in o if c is not None).shape[1:]))
               for o in lists]
        return tuple(res) if is_tuple else res[0]

    def run(*args):
        if isinstance(args[0], Sharded):
            return laid_out(args)
        pieces = [torch.tensor_split(a, n) for a in args]
        outs = [mapped(*(p[k].to(dev) for p in pieces))
                if ranks is None or ranks[k] == me else None
                for k, dev in enumerate(devices)]
        first = next(d for d, o in zip(devices, outs) if o is not None)
        lists, is_tuple = _per_output(outs)
        if ranks is not None:
            lists = [_gather_pieces(Sharded(o, devices, 0, (axis_name,),
                                            ranks)) for o in lists]
        res = [torch.cat([c.to(first) for c in o]) for o in lists]
        return tuple(res) if is_tuple else res[0]

    return run


def batched_eigh(mats, mesh=None, axis_name=DEFAULT_SUBJECT_AXIS):
    """Eigendecomposition of a batch of symmetric matrices [S, K, K],
    the batch laid out over the mesh's subject axis when it divides
    it (:func:`shard_vmap`: ``mats`` the whole batch, or a
    :class:`Sharded` laid out along the axis, which gives outputs of
    that layout).  Returns ``(eigenvalues [S, K], eigenvectors
    [S, K, K])``, eigenvalues ascending."""
    return shard_vmap(torch.linalg.eigh, mesh, axis_name,
                      mats.shape[0])(mats)


def _cholesky_solve(a, b):
    chol, _ = torch.linalg.cholesky_ex(a)
    return torch.cholesky_solve(b, chol)


def batched_cholesky_solve(mats, rhs, mesh=None,
                           axis_name=DEFAULT_SUBJECT_AXIS):
    """Solve ``mats[i] @ x[i] = rhs[i]`` for a batch of SPD matrices
    [S, K, K] against [S, K, M] right-hand sides by a Cholesky factor
    each (``torch.linalg.cholesky_ex``, whose error check is left to
    the caller, so no host read), the batch laid out over the mesh's
    subject axis when it divides it (:func:`shard_vmap`: both the whole
    batch, or both laid out along the axis)."""
    return shard_vmap(_cholesky_solve, mesh, axis_name,
                      mats.shape[0])(mats, rhs)
