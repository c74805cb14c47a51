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

The ring is a Python loop over the n steps; at each step every position
launches one ring step, and then hands its panel to the next position
(``Tensor.to`` its device; on the same device the panel is handed on
with no copy).  When every position sits on one device the positions
write their row slabs into one preallocated [V, V] buffer, so no
concatenation follows.  Over several devices each position fills its
own [V/n, V] slab, and the slabs are gathered on the first device at
the end: one more [V, V] buffer there, and each slab copied once over
the link between the cards.

``ring_step`` takes the JAX package's names: ``None`` is K5 on CUDA and
``"fused"`` on the CPU; ``"pallas"`` names K5 (a CPU tensor raises);
``"fused"`` is the in-place step of :func:`ring_mma` (K5 on CUDA, its
plain version on the CPU); ``"unfused"`` is the reference's three-stage
formulation (per-step products stacked, transposed and scattered) with
``torch.matmul`` on either device.

Not ported yet: ``panel_gram`` (with ``resilience/``), ``block_gram``
(with ``VoxelSelector(mesh=, use_distla=)``), ``shard_vmap``,
``batched_eigh`` and ``batched_cholesky_solve`` (with SRM).
"""

import logging
import math
import os

import numpy as np
import torch

from ..device import matmul_precision, resolve_device
from ..parallel.mesh import Sharded, shard_along
from .kernels.ring import ring_mma, split

logger = logging.getLogger(__name__)

__all__ = [
    "BUDGET_ENV",
    "DEFAULT_REPLICATED_BUDGET",
    "RING_STEPS",
    "gram",
    "replicated_budget_bytes",
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


def _ring(z, z_b, ring_step, precision):
    """The ring program on two :class:`Sharded` operands ([T, B] on
    each of n positions): the [n B, n B] product ``z.T @ z_b`` on the
    first position's device.  On CUDA it holds, beside the output, each
    operand's shards split for K5's kernel: 8 * t_pad bytes a column
    (``kernels.ring.Split``; one split when ``z_b`` is ``z``)."""
    n = len(z.chunks)
    devices = z.devices
    block = z_b.chunks[0].shape[1]
    width = n * block
    if len(set(devices)) == 1:
        full = torch.empty((width, width), dtype=torch.float32,
                           device=devices[0])
        outs = [full[i * block:(i + 1) * block] for i in range(n)]
    else:
        full = None
        outs = [torch.empty((block, width), dtype=torch.float32, device=d)
                for d in devices]
    resident, rotating = list(z.chunks), list(z_b.chunks)
    if ring_step != "unfused" and all(d.type == "cuda" for d in devices):
        # K5's kernel reads its operands split: split each shard once
        resident = [split(c) for c in resident]
        rotating = list(resident) if z_b is z else \
            [split(c) for c in rotating]
    products = [[] for _ in range(n)]
    for s in range(n):
        for i in range(n):
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
            # on the same device .to() returns the panel itself
            rotating = [rotating[(i - 1) % n].to(devices[i])
                        for i in range(n)]
    if ring_step == "unfused":
        for i in range(n):
            owners = [(i - s) % n for s in range(n)]
            stacked = torch.stack(products[i])
            outs[i].view(block, n, block)[:, owners, :] = \
                stacked.transpose(0, 1)
    if full is not None:
        return full
    return torch.cat([o.to(devices[0]) for o in outs])


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
    return out[:v, :v] if pad else out


def _normalized(x, n_shards, mesh, names, norm):
    placed = shard_along(_pad_cols(_f32(x), n_shards)[0], mesh, names, 1)
    return Sharded([norm(c) for c in placed.chunks], placed.devices,
                   placed.dim, placed.axes)


def summa_gram(data, mesh, data_b=None, axis_names=None,
               precision=None, normalize=True, ring_step=None):
    """All-pairs Pearson correlation of the columns of ``data`` (against
    ``data_b`` when given) by the SUMMA ring over ``mesh``.

    The columns are split first and z-scored piece by piece
    (:func:`_zscore_cols`: 0 for constant columns, NaN rows and columns
    for a NaN column), so the whole [T, V] array is never normalized in
    one place.  ``normalize=False`` skips the z-score: the result is
    ``data.T @ data_b``.  Returns [V, V] float32 as
    :func:`summa_matmul`.
    """
    names, _, n_shards = _ring_axes(mesh, axis_names)
    v = data.shape[1]
    if data_b is not None and tuple(data_b.shape) != tuple(data.shape):
        raise ValueError(f"data_b shape {tuple(data_b.shape)} != data "
                         f"shape {tuple(data.shape)}")
    norm = _zscore_cols if normalize else (lambda z: z)
    z = _normalized(data, n_shards, mesh, names, norm)
    z_b = z if data_b is None else _normalized(data_b, n_shards, mesh,
                                               names, norm)
    mode = _ring_step_for(ring_step, z.devices)
    out = _ring(z, z_b, mode, precision)
    return out[:v, :v] if v % n_shards else out


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
    defaults to ``"cuda"`` and raises without a card.
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
    z = norm(_f32(data).to(dev))
    z_b = z if data_b is None else norm(_f32(data_b).to(dev))
    with matmul_precision(precision) as dtype:
        return torch.matmul(z.T.to(dtype), z_b.to(dtype)).float()
