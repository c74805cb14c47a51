"""The searchlight engine, the port's.

PyTorch counterpart of ``brainiak_tpu/searchlight/searchlight.py``: a
user function runs over every active voxel's neighbourhood, in two
tiers.

- **host tier** (:meth:`Searchlight.run_searchlight`): any Python
  ``voxel_fn`` (for example a classifier's cross-validation, as
  :class:`~brainiak_tpu_torch.fcma.mvpa_voxelselector
  .MVPAVoxelSelector` runs) visits each centre's neighbourhood in a
  host loop, or in a process pool.
- **traced tier** (:meth:`Searchlight.run_searchlight_jax`, the JAX
  package's name, kept so that scripts port as written): a
  ``voxel_fn`` written in torch and vmappable is applied by
  ``torch.func.vmap`` to batches of centres, each batch's
  neighbourhoods gathered on the device with one index along the
  flattened voxel axis.  With a mesh the centre list is split over its
  ``'voxel'`` axis (no halo is needed: every position holds the whole
  volume), and across processes each rank sweeps its own positions'
  centres and one ``all_gather`` gives every rank the whole volume.

Neither tier is a hand-written kernel: the JAX package's traced tier is
an XLA gather and ``lax.map``, outside any Pallas kernel.
"""

import logging
from multiprocessing import Pool

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.mesh import (DEFAULT_VOXEL_AXIS, Sharded, axis_devices,
                             axis_ranks, fetch_replicated, process_index)
from ..utils.utils import usable_cpu_count

logger = logging.getLogger(__name__)

__all__ = ["Ball", "Cube", "Diamond", "Searchlight", "Shape"]


def _apply_voxel_fn(args):
    """Top-level worker wrapper so Pool.imap can stream tasks lazily."""
    voxel_fn = args[0]
    return voxel_fn(*args[1:])


class Shape:
    """Searchlight shape in a (2*rad+1)^3 cube."""

    def __init__(self, rad):
        self.rad = rad


class Cube(Shape):
    def __init__(self, rad):
        super().__init__(rad)
        self.mask_ = np.ones((2 * rad + 1,) * 3, dtype=bool)


class Diamond(Shape):
    """Manhattan-distance ball."""

    def __init__(self, rad):
        super().__init__(rad)
        g = np.abs(np.arange(-rad, rad + 1))
        dist = g[:, None, None] + g[None, :, None] + g[None, None, :]
        self.mask_ = dist <= rad


class Ball(Shape):
    """Euclidean ball."""

    def __init__(self, rad):
        super().__init__(rad)
        g = np.arange(-rad, rad + 1) ** 2
        dist = g[:, None, None] + g[None, :, None] + g[None, None, :]
        self.mask_ = np.sqrt(dist) <= rad


class Searchlight:
    """Run a user function over every active voxel's neighbourhood.

    Parameters
    ----------
    sl_rad : neighbourhood radius in voxels
    max_blk_edge : kept for API compatibility (the volume is not cut
        into blocks)
    shape : Shape subclass (Cube/Diamond/Ball)
    min_active_voxels_proportion : skip centres whose (mask ∩ shape)
        neighbourhood has at most this active fraction
    pool_size : processes for the host tier (None: every usable CPU).
        The pool forks this process (the platform's default start
        method): that is safe after CUDA is initialised only while the
        children touch no CUDA, so a ``voxel_fn`` of the host tier runs
        on the host, as a classifier's cross-validation does.
    mesh : optional :class:`~brainiak_tpu_torch.parallel.mesh.Mesh`
        with a ``'voxel'`` axis, over which the traced tier splits its
        centres
    device : where the traced tier runs without a mesh (default
        ``"cuda"``; raises without a card unless it is ``"cpu"``)
    """

    def __init__(self, sl_rad=1, max_blk_edge=10, shape=Cube,
                 min_active_voxels_proportion=0, pool_size=None, mesh=None,
                 device="cuda"):
        if sl_rad < 0:
            raise AssertionError('sl_rad should not be negative')
        if max_blk_edge <= 0:
            raise AssertionError('max_blk_edge should be positive')
        self.sl_rad = sl_rad
        self.max_blk_edge = max_blk_edge
        self.min_active_voxels_proportion = min_active_voxels_proportion
        self.shape = shape(sl_rad).mask_
        self.bcast_var = None
        self.pool_size = pool_size
        self.mesh = mesh
        self.device = device
        self._cache = None

    # -- data staging ----------------------------------------------------
    def distribute(self, subjects, mask):
        """Stage the subjects' volumes [x, y, z, T] (None placeholders
        are taken by the host tier alone) and the mask [x, y, z]."""
        self.subjects = [np.asarray(s) if s is not None else None
                         for s in subjects]
        self.mask = np.asarray(mask).astype(bool)
        for s in self.subjects:
            if s is not None and s.shape[:3] != self.mask.shape:
                raise ValueError("Subject volume and mask shapes differ")
        # re-staging data is the one supported way to change it: drop the
        # traced tier's device copies, so that buffers mutated in place
        # (which an identity key cannot detect) are not served stale
        self._cache = None

    def broadcast(self, bcast_var):
        """Make shared variables available to the voxel function."""
        self.bcast_var = bcast_var

    # -- centre enumeration ----------------------------------------------
    def _centers(self):
        """Active centres at least sl_rad from every border, then the
        min-active-proportion filter."""
        rad = self.sl_rad
        mask = self.mask
        interior = np.zeros_like(mask)
        if rad > 0:
            interior[rad:-rad, rad:-rad, rad:-rad] = \
                mask[rad:-rad, rad:-rad, rad:-rad]
        else:
            interior = mask
        centers = np.argwhere(interior)
        if self.min_active_voxels_proportion > 0 and len(centers):
            keep = []
            size = self.shape.size
            for (i, j, k) in centers:
                patch = mask[i - rad:i + rad + 1, j - rad:j + rad + 1,
                             k - rad:k + rad + 1] * self.shape
                if np.count_nonzero(patch) / size > \
                        self.min_active_voxels_proportion:
                    keep.append((i, j, k))
            centers = np.asarray(keep).reshape(-1, 3)
        return centers

    # -- host tier --------------------------------------------------------
    def run_searchlight(self, voxel_fn, pool_size=None):
        """Apply any Python ``voxel_fn(subj_patches, mask_patch, rad,
        bcast_var)`` at every active centre; returns an object volume
        (None where skipped).  With more than one process (``pool_size``,
        else the constructor's, at most the usable CPUs) the patches
        stream lazily through a ``multiprocessing.Pool`` (``imap``,
        chunks of 8), which keeps memory bounded by processes x chunk
        patches."""
        rad = self.sl_rad
        centers = self._centers()
        outmat = np.empty(self.mask.shape, dtype=object)

        def patch_args(c):
            i, j, k = c
            sl = np.s_[i - rad:i + rad + 1, j - rad:j + rad + 1,
                       k - rad:k + rad + 1]
            subj = [s[sl] if s is not None else None
                    for s in self.subjects]
            return subj, self.mask[sl] * self.shape, rad, self.bcast_var

        if pool_size is None:
            pool_size = self.pool_size
        processes = usable_cpu_count() if pool_size is None else \
            min(pool_size, usable_cpu_count())

        if processes > 1 and len(centers) > 1:
            args_iter = ((voxel_fn,) + patch_args(c) for c in centers)
            with Pool(processes) as pool:
                for c, value in zip(
                        centers,
                        pool.imap(_apply_voxel_fn, args_iter,
                                  chunksize=8)):
                    outmat[tuple(c)] = value
        else:
            for c in centers:
                outmat[tuple(c)] = voxel_fn(*patch_args(c))
        return outmat

    def run_block_function(self, block_fn, extra_block_fn_params=None,
                           pool_size=None):
        """Apply a block function to the whole volume as one block
        (halo'd by ``sl_rad``); its result fills the interior."""
        result = block_fn(self.subjects, self.mask, self.sl_rad,
                          self.bcast_var, extra_block_fn_params)
        outmat = np.empty(self.mask.shape, dtype=object)
        rad = self.sl_rad
        if rad > 0:
            outmat[rad:-rad, rad:-rad, rad:-rad] = result
        else:
            outmat[:] = result
        return outmat

    # -- traced tier ------------------------------------------------------
    def _positions(self):
        """The devices the centres are split over and their owning
        ranks (None in one process): the mesh's ``'voxel'`` positions,
        or the one ``device``."""
        if self.mesh is None:
            return [resolve_device(self.device)], None
        return (axis_devices(self.mesh, DEFAULT_VOXEL_AXIS),
                axis_ranks(self.mesh, DEFAULT_VOXEL_AXIS))

    def _device_state(self, centers):
        """The flat [S, X·Y·Z, T] data and flat mask on each device of
        this process's positions (built once per :meth:`distribute`,
        keyed by the identity of the staged objects) and the [N, P]
        flat index of the centres' neighbourhoods, split over the
        positions (built once)."""
        # the key holds the objects, not their ids, so that an ``is``
        # match cannot be a recycled id() of freed inputs
        key = (self.subjects, self.mask, self.bcast_var) \
            + tuple(self.subjects)
        cache = self._cache
        if cache is None or len(cache["key"]) != len(key) or \
                not all(a is b for a, b in zip(cache["key"], key)):
            devices, ranks = self._positions()
            me = process_index()
            local = list(dict.fromkeys(
                d for k, d in enumerate(devices)
                if ranks is None or ranks[k] == me))
            data = np.stack(self.subjects)  # [S, x, y, z, T]
            s, dx, dy, dz, t = data.shape
            dtype = np.result_type(data.dtype, np.float32)
            flat = torch.from_numpy(np.ascontiguousarray(
                data.reshape(s, dx * dy * dz, t), dtype=dtype))
            del data
            mflat = torch.from_numpy(self.mask.reshape(-1).copy())
            cache = {"key": key, "dims": (dx, dy, dz),
                     "flat": {d: flat.to(d) for d in local},
                     "mflat": {d: mflat.to(d) for d in local}}
            self._cache = cache
        if "idx" not in cache:
            _, dy, dz = cache["dims"]
            devices, ranks = self._positions()
            n = len(devices)
            pad = (-len(centers)) % n
            padded = np.concatenate(
                [centers, np.repeat(centers[-1:], pad, axis=0)])
            offs = np.argwhere(self.shape) - self.sl_rad  # [P, 3]
            idx3 = padded[:, None, :] + offs[None, :, :]
            idx1 = torch.from_numpy(np.ascontiguousarray(
                (idx3[..., 0] * dy + idx3[..., 1]) * dz + idx3[..., 2]))
            me = process_index()
            cache["idx"] = [
                p.to(d) if ranks is None or ranks[k] == me else None
                for k, (p, d) in enumerate(zip(torch.tensor_split(idx1, n),
                                               devices))]
        return cache

    def _sweep(self, flat, mflat, idx, voxel_fn, batch_size):
        """``voxel_fn`` at the centres of one position, ``batch_size``
        centres a step: one gather of the batch's neighbourhoods along
        the flat voxel axis, the entries outside the shape or the mask
        zeroed, then the vmapped function.  Returns [n] values."""
        rad, bcast = self.sl_rad, self.bcast_var
        mapped = torch.func.vmap(lambda p, m: voxel_fn(p, m, rad, bcast),
                                 in_dims=(1, 0))
        s, _, t = flat.shape
        zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
        out = []
        for start in range(0, idx.shape[0], batch_size):
            i1 = idx[start:start + batch_size]
            nb, p = i1.shape
            patch = flat.index_select(1, i1.reshape(-1)).view(s, nb, p, t)
            mp = mflat[i1]
            patch = torch.where(mp[None, :, :, None], patch, zero)
            out.append(mapped(patch, mp))
        return torch.cat(out)

    def run_searchlight_jax(self, voxel_fn, batch_size=1024,
                            fill_value=np.nan):
        """Apply a vmappable torch ``voxel_fn`` at every active centre,
        ``batch_size`` centres a step (the counterpart of the JAX
        package's ``lax.map(..., batch_size=)``), on ``device`` or over
        the mesh's ``'voxel'`` positions.

        voxel_fn(patches, mask_patch, rad, bcast_var) -> scalar tensor,
        where ``patches`` is [n_subjects, shape_voxels, n_TRs], its
        entries outside the shape or the mask zero, and ``mask_patch``
        [shape_voxels] bool marks the valid ones.

        On a mesh the centres are padded to a multiple of the positions
        by repeating the last one and split over them; each position
        gathers and maps on its own device, and the padding is dropped
        after the fetch.  Across processes each rank sweeps its own
        positions' centres, and one ``all_gather``
        (:func:`~brainiak_tpu_torch.parallel.mesh.fetch_replicated`)
        gives every rank the whole volume.

        The dtype: the sweep computes in the subjects' floating dtype
        (float32 stays float32, float64 stays float64, other dtypes
        become float32), as the JAX package does under x64; under its
        default configuration (x64 off) the JAX package computes
        float64 input in float32.

        Returns a numpy volume of the values' dtype, ``fill_value``
        where a centre is skipped; with no centres, the float64 fill
        volume.  A ``None`` subject raises ``ValueError``.
        """
        centers = self._centers()
        if len(centers) == 0:
            return np.full(self.mask.shape, fill_value, dtype=np.float64)
        if any(s is None for s in self.subjects):
            raise ValueError(
                "run_searchlight_jax requires all subject volumes; None "
                "placeholders are only supported by the generic tier")
        cache = self._device_state(centers)
        devices, ranks = self._positions()
        values = [None if idx is None else
                  self._sweep(cache["flat"][d], cache["mflat"][d], idx,
                              voxel_fn, batch_size)
                  for idx, d in zip(cache["idx"], devices)]
        if ranks is not None:
            values = fetch_replicated(Sharded(values, devices, 0,
                                              (DEFAULT_VOXEL_AXIS,), ranks))
        else:
            values = torch.cat([v.to(devices[0]) for v in values]) \
                .cpu().numpy()
        values = values[:len(centers)]
        outmat = np.full(self.mask.shape, fill_value, dtype=values.dtype)
        outmat[centers[:, 0], centers[:, 1], centers[:, 2]] = values
        return outmat
