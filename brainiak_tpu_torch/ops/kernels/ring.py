"""The SUMMA ring step (kernel K5).

PyTorch counterpart of ``brainiak_tpu.ops.kernels.ring``: one step of
the ring of :mod:`brainiak_tpu_torch.ops.distla` places the product of
the resident columns and the panel the shard holds at the panel's
column block of the shard's output rows,

    out[:, owner * B:(owner + 1) * B] = z_local.T @ rotating,

and leaves every other column block as it was.  :func:`ring_mma`
writes in place: on a CUDA tensor it launches the hand-written kernel
``csrc/ring_mma.cu`` (which replaces the Pallas kernel
``brainiak_tpu/ops/kernels/ring.py::ring_mma``; a tiled fp32 SGEMM,
operation-bound, see the source note), on a CPU tensor it runs
:func:`mma_update`, the same step in plain PyTorch.  The kernel
computes in fp32 FMA whatever ``precision`` says; the plain version
honours it.

The owner index is a host integer: the port's ring is a Python loop,
so the column offset is known when the step launches.  The JAX
package's tile picking and its ``BRAINIAK_TPU_RING_STEP`` switch are
TPU VMEM logic and have no counterpart.
"""

import ctypes

import torch

from ...device import matmul_precision
from . import _build

__all__ = ["launches", "mma_update", "reset_launches", "ring_mma"]

_launches = {"ring_mma": 0}


def launches():
    """Kernel launch count since the last :func:`reset_launches`."""
    return _launches["ring_mma"]


def reset_launches():
    _launches["ring_mma"] = 0


def mma_update(out, z_local, rotating, col_start, precision=None):
    """Plain version of K5: ``out[:, col_start:col_start + B] =
    z_local.T @ rotating`` in place (``B = rotating.shape[1]``).
    Returns ``out``."""
    n_block = rotating.shape[1]
    with matmul_precision(precision) as dtype:
        block = torch.matmul(z_local.T.to(dtype), rotating.to(dtype))
    out[:, col_start:col_start + n_block] = block.to(out.dtype)
    return out


def _check(out, z_local, rotating, owner, n_shards):
    for name, x in (("out", out), ("z_local", z_local),
                    ("rotating", rotating)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(x.shape)}")
        if x.device != out.device:
            raise ValueError(f"{name} is on {x.device}, out on "
                             f"{out.device}")
    n_trs, n_local = z_local.shape
    n_block = rotating.shape[1]
    if rotating.shape[0] != n_trs:
        raise ValueError(f"z_local {tuple(z_local.shape)} and rotating "
                         f"{tuple(rotating.shape)} differ in T")
    if tuple(out.shape) != (n_local, n_shards * n_block):
        raise ValueError(f"out {tuple(out.shape)} is not "
                         f"[{n_local}, {n_shards} * {n_block}]")
    if out.stride(1) != 1 or out.stride(0) < out.shape[1]:
        raise ValueError("out must have unit column stride and rows "
                         "that do not overlap")
    if not 0 <= owner < n_shards:
        raise ValueError(f"owner {owner} not in [0, {n_shards})")


def _kernel_fn():
    fn = _build.load("ring_mma").ring_mma_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
        [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p]
    return fn


def ring_mma(out, z_local, rotating, owner, *, n_shards, precision=None):
    """K5: one fused ring step, in place.

    out : [V_local, n_shards * B] float32, rows may be a slab of a wider
        buffer (unit column stride); z_local : [T, V_local];
    rotating : [T, B]; owner : the column block (a host int) that the
        panel owns.
    Returns ``out`` with block ``owner`` overwritten by
    ``z_local.T @ rotating`` and every other block untouched.  A CUDA
    tensor goes to the kernel, a CPU tensor to :func:`mma_update`.
    """
    owner = int(owner)
    _check(out, z_local, rotating, owner, n_shards)
    n_block = rotating.shape[1]
    if not out.is_cuda:
        return mma_update(out, z_local, rotating, owner * n_block,
                          precision)
    z_local = z_local.contiguous()
    rotating = rotating.contiguous()
    n_trs, n_local = z_local.shape
    ld_out = out.stride(0)
    col_start = owner * n_block
    vec = all(x.data_ptr() % 16 == 0 for x in (z_local, rotating, out)) \
        and n_local % 4 == 0 and n_block % 4 == 0 and ld_out % 4 == 0 \
        and col_start % 4 == 0
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        err = _kernel_fn()(z_local.data_ptr(), rotating.data_ptr(),
                           out.data_ptr(), n_trs, n_local, n_block, ld_out,
                           col_start, int(vec), stream)
    _build.check(err, "ring_mma")
    _launches["ring_mma"] += 1
    return out
