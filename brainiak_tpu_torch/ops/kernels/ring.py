"""The SUMMA ring step (kernel K5).

PyTorch counterpart of ``brainiak_tpu.ops.kernels.ring``: one step of
the ring of :mod:`brainiak_tpu_torch.ops.distla` places the product of
the resident columns and the panel the shard holds at the panel's
column block of the shard's output rows,

    out[:, owner * B:(owner + 1) * B] = z_local.T @ rotating,

and leaves every other column block as it was.  :func:`ring_mma`
writes in place.  On a CUDA tensor it launches a hand-written kernel
that replaces the Pallas kernel
``brainiak_tpu/ops/kernels/ring.py::ring_mma``:

- ``csrc/ring_mma_tc.cu``, every call: 3xTF32 on the tensor cores
  (``wgmma``, TMA stages).  Its pre-pass kernel, :func:`split`, writes
  an operand as K-major ``hi``/``lo`` buffers (:func:`split_kmajor` is
  its plain version).  :func:`ring_mma` takes such a :class:`Split` in
  place of a tensor, so a ring splits each shard once
  (``ops.distla``); a tensor it is given is split at the call, once
  when the panel is the resident block itself;
- ``csrc/ring_mma.cu``, only when forced
  (``_kernel_ring_mma(..., route="ffma")``, as ``chip_smoke.py`` does
  to compare them): a tiled fp32 FMA SGEMM.

On a CPU tensor it runs :func:`mma_update`, the same step in plain
PyTorch.  Both kernels keep fp32 accuracy whatever ``precision`` says;
the plain version honours it.

The owner index is a host integer: the port's ring is a Python loop,
so the column offset is known when the step launches.  The JAX
package's tile picking and its ``BRAINIAK_TPU_RING_STEP`` switch are
TPU VMEM logic and have no counterpart.
"""

import ctypes
from typing import NamedTuple

import torch

from ...device import matmul_precision
from . import _build

__all__ = ["Split", "launches", "mma_update", "reset_launches", "ring_mma",
           "split", "split_kmajor", "t_padded"]

#: launches since the last reset: ``ring_mma`` every K5 launch,
#: ``ring_mma_tc`` / ``ring_mma_ffma`` those of each route,
#: ``ring_split`` the tensor-core route's pre-pass
_launches = {"ring_mma": 0, "ring_mma_tc": 0, "ring_mma_ffma": 0,
             "ring_split": 0}


def launches(route=None):
    """K5 launches since the last :func:`reset_launches`: all of them,
    or those of one ``route`` (``"tc"``, ``"ffma"``, or ``"split"`` for
    the tensor-core route's pre-pass)."""
    key = "ring_mma" if route is None else \
        "ring_split" if route == "split" else f"ring_mma_{route}"
    if key not in _launches:
        raise ValueError(f"no K5 route {route!r}")
    return _launches[key]


def reset_launches():
    for key in _launches:
        _launches[key] = 0


def mma_update(out, z_local, rotating, col_start, precision=None):
    """Plain version of K5: ``out[:, col_start:col_start + B] =
    z_local.T @ rotating`` in place (``B = rotating.shape[1]``).
    Returns ``out``."""
    n_block = rotating.shape[1]
    with matmul_precision(precision) as dtype:
        block = torch.matmul(z_local.T.to(dtype), rotating.to(dtype))
    out[:, col_start:col_start + n_block] = block.to(out.dtype)
    return out


def t_padded(n_trs):
    """The split buffers' row length: T rounded up to a whole number of
    the kernel's 32-row stages (at least one)."""
    return 32 * max(1, -(-n_trs // 32))


def split_kmajor(x, t_pad):
    """Plain version of the tensor-core route's pre-pass: x [T, n]
    float32 -> ``(hi, lo)``, both [n, t_pad] float32 (K-major), with
    ``hi`` x rounded to TF32 (to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32``: its 13 low bits zero), ``lo = x - hi``
    (exact, not rounded), and zeros for t >= T.  A NaN stays NaN in
    ``hi + lo``."""
    n_trs, n = x.shape
    xt = torch.zeros((n, t_pad), dtype=torch.float32, device=x.device)
    xt[:, :n_trs] = x.T
    hi = ((xt.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return hi, xt - hi


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


def _fn(source, name, argtypes):
    fn = getattr(_build.load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


class Split(NamedTuple):
    """A [T, n] float32 operand as the tensor-core kernel reads it:
    ``hi`` and ``lo`` [n, t_pad] float32, K-major, as
    :func:`split_kmajor` gives them.  It stands in for the tensor in
    :func:`ring_mma` and is handed round a ring as a panel is."""
    hi: torch.Tensor
    lo: torch.Tensor
    n_trs: int

    @property
    def shape(self):
        return (self.n_trs, self.hi.shape[0])

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def device(self):
        return self.hi.device

    def dim(self):
        return 2

    def to(self, device):
        """The split on ``device`` (itself there, as ``Tensor.to``)."""
        return Split(self.hi.to(device), self.lo.to(device), self.n_trs)


def split(x):
    """The tensor-core route's pre-pass kernel on a CUDA [T, n] float32
    tensor, read in any strides: one launch, a :class:`Split`."""
    if not x.is_cuda:
        raise ValueError("the K5 pre-pass takes CUDA tensors")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"split takes a 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    n_trs, n = x.shape
    t_pad = t_padded(n_trs)
    hi = torch.empty((n, t_pad), dtype=torch.float32, device=x.device)
    lo = torch.empty_like(hi)
    with torch.cuda.device(x.device):
        err = _fn("ring_mma_tc", "ring_split_f32",
                  [_PTR] * 3 + [_INT] + [_LL] * 3 + [_INT, _PTR])(
            x.data_ptr(), hi.data_ptr(), lo.data_ptr(), n_trs, n,
            x.stride(0), x.stride(1), t_pad, _stream(x))
    _build.check(err, "ring_split")
    _launches["ring_split"] += 1
    return Split(hi, lo, n_trs)


def _launch_tc(out, a, b, col_start):
    n_local, t_pad = a.hi.shape
    n_block = b.hi.shape[0]
    ld_out = out.stride(0)
    # float2 stores need 8-byte aligned rows and block
    vec = out.data_ptr() % 8 == 0 and ld_out % 2 == 0 and col_start % 2 == 0
    with torch.cuda.device(out.device):
        err = _fn("ring_mma_tc", "ring_mma_tc_f32",
                  [_PTR] * 5 + [_INT] + [_LL] * 4 + [_INT, _PTR])(
            a.hi.data_ptr(), a.lo.data_ptr(), b.hi.data_ptr(),
            b.lo.data_ptr(), out.data_ptr(), t_pad, n_local, n_block,
            ld_out, col_start, int(vec), _stream(out))
    _build.check(err, "ring_mma_tc")


def _launch_ffma(out, z_local, rotating, col_start):
    z_local = z_local.contiguous()
    rotating = rotating.contiguous()
    n_trs, n_local = z_local.shape
    n_block = rotating.shape[1]
    ld_out = out.stride(0)
    vec = all(x.data_ptr() % 16 == 0 for x in (z_local, rotating, out)) \
        and n_local % 4 == 0 and n_block % 4 == 0 and ld_out % 4 == 0 \
        and col_start % 4 == 0
    with torch.cuda.device(out.device):
        err = _fn("ring_mma", "ring_mma_f32",
                  [_PTR] * 3 + [_INT] + [_LL] * 4 + [_INT, _PTR])(
            z_local.data_ptr(), rotating.data_ptr(), out.data_ptr(),
            n_trs, n_local, n_block, ld_out, col_start, int(vec),
            _stream(out))
    _build.check(err, "ring_mma")


def _kernel_ring_mma(out, z_local, rotating, owner, *, n_shards,
                     route="tc"):
    """K5 on the card: ``route="tc"`` the tensor-core kernel (operands
    tensors or :class:`Split`), ``"ffma"`` the FMA kernel (tensors),
    forced as ``chip_smoke.py`` does to time both on the same
    inputs."""
    if route not in ("tc", "ffma"):
        raise ValueError(f"route must be 'tc' or 'ffma', got {route!r}")
    owner = int(owner)
    _check(out, z_local, rotating, owner, n_shards)
    if not out.is_cuda:
        raise ValueError("the K5 kernels take CUDA tensors")
    col_start = owner * rotating.shape[1]
    if route == "tc":
        a = z_local if isinstance(z_local, Split) else split(z_local)
        # the one-position ring's panel is its resident block: split once
        b = a if rotating is z_local else rotating \
            if isinstance(rotating, Split) else split(rotating)
        _launch_tc(out, a, b, col_start)
    else:
        if isinstance(z_local, Split) or isinstance(rotating, Split):
            raise ValueError("the FMA kernel reads the operands unsplit")
        _launch_ffma(out, z_local, rotating, col_start)
    _launches["ring_mma"] += 1
    _launches[f"ring_mma_{route}"] += 1
    return out


def ring_mma(out, z_local, rotating, owner, *, n_shards, precision=None):
    """K5: one fused ring step, in place.

    out : [V_local, n_shards * B] float32, rows may be a slab of a wider
        buffer (unit column stride); z_local : [T, V_local];
    rotating : [T, B] (on CUDA either may be a :class:`Split`); owner :
        the column block (a host int) that the panel owns.
    Returns ``out`` with block ``owner`` overwritten by
    ``z_local.T @ rotating`` and every other block untouched.  A CUDA
    tensor goes to the tensor-core kernel, a CPU tensor to
    :func:`mma_update`.
    """
    if out.is_cuda:
        return _kernel_ring_mma(out, z_local, rotating, owner,
                                n_shards=n_shards)
    owner = int(owner)
    _check(out, z_local, rotating, owner, n_shards)
    return mma_update(out, z_local, rotating, owner * rotating.shape[1],
                      precision)
