"""Device resolution and matmul precision for the PyTorch port.

Every entry point of :mod:`brainiak_tpu_torch` takes an explicit
``device=`` argument that defaults to ``"cuda"``.  Without a CUDA
device the call raises instead of carrying on silently on the CPU:
the CPU is used only when the caller asks for it (``device="cpu"``),
as the tests do.

Precision names follow the JAX package (``'highest'`` / ``'high'`` /
``'default'``) with a Hopper meaning for the plain matmul paths:

========== ===========================================
'highest'  full fp32 (TF32 off)
'high'     TF32 tensor-core products
'default'  bf16 operands, fp32 result
========== ===========================================

The hand-written kernels keep fp32 accuracy (fp32 FMA, or 3xTF32 on
the tensor cores) whatever the name says.
"""

import contextlib

import torch

__all__ = ["PRECISIONS", "matmul_precision", "resolve_device",
           "resolve_precision", "set_fp32_defaults"]

#: precision name -> operand dtype of the plain matmul paths
PRECISIONS = {
    "highest": torch.float32,
    "high": torch.float32,
    "default": torch.bfloat16,
}


def set_fp32_defaults():
    """Turn TF32 off for matmuls and convolutions, so that a float32
    product on the card is a float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda"):
    """Return a ``torch.device``; raise ``RuntimeError`` for a CUDA
    device when none is available (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "brainiak_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        set_fp32_defaults()
    return dev


def resolve_precision(precision):
    """Map ``None`` / 'highest' / 'high' / 'default' (any case, or an
    object whose ``name`` is one of them, such as a
    ``jax.lax.Precision``) to the canonical lower-case name."""
    if precision is None:
        return "highest"
    name = str(getattr(precision, "name", precision)).lower()
    if name not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {sorted(PRECISIONS)}; "
            f"got {precision!r}")
    return name


@contextlib.contextmanager
def matmul_precision(precision):
    """Context for a plain matmul: yields the operand dtype and lets
    TF32 run only under 'high'.  The previous TF32 setting is
    restored on exit."""
    name = resolve_precision(precision)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = name == "high"
    try:
        yield PRECISIONS[name]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
