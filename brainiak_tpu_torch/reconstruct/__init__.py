"""Inverted encoding models (1D and 2D feature reconstruction) on a
CUDA device: the port of ``brainiak_tpu/reconstruct``."""

from .iem import InvertedEncoding1D, InvertedEncoding2D  # noqa: F401
