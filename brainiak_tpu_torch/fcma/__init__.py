"""FCMA on a CUDA device: data preparation, voxel selection (stage 1)
and correlation-based classification (stage 2)."""

from .classifier import Classifier
from .preprocessing import RandomType, prepare_fcma_data
from .voxelselector import VoxelSelector

__all__ = ["Classifier", "RandomType", "VoxelSelector",
           "prepare_fcma_data"]
