"""FCMA stage 1 on a CUDA device: data preparation and voxel
selection."""

from .preprocessing import RandomType, prepare_fcma_data
from .voxelselector import VoxelSelector

__all__ = ["RandomType", "VoxelSelector", "prepare_fcma_data"]
