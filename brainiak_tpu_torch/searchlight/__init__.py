"""The searchlight engine: a user function over every active voxel's
neighbourhood, on the host or as one vmapped sweep on the device."""

from .searchlight import Ball, Cube, Diamond, Searchlight, Shape

__all__ = ["Ball", "Cube", "Diamond", "Searchlight", "Shape"]
