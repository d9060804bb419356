"""Kernels a frame launches on the device. (portbench/readers.py)"""

from portbench import readers


def read(r):
    return readers.kernels_per_frame(r)
