"""The layer-guided step's share of its roofline, in the layers files cell. (portbench/readers.py)"""

from portbench import readers


def read(r):
    return readers.step_roofline_pct(r, "layer_guided_files")
