"""The share of the traced window in which the device idled, in the
files cell. (portbench/readers.py)"""

from portbench import readers


def read(r):
    return readers.device_idle_pct(r)
