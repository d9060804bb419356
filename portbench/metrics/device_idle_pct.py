"""The share of the traced window in which the device idled. (portbench/readers.py)"""

from portbench import readers


def read(r):
    return readers.device_idle_pct(r)
