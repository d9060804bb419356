"""The temporal NLM step's share of its roofline, in the EXR files cell. (portbench/readers.py)"""

from portbench import readers


def read(r):
    return readers.step_roofline_pct(r, "temporal_nlm_hdr")
