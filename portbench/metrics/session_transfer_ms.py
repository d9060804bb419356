"""Upload and readback time a frame, as the Session reports it. (portbench/readers.py)"""

from portbench import readers


def read(r):
    return readers.session_transfer_ms(r)
