"""Host time a frame spends in Session.run outside its report. (portbench/readers.py)"""

from portbench import readers


def read(r):
    return readers.session_host_ms(r)
