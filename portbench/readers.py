"""The readings the per-layer metrics take from a traced run (each metric's
file under metrics/ names one of these)."""

from __future__ import annotations

from portbench import trace, work


def kernels_per_frame(r):
    """Device kernels a frame launches: the kernel events of the traced
    window over its frames (every launch of the step, its accumulations and
    fills included; the program's own launch counter is not read)."""
    kernels = r.trace.device_in(*r.window, cats=("kernel",))
    return len(kernels) / r.frames if kernels and r.frames else None


def device_idle_pct(r):
    """The share of the traced window in which the device ran no kernel,
    copy or fill (100 less the busy union's share)."""
    start, end = r.window
    busy = trace.busy_ms(r.trace.device_in(start, end))
    return 100.0 - 100.0 * busy * 1e3 / (end - start) if busy > 0 else None


def step_roofline_pct(r, family: str):
    """The step's share of its roofline: 100 x (the least time its work
    needs on the card, portbench/work.py, x the steps) over the kernel time
    inside the step spans; None outside the family or where no kernel
    ran."""
    if r.family != family or not r.steps:
        return None
    kernel_ms = trace.busy_in(r.trace, r.steps, cats=("kernel",))
    if kernel_ms <= 0:
        return None
    least_ms, _ = work.bound_ms(*r.step_work)
    return 100.0 * least_ms * len(r.steps) / kernel_ms


def session_host_ms(r):
    """Host time a frame spends in Session.run (with its construction)
    outside the transfer and exec its TimingReport counts: decode, encode,
    the directory scan, the alpha checks, Python."""
    if not r.session or not r.frames:
        return None
    s = r.session
    return (s["host_ns"] - s["transfer_ns"] - s["exec_ns"]) / r.frames / 1e6


def session_transfer_ms(r):
    """Upload and readback time a frame, as the Session's TimingReport counts
    it (host clock around fenced copies)."""
    if not r.session or not r.frames:
        return None
    return r.session["transfer_ns"] / r.frames / 1e6
