"""Reading a torch.profiler Chrome trace: the harness's spans, the device's
events, their busy union, and the breakdown a traced run prints.

`busy_ms` is a frozen copy of `chip_smoke.py:busy_ms`; `read_trace` is
`chip_smoke.py:read_trace` with every span of a name kept (the harness opens
one span a frame) and the host's own events kept for the idle gaps' labels.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math

DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_EVENTS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


def busy_ms(intervals) -> float:
    """The length of the union of (start, end) intervals in microseconds, in
    milliseconds."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


@dataclasses.dataclass
class Trace:
    """A traced run: spans by name ([(start, end)] in microseconds), the
    device's events and the host's, as the trace's dicts."""

    spans: dict
    device: list
    host: list

    def device_in(self, start: float, end: float, cats=DEVICE_EVENTS) -> list:
        """(start, end) of the device events of `cats`, clipped to [start, end),
        those outside left out."""
        out = []
        for e in self.device:
            if e["cat"] not in cats:
                continue
            s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            s, t = max(s, start), min(t, end)
            if t > s:
                out.append((s, t))
        return out


def read_trace(path: str, span_names) -> Trace:
    """The Chrome trace at path: every span (user annotation) named in
    span_names, the device's kernels, copies and fills, and the host's
    operator and runtime events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans: dict = {}
    device, host = [], []
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation" and e.get("name") in span_names:
            start = float(e["ts"])
            spans.setdefault(e["name"], []).append((start, start + float(e["dur"])))
        elif cat in DEVICE_EVENTS:
            device.append(e)
        elif cat in HOST_EVENTS and "dur" in e:
            host.append(e)
    for v in spans.values():
        v.sort()
    return Trace(spans, device, host)


def busy_in(trace: Trace, spans, cats=DEVICE_EVENTS) -> float:
    """ms in which a device event of `cats` ran inside the spans, summed
    over the spans (each span's union). One sweep: the events sorted by
    start, each span reads those that can reach into it."""
    events = sorted(trace.device_in(-math.inf, math.inf, cats))
    if not events:
        return 0.0
    starts = [s for s, _ in events]
    longest = max(e - s for s, e in events)
    total = 0.0
    for s0, e0 in spans:
        lo, hi = bisect.bisect_left(starts, s0 - longest), bisect.bisect_left(starts, e0)
        total += busy_ms([(max(s, s0), min(e, e0)) for s, e in events[lo:hi]
                          if min(e, e0) > max(s, s0)])
    return total


def _host_label(trace: Trace, spans: dict, t: float) -> str:
    """What the host did at time t: the harness span that holds t, and the
    innermost host operator or runtime call that does ("python" where none
    does: the program's own Python, or the native codec)."""
    outer = next((name for name, ivs in spans.items()
                  for s, e in ivs if s <= t < e), "harness")
    inner, inner_len = "python", math.inf
    for e in trace.host:
        s = float(e["ts"])
        d = float(e["dur"])
        if s <= t < s + d and d < inner_len:
            inner, inner_len = e["name"], d
    return f"{outer}/{inner}"


def breakdown(trace: Trace, window: tuple[float, float], step_spans: dict) -> dict:
    """The traced window's device operations that took most time, by name,
    and its longest idle gaps, each named by what the host was doing then:
    [[name, seconds], ...], at most TOP entries each."""
    start, end = window
    by_name: dict = {}
    for e in trace.device:
        s, t = max(float(e["ts"]), start), min(float(e["ts"]) + float(e.get("dur", 0.0)), end)
        if t > s:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    reach = start
    for s, t in sorted(trace.device_in(start, end)):
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, t)
    if end > reach:
        gaps.append((reach, end))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    idle = [[_host_label(trace, step_spans, (s + t) / 2), (t - s) / 1e6] for s, t in gaps]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
