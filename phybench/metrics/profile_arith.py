"""The benchmark's frozen copy of the profiling arithmetic:
``lora_phy_tpu_torch/utils/profiling.range_profile``'s attribution of
device events to ``record_function`` ranges and its busy union, kept here
so that the yardstick stays put when the program's copy changes. One
addition: the device's idle time between busy intervals, named by the
innermost host range that was open at the gap's middle.

It reads the events of one ``torch.profiler.profile`` window of
``calls`` calls and sums over the window; readers divide by ``calls``.
"""

from __future__ import annotations

import collections
import dataclasses

from torch.autograd import DeviceType


@dataclasses.dataclass
class TraceSummary:
    """One traced window.

    ``ranges[name] = (device_s, host_s, events)``: the device events the
    profiler links to ops inside each range (each event counted once, in
    the range that launched it), their seconds, and the range's own host
    seconds; ``other`` the same for device events outside every range;
    ``kernels[name]`` device seconds by kernel name; ``busy_s`` the union
    of all device events' intervals; ``window_s`` the host wall time of
    the window; ``idle_by_host[name]`` idle device seconds by the host
    range open at the gap's middle; ``spans[name]`` the harness's own host
    seconds by span."""

    calls: int
    window_s: float
    busy_s: float
    events: int
    ranges: dict
    other: tuple
    kernels: dict
    idle_by_host: dict
    spans: dict = dataclasses.field(default_factory=dict)


def _is_device_event(e, names) -> bool:
    """A device activity (kernel, copy, set) rather than the device-side
    span of a ``record_function`` range."""
    return (e.device_type == DeviceType.CUDA and e.name not in names
            and not getattr(e, "is_user_annotation", False)
            and "annotation" not in str(getattr(e, "activity_type", "") or ""))


def busy_intervals(spans):
    """The merged (start, end) intervals of the union, in order."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, names, naming, calls: int, window_s: float,
              window_us: tuple | None = None) -> TraceSummary:
    """:class:`TraceSummary` of profiler ``events`` (``prof.events()``)
    with ``names`` the ranges that device events are attributed to and
    ``naming`` the ranges that name idle gaps (innermost wins). Times in
    the events are microseconds; ``window_us`` bounds the idle gaps
    (default: from the first device event to the last)."""
    events = list(events)
    device = [e for e in events if _is_device_event(e, set(names) | set(naming))]
    unclaimed = collections.Counter((e.name, e.time_range.elapsed_us()) for e in device)

    def subtree(e):
        us, count = 0.0, 0
        for k in e.kernels:
            if unclaimed[(k.name, k.duration)] > 0:
                unclaimed[(k.name, k.duration)] -= 1
                us, count = us + k.duration, count + 1
        for ch in e.cpu_children:
            c_us, c_n = subtree(ch)
            us, count = us + c_us, count + c_n
        return us, count

    acc = {name: [0.0, 0.0, 0] for name in names}
    for r in events:
        if r.device_type == DeviceType.CPU and r.name in acc:
            us, count = subtree(r)
            acc[r.name][0] += us
            acc[r.name][1] += r.time_range.elapsed_us()
            acc[r.name][2] += count
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    kernels = collections.Counter()
    for e in device:
        kernels[e.name] += e.time_range.elapsed_us() / 1e6
    other_us = sum(e.time_range.elapsed_us() for e in device) - sum(v[0] for v in acc.values())
    other_n = len(device) - sum(v[2] for v in acc.values())
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CPU and e.name in naming),
                  key=lambda x: x[0])
    idle = collections.Counter()
    merged = busy_intervals(spans)
    busy_us = sum(b - a for a, b in merged)
    if merged:
        lo, hi = window_us if window_us else (merged[0][0], merged[-1][1])
        edges = [(lo, lo)] + [tuple(m) for m in merged] + [(hi, hi)]
        for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            inner = [h for h in host if h[0] <= mid < h[1]]
            name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "(no range)"
            idle[name] += (b - a) / 1e6
    return TraceSummary(
        calls=calls, window_s=window_s, busy_s=busy_us / 1e6,
        events=len(device),
        ranges={name: (v[0] / 1e6, v[1] / 1e6, v[2]) for name, v in acc.items()},
        other=(other_us / 1e6, other_n), kernels=dict(kernels), idle_by_host=dict(idle))


def idle_share(trace: TraceSummary):
    """One minus busy over the window's wall time, or None without device
    events."""
    if trace.events == 0 or trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s
