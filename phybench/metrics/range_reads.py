"""What the readers of the program's own ranges share: a range's device
or host milliseconds per call from the traced window's summary
(:class:`.profile_arith.TraceSummary`), or None where the program opened
no such range (a program without it, or a run with no device events)."""


def device_ms(trace, names):
    """Device ms per call of the events linked to the ranges ``names``,
    or None when they hold no device event."""
    parts = [trace.ranges.get(name, (0.0, 0.0, 0)) for name in names]
    if sum(p[2] for p in parts) == 0:
        return None
    return sum(p[0] for p in parts) / trace.calls * 1e3


def host_ms(trace, name):
    """Host ms per call of the range ``name``, or None when it was never
    opened."""
    _, host_s, _ = trace.ranges.get(name, (0.0, 0.0, 0))
    if host_s <= 0:
        return None
    return host_s / trace.calls * 1e3
