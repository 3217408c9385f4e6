"""The readers of the program's own ranges (``planar.*``, ``coded.decode``,
``host_sync``, ``modem.decode``) on a synthetic trace with known answers,
through the frozen attribution of ``metrics/profile_arith.py`` as the
harness calls it; and each reader's None where its range is absent.

Run: ``python -m pytest phybench/tests -q -p no:cacheprovider``.
"""

import types

import pytest
from torch.autograd import DeviceType

from phybench import run
from phybench.metrics import profile_arith

BULK = ("bulk.dechirp_device_ms", "bulk.front_device_ms", "bulk.decide_device_ms",
        "bulk.decode_device_ms", "bulk.sync_wait_ms")
GATEWAY = ("gw.sync_wait_ms", "gw.host_decode_ms")


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    def __init__(self, name, device, start, end, kernels=(), children=()):
        self.name, self.time_range = name, _Range(start, end)
        self.device_type = device
        self.kernels = list(kernels)
        self.cpu_children = list(children)


def reader(name):
    return run.load_file_module(run.HERE / "metrics" / f"{name}.py", name)


def ranges_of(names):
    return tuple(dict.fromkeys(r for n in names for r in reader(n).RANGES))


def op(name, start, end, kernel, duration):
    return _Event(name, DeviceType.CPU, start, end,
                  kernels=[types.SimpleNamespace(name=kernel, duration=duration)])


def kernel(name, start, duration):
    return _Event(name, DeviceType.CUDA, start, start + duration)


def bulk_call(t0):
    """One bulk call's host ranges from ``t0`` (us), with the device
    events they launch: dechirp 6, scale 1, estimate 2 (its host_sync
    waits 5 us on the host and launches a 1 us copy), windows 3 (a
    host_sync of 4 us inside, the gather after it), decide 2, decode 1."""
    sync1_op = op("aten::copy_", t0 + 12, t0 + 16, "memcpy_htod", 1)
    sync2_op = op("aten::item", t0 + 22, t0 + 25, "memcpy_dtoh", 1)
    host = [
        _Event("planar.dechirp", DeviceType.CPU, t0, t0 + 5,
               children=[op("aten::mul", t0 + 1, t0 + 2, "dechirp_k", 6)]),
        _Event("planar.scale", DeviceType.CPU, t0 + 5, t0 + 8,
               children=[op("aten::aminmax", t0 + 6, t0 + 7, "minmax_k", 1)]),
        _Event("planar.estimate", DeviceType.CPU, t0 + 8, t0 + 20, children=[
            op("aten::mm", t0 + 9, t0 + 10, "sgemm_k", 1),
            _Event("host_sync", DeviceType.CPU, t0 + 11, t0 + 16, children=[sync1_op])]),
        _Event("planar.windows", DeviceType.CPU, t0 + 20, t0 + 30, children=[
            _Event("host_sync", DeviceType.CPU, t0 + 21, t0 + 25, children=[sync2_op]),
            op("aten::gather", t0 + 26, t0 + 27, "gather_k", 2)]),
        _Event("planar.decide", DeviceType.CPU, t0 + 30, t0 + 33,
               children=[op("fused_demod", t0 + 31, t0 + 32, "fused_demod_kernel", 2)]),
        _Event("coded.decode", DeviceType.CPU, t0 + 33, t0 + 36,
               children=[op("aten::bitwise_xor", t0 + 34, t0 + 35, "xor_k", 1)]),
    ]
    flat = []

    def walk(e):
        flat.append(e)
        for c in e.cpu_children:
            walk(c)

    for e in host:
        walk(e)
    dev = [kernel("dechirp_k", t0 + 2, 6), kernel("minmax_k", t0 + 8, 1),
           kernel("sgemm_k", t0 + 10, 1), kernel("memcpy_htod", t0 + 15, 1),
           kernel("memcpy_dtoh", t0 + 24, 1), kernel("gather_k", t0 + 28, 2),
           kernel("fused_demod_kernel", t0 + 32, 2), kernel("xor_k", t0 + 35, 1)]
    return flat, dev


def summarize(events, names, calls):
    names = (*names, "readout")
    return profile_arith.summarize(sorted(events, key=lambda e: (e.time_range.start,
                                                                 -e.time_range.end)),
                                   names, (*names, "device"), calls=calls, window_s=1e-3)


def test_bulk_readers_read_their_ranges_with_host_sync_nested():
    host, dev = bulk_call(0)
    s = summarize([*host, *dev], ranges_of(BULK), calls=1)
    ctx = types.SimpleNamespace(trace=s)
    got = {name: reader(name).read(ctx) for name in BULK}
    assert got == pytest.approx({
        "bulk.dechirp_device_ms": 6e-3, "bulk.front_device_ms": 6e-3,
        "bulk.decide_device_ms": 2e-3, "bulk.decode_device_ms": 1e-3,
        "bulk.sync_wait_ms": 9e-3})
    # the outer ranges keep the copies; host_sync keeps only its host time
    assert s.ranges["host_sync"] == (0.0, pytest.approx(9e-6), 0)
    assert s.ranges["planar.estimate"][0] == pytest.approx(2e-6)
    assert s.ranges["planar.windows"][0] == pytest.approx(3e-6)
    # every device us of the call is in one of the four bulk ranges
    staged = sum(got[n] for n in BULK[:4])
    assert staged == pytest.approx(sum(s.kernels.values()) * 1e3)


def test_bulk_readers_over_calls_count_each_event_once():
    """Over several calls the frozen attribution matches a launch to a
    device event by kernel name and duration, so a nested host_sync can
    take a copy of the same name and length from a later call's outer
    range: the split may move, the sum over the ranges may not."""
    events = []
    for t0 in (0, 100, 200):
        host, dev = bulk_call(t0)
        events += [*host, *dev]
    s = summarize(events, ranges_of(BULK), calls=3)
    ctx = types.SimpleNamespace(trace=s)
    staged = sum(reader(n).read(ctx) for n in BULK[:4]) + s.ranges["host_sync"][0] / 3 * 1e3
    assert staged == pytest.approx(sum(s.kernels.values()) / 3 * 1e3)
    assert reader("bulk.sync_wait_ms").read(ctx) == pytest.approx(9e-3)
    assert reader("bulk.dechirp_device_ms").read(ctx) == pytest.approx(6e-3)


def test_gateway_readers_read_host_sync_and_host_decode():
    sync_op = op("aten::copy_", 3, 6, "memcpy_htod", 1)
    estimator = _Event("estimator", DeviceType.CPU, 0, 10, children=[
        _Event("host_sync", DeviceType.CPU, 2, 7, children=[sync_op])])
    decode = _Event("modem.decode", DeviceType.CPU, 30, 38)
    readout = _Event("readout", DeviceType.CPU, 20, 40, children=[decode])
    events = [estimator, *estimator.cpu_children, sync_op, readout, decode,
              kernel("memcpy_htod", 6, 1)]
    s = summarize(events, ("estimator", *ranges_of(GATEWAY)), calls=1)
    ctx = types.SimpleNamespace(trace=s)
    assert reader("gw.sync_wait_ms").read(ctx) == pytest.approx(5e-3)
    assert reader("gw.host_decode_ms").read(ctx) == pytest.approx(8e-3)
    assert s.ranges["estimator"][2] == 1 and s.ranges["host_sync"][2] == 0


@pytest.mark.parametrize("name", BULK + GATEWAY)
def test_reader_finds_nothing_without_its_range(name):
    """A program without the range (the parent of the change that added
    it) or a trace with no device events: None, not an error."""
    ops = [op("aten::mul", 1, 2, "k", 3)]
    other = _Event("front", DeviceType.CPU, 0, 5, children=ops)
    s = summarize([other, *ops, kernel("k", 2, 3)], ("front", *reader(name).RANGES), calls=1)
    assert reader(name).read(types.SimpleNamespace(trace=s)) is None
    empty = summarize([], reader(name).RANGES, calls=1)
    assert reader(name).read(types.SimpleNamespace(trace=empty)) is None
