"""The cell ``gw-dr0-pool128`` (EU868 DR0, SF12, on the block receiver)
on the CPU at a small size: a run end to end and traced, its readers on
a synthetic trace with known answers, with and without the program's
``planar.fourstep`` range nested in the stages (no reader names it, so
the stages keep their events), the frozen count of the scan's work, and
the TF32 control failing the check.

Run: ``python -m pytest phybench/tests -q -p no:cacheprovider``.
"""

import types

import pytest
import torch
from torch.autograd import DeviceType

from phybench import run
from phybench.metrics import profile_arith, scan_bound

CPU = torch.device("cpu")
CELL = "gw-dr0-pool128"
READERS = ("gw.scan_device_ms", "gw.rx_launches", "gw.readout_ms", "gw.idle_share",
           "gw.sync_wait_ms", "gw.host_decode_ms", "dr0.lanes_device_ms",
           "dr0.scan_roofline")
# the readers that read the host alone: all that a CPU trace reports
HOST_READERS = {"gw.readout_ms", "gw.sync_wait_ms", "gw.host_decode_ms"}
# channels at which the control fails the check under the cell's limits
CONTROL_CHANNELS = 4
STAGES = ("gather", "probes", "sections", "dechirp", "estimator", "demod", "sro")


def small_cell(channels=4):
    cell = run.Cell.load(CELL)
    cell.traffic.update(channels=channels, pool=2)
    cell.workload.update(check_calls=2, trace_calls=2)
    return cell


def quiet(_msg):
    pass


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_cell_is_correct_and_reports_exactly_its_metrics(trace):
    cell = small_cell()
    res = run.run_cell(cell, 2 ** 33 + 11, 0.3, trace, CPU, log=quiet)
    assert res["correct"] is True, res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    if not trace:
        assert set(res["metrics"]) == {"rx_msps", "block_p95_ms", "setup_s"}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert {m["name"] for m in cell.metrics("per_layer")} == set(READERS)
        # on the CPU the trace holds no device event: only host times
        assert set(res["metrics"]) == HOST_READERS
        assert all(v["value"] > 0 for v in res["metrics"].values())


def test_scan_count_is_pinned_at_the_cells_size():
    samples = 128 * (1 << 20)
    flops, nbytes = scan_bound.scan_count(samples, 4096)
    assert flops == 32_768 * (2 * 5 * 4096 * 12 + 20 * 4096) == 18_790_481_920
    assert nbytes == 2 * 4 * samples + 16 * 32_768 == 1_074_266_112
    assert flops / scan_bound.PEAK_F32_FLOPS * 1e3 == pytest.approx(0.28045, abs=1e-5)
    bound, by = scan_bound.scan_bound_s(samples, 4096)
    assert by == "bytes" and bound * 1e3 == pytest.approx(0.32068, abs=1e-5)


# ---------------------------------------------------------------------------
# the readers on a synthetic trace
# ---------------------------------------------------------------------------

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


def op(start, kernel, duration):
    return _Event("aten::mm", DeviceType.CPU, start, start + 1,
                  kernels=[types.SimpleNamespace(name=kernel, duration=duration)])


def gateway_call(fourstep=True):
    """One call's host ranges and device events (us): the scan (``front``)
    launches a 40 us GEMM inside a 6 us four-step range and a 2 us pick;
    each of the seven stages launches a kernel of 1..7 us, the probes and
    the demod theirs inside a four-step range of 3 us; the readout one
    1 us copy. ``fourstep=False`` is the parent: the same without the
    four-step ranges."""
    def wrap(t, kids, host_us):
        if not fourstep:
            return kids
        return [_Event("planar.fourstep", DeviceType.CPU, t, t + host_us, children=kids)]

    host, dev, t = [], [], 0
    front = _Event("front", DeviceType.CPU, t, t + 20, children=[
        *wrap(t + 1, [op(t + 2, "sgemm_scan", 40)], 6), op(t + 10, "pick_k", 2)])
    host.append(front)
    dev += [_Event("sgemm_scan", DeviceType.CUDA, 100, 140),
            _Event("pick_k", DeviceType.CUDA, 140, 142)]
    for i, name in enumerate(STAGES, start=1):
        t = 20 * (i + 1)
        kids = [op(t + 1, f"{name}_k", i)]
        if name in ("probes", "demod"):
            kids = wrap(t, kids, 3)
        host.append(_Event(name, DeviceType.CPU, t, t + 10, children=kids))
        dev.append(_Event(f"{name}_k", DeviceType.CUDA, 150 + 10 * i, 150 + 11 * i))
    host.append(_Event("readout", DeviceType.CPU, 300, 320, children=[op(301, "memcpy", 1)]))
    dev.append(_Event("memcpy", DeviceType.CUDA, 330, 331))
    flat = []

    def walk(e):
        flat.append(e)
        for c in e.cpu_children:
            walk(c)

    for e in host:
        walk(e)
    return flat + dev


def summarize(events, names):
    names = (*names, "readout")
    return profile_arith.summarize(
        sorted(events, key=lambda e: (e.time_range.start, -e.time_range.end)),
        names, (*names, "device"), calls=1, window_s=1e-3)


def attributed_ranges():
    """The ranges a traced run of the cell attributes device events to,
    as ``run.run_cell`` gathers them: the path's and every reader's."""
    cell = run.Cell.load(CELL)
    return tuple(dict.fromkeys((*run.path_module(cell).RANGES, *(
        r for n in READERS for r in getattr(reader(n), "RANGES", ())))))


def read_all(events):
    cell = run.Cell.load(CELL)
    ctx = types.SimpleNamespace(trace=summarize(events, attributed_ranges()),
                                config=cell.config, traffic=cell.traffic)
    return {name: reader(name).read(ctx) for name in READERS}


def test_no_reader_names_the_nested_fourstep_range():
    """The frozen attribution matches a launch to a device event by kernel
    name and length: a range nested in a stage would take same-named,
    same-length events of later calls' stages. The cell attributes to the
    stages alone."""
    ranges = attributed_ranges()
    assert "planar.fourstep" not in ranges
    assert {"front", *STAGES} <= set(ranges)


def test_readers_read_the_stages_with_and_without_the_fourstep_range():
    got = read_all(gateway_call())
    bound_ms = scan_bound.scan_bound_s(128 * (1 << 20), 4096)[0] * 1e3
    assert got == pytest.approx({
        "gw.scan_device_ms": 42e-3, "gw.rx_launches": 9.0, "gw.readout_ms": None,
        "gw.idle_share": 1.0 - 71e-6 / 1e-3, "gw.sync_wait_ms": None,
        "gw.host_decode_ms": None, "dr0.lanes_device_ms": 28e-3,
        "dr0.scan_roofline": 100.0 * bound_ms / 42e-3})
    # the parent opens no four-step range: every reader reads the same
    assert read_all(gateway_call(fourstep=False)) == pytest.approx(got)


def test_device_readers_read_nothing_in_an_empty_trace():
    got = read_all([])
    assert all(got[name] is None for name in READERS)


# ---------------------------------------------------------------------------
# the control
# ---------------------------------------------------------------------------

def test_control_fails_the_check():
    res = run.run_cell(small_cell(CONTROL_CHANNELS), 2 ** 31 + 5, 0.2, False, CPU,
                       control="tf32", log=quiet)
    assert res["correct"] is False, res["check"]
