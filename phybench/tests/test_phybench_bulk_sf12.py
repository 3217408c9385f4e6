"""The cell ``bulk-sf12-b3328`` (the upstream's ``sf12_bw500_cr45`` on the
bulk coded decoder's exact float32 route) on the CPU at a small size: a
run end to end and traced, its readers on a synthetic trace with known
answers, the frozen count of the per-symbol stage's work at the cell's
size, the reference's blocks, and the TF32 control failing the check.

Run: ``python -m pytest phybench/tests -q -p no:cacheprovider``.
"""

import types

import pytest
import torch
from torch.autograd import DeviceType

from phybench import run
from phybench.metrics import kernel_bound, profile_arith
from phybench.reference import bulk as rbulk
from phybench.reference import bulk_wide as rwide
from phybench.traffic import generator

CPU = torch.device("cpu")
CELL = "bulk-sf12-b3328"
READERS = ("bulk.idle_share", "bulk.dechirp_device_ms", "bulk.front_device_ms",
           "bulk.decide_device_ms", "bulk.decode_device_ms", "bulk.sync_wait_ms",
           "bulk.decide_roofline")
# the readers that read the host alone: all that a CPU trace reports
HOST_READERS = {"bulk.sync_wait_ms"}
# the ranges of one bulk call and the device us each launches in the
# synthetic trace below
DEVICE_US = {"planar.dechirp": 2, "planar.scale": 3, "planar.estimate": 5,
             "planar.windows": 7, "planar.decide": 40, "coded.decode": 1}


def small_cell(batch=(2, 8)):
    cell = run.Cell.load(CELL)
    cell.traffic.update(batch=list(batch), pool=2)
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
        assert set(res["metrics"]) == {"packets_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert {m["name"] for m in cell.metrics("per_layer")} == set(READERS)
        # on the CPU the trace holds no device event: only host times
        assert set(res["metrics"]) == HOST_READERS
        assert all(v["value"] > 0 for v in res["metrics"].values())


def test_decide_count_is_pinned_at_the_cells_size():
    """3,328 frames of 2 sync + 30 coded windows of 4,096 samples: the
    bound is the bytes, 1.042 ms at 3.35 TB/s."""
    cell = run.Cell.load(CELL)
    frames = generator.call_size(cell.config, cell.traffic)[1]
    rows = frames * (2 + generator.payload_symbol_count(cell.config))
    assert (frames, rows) == (3_328, 106_496)
    flops, nbytes = kernel_bound.fused_demod_count(rows, 4096)
    assert flops == rows * (5 * 4096 * 12 + 14 * 4096) == 32_279_363_584
    assert nbytes == 4 * (2 * rows * 4096 + 4 * rows + 2 * 4096) == 3_491_397_632
    bound, by = kernel_bound.fused_demod_bound_s(rows, 4096)
    assert by == "bytes" and bound * 1e3 == pytest.approx(1.04221, abs=1e-5)


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


def bulk_call():
    """One call's host ranges (10 us each, one op launching one kernel of
    ``DEVICE_US`` inside), a 4 us ``host_sync`` range, and the device
    events back to back from 100 us."""
    host, dev, t_dev = [], [], 100
    for i, (name, us) in enumerate(DEVICE_US.items()):
        t = 20 * i
        op = _Event("aten::mul", DeviceType.CPU, t + 1, t + 2, kernels=[
            types.SimpleNamespace(name=f"{name}_k", duration=us)])
        host += [_Event(name, DeviceType.CPU, t, t + 10, children=[op]), op]
        dev.append(_Event(f"{name}_k", DeviceType.CUDA, t_dev, t_dev + us))
        t_dev += us
    host.append(_Event("host_sync", DeviceType.CPU, 200, 204))
    return host + dev


def read_all(events):
    cell = run.Cell.load(CELL)
    ranges = tuple(dict.fromkeys((*run.path_module(cell).RANGES, *(
        r for n in READERS for r in getattr(reader(n), "RANGES", ())))))
    assert "planar.fourstep" not in ranges
    names = (*ranges, "readout")
    summary = profile_arith.summarize(
        sorted(events, key=lambda e: (e.time_range.start, -e.time_range.end)),
        names, (*names, "device"), calls=1, window_s=1e-3)
    ctx = run.MetricContext(summary, cell.config, cell.traffic)
    return {name: reader(name).read(ctx) for name in READERS}


def test_readers_read_every_range_of_the_call():
    got = read_all(bulk_call())
    bound_ms = kernel_bound.fused_demod_bound_s(106_496, 4096)[0] * 1e3
    assert got == pytest.approx({
        "bulk.idle_share": 1.0 - 58e-6 / 1e-3, "bulk.dechirp_device_ms": 2e-3,
        "bulk.front_device_ms": 15e-3, "bulk.decide_device_ms": 40e-3,
        "bulk.decode_device_ms": 1e-3, "bulk.sync_wait_ms": 4e-3,
        "bulk.decide_roofline": 100.0 * bound_ms / 40e-3})


def test_device_readers_read_nothing_in_an_empty_trace():
    got = read_all([])
    assert all(got[name] is None for name in READERS)


# ---------------------------------------------------------------------------
# the reference's blocks and the control
# ---------------------------------------------------------------------------

def test_reference_computes_in_blocks_of_512_frames(monkeypatch):
    """Each entry of the wide reference calls the bulk reference's steps
    in blocks of 512 frames: the float64 check fits beside the program's
    cached memory at N = 4096."""
    chunks = []

    def spy(f):
        def wrapped(*a, **k):
            chunks.append(k["chunk"])
            return f(*a, **k)
        return wrapped

    monkeypatch.setattr(rbulk, "demodulate", spy(rbulk.demodulate))
    monkeypatch.setattr(rbulk, "judge", spy(rbulk.judge))
    cell = small_cell((1, 4))
    item = generator.make_pool(cell.config, dict(cell.traffic, pool=1), 5, CPU)[0]
    ref = rwide.reference_outputs(item, cell.config)
    out = rwide.System(cell.config, CPU, "f32").device(item)
    nums = rwide.judge(item, out, ref, cell.config)
    assert chunks == [512, 512, 512] and nums["decode_mismatch"] == 0
    # the float32 reference in its place reads its own estimates
    assert nums["cfo_err_f32"] == (0.0, 4) and nums["to_err_f32"] == (0.0, 4)


def test_control_fails_the_check():
    """The TF32 control on 4 x 32 frames, one call compared: its CFO and
    timing estimates leave the float32 reference's in more frames than
    the cell's limits let through (``cfo_err_f32``, ``to_err_f32``), while
    its decisions and bytes are those of the reference."""
    cell = small_cell((4, 32))
    cell.workload.update(check_calls=1)
    res = run.run_cell(cell, 2 ** 31 + 5, 0.1, False, CPU, control="tf32", log=quiet)
    assert res["correct"] is False, res["check"]
    over = {k for k, c in res["check"].items() if c["value"] > c["limit"]}
    assert over == {"cfo_err_f32", "to_err_f32"}, res["check"]


def test_sound_estimates_are_the_float32_references():
    """The program's CFO and timing estimates equal the reference's own
    float32 estimates on the CPU: both compared numbers read 0."""
    cell = small_cell((4, 32))
    cell.workload.update(check_calls=1)
    res = run.run_cell(cell, 2 ** 31 + 5, 0.1, False, CPU, log=quiet)
    assert res["correct"] is True, res["check"]
    assert res["check"]["cfo_err_f32"]["value"] == 0.0, res["check"]
    assert res["check"]["to_err_f32"]["value"] == 0.0, res["check"]
