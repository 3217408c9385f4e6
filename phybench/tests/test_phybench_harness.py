"""The harness on the CPU at small sizes: a run end to end, the import
guards, the frozen arithmetic, files found by name, and the check
coming out false for the control and for a broken timed path.

Run: ``python -m pytest phybench/tests -q -p no:cacheprovider``.
"""

import json
import shutil
import sys
import types

import pytest
import torch

from lora_phy_tpu_torch.ops import planar
from phybench import run
from phybench.metrics import kernel_bound, profile_arith

CPU = torch.device("cpu")
SMALL = {
    "gw-dr5-pool2048": {"channels": 8, "pool": 2},
    "bulk-sf7-b65536": {"batch": [2, 256], "pool": 2},
}


def small_cell(name):
    cell = run.Cell.load(name)
    cell.traffic.update(SMALL[name])
    cell.workload.update(check_calls=2, trace_calls=2)
    return cell


def quiet(_msg):
    pass


@pytest.fixture(scope="module")
def card():
    """The first CUDA card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_run_is_correct_and_reports_the_cells_metrics(name, trace):
    cell = small_cell(name)
    res = run.run_cell(cell, 2 ** 33 + 11, 0.3, trace, CPU, log=quiet)
    assert res["correct"] is True, res["check"]
    assert list(res)[-1] == "check" and res["failed"] == 0 and res["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in cell.metrics(kind)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert {"device_ops", "idle_gaps"} <= set(res["breakdown"])


@pytest.mark.gpu
def test_cell_on_the_card(card):
    res = run.run_cell(small_cell("gw-dr5-pool2048"), 2 ** 32 + 3, 1.0, True, card, log=quiet)
    assert res["correct"] is True, res["check"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0


# ---------------------------------------------------------------------------
# the control and the faults: correct comes out false
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_the_check(name):
    res = run.run_cell(small_cell(name), 2 ** 31 + 5, 0.2, False, CPU, control="tf32", log=quiet)
    assert res["correct"] is False, res["check"]


class Broken:
    """The program's entry with one fault planted in its timed path."""

    def __init__(self, cell, fault):
        self.inner = run.program_system(cell, CPU)
        self.fault, self.last = fault, None

    def device(self, item):
        h = self.inner.device(item)
        if self.fault == "stale":
            # a step that returns its state unchanged: the previous call's answer
            h, self.last = (self.last if self.last is not None else h), h
        elif self.fault == "token":
            h = self._alter(h)
        elif self.fault == "half":
            h = self._half(h)
        return h

    def _alter(self, h):
        if hasattr(h, "found"):                       # gateway BlockFrames
            lane = int(torch.nonzero(h.found.reshape(-1))[0])
            sym = h.symbols.clone().reshape(-1, h.symbols.shape[-1])
            sym[lane, 3] = (sym[lane, 3] + 1) % 128
            return h._replace(symbols=sym.reshape(h.symbols.shape))
        res = h[0]
        sym = res.symbols.clone()
        sym.view(-1)[7] = (sym.view(-1)[7] + 1) % 128
        return (res._replace(symbols=sym), *h[1:])

    def _half(self, h):
        if hasattr(h, "found"):
            found = h.found.clone()
            found[found.shape[0] // 2:] = False
            return h._replace(found=found)
        res = h[0]
        sym = res.symbols.clone()
        sym[sym.shape[0] // 2:] = 0
        return (res._replace(symbols=sym), *h[1:])

    def readout(self, h):
        return self.inner.readout(h)

    def outputs(self, h, host):
        return self.inner.outputs(h, host)


@pytest.mark.parametrize("fault", ["stale", "token", "half"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_fault_fails_the_check(name, fault):
    cell = small_cell(name)
    res = run.run_cell(cell, 2 ** 31 + 9, 0.3, False, CPU, system=Broken(cell, fault), log=quiet)
    assert res["correct"] is False, res["check"]


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_forbidden_modules_are_matched_by_whole_top_level_name(monkeypatch):
    assert run.forbidden_loaded() == []
    assert "lora_phy_tpu_torch" in sys.modules
    monkeypatch.setitem(sys.modules, "lora_phy_tpu.models", types.ModuleType("lora_phy_tpu.models"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.forbidden_loaded() == ["jaxlib", "lora_phy_tpu"]


def test_reference_importing_the_program_is_found(monkeypatch, tmp_path):
    assert run.independent_imports() == []
    copy = tmp_path / "phybench"
    shutil.copytree(run.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "reference" / "leak.py").write_text("from lora_phy_tpu_torch.ops import planar\n")
    (copy / "traffic" / "leak2.py").write_text("import lora_phy_tpu.models\n")
    monkeypatch.setattr(run, "HERE", copy)
    found = run.independent_imports()
    assert found == ["leak.py: lora_phy_tpu_torch.ops", "leak2.py: lora_phy_tpu.models"]
    monkeypatch.setattr(run, "HERE", run.ROOT / "phybench")
    held = types.ModuleType("phybench.reference.held")
    held.planar = planar
    monkeypatch.setitem(sys.modules, "phybench.reference.held", held)
    assert run.independent_imports() == ["phybench.reference.held holds lora_phy_tpu_torch.ops.planar"]


# ---------------------------------------------------------------------------
# frozen arithmetic
# ---------------------------------------------------------------------------

def test_kernel_count_gives_the_sf7_paths_bytes():
    rows = 553_648_128 // 128
    flops, nbytes = kernel_bound.fused_demod_count(rows, 128)
    assert nbytes == 4_498_392_064 and round(nbytes / 1e9, 3) == 4.498
    assert round(flops / 1e10, 3) == 2.713
    bound, by = kernel_bound.fused_demod_bound_s(rows, 128)
    assert by == "bytes" and abs(bound * 1e3 - 1.343) < 1e-3


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


def test_summary_attributes_unions_and_names_idle():
    from torch.autograd import DeviceType

    k = types.SimpleNamespace
    dev = [_Event("scan_k", DeviceType.CUDA, 10, 30), _Event("scan_k2", DeviceType.CUDA, 20, 40),
           _Event("memcpy", DeviceType.CUDA, 60, 70)]
    op = _Event("aten::mm", DeviceType.CPU, 5, 9, kernels=[k(name="scan_k", duration=20),
                                                            k(name="scan_k2", duration=20)])
    front = _Event("front", DeviceType.CPU, 0, 45, children=[op])
    read = _Event("readout", DeviceType.CPU, 45, 75,
                  kernels=[k(name="memcpy", duration=10)])
    s = profile_arith.summarize([front, op, read, *dev], ("front", "readout"),
                                ("front", "readout"), calls=1, window_s=1e-4, window_us=(0, 74))
    assert s.busy_s == pytest.approx(40e-6)
    assert s.ranges["front"] == (40e-6, 45e-6, 2)
    assert s.ranges["readout"][2] == 1 and s.other == (0.0, 0)
    assert s.idle_by_host == pytest.approx({"front": 10e-6, "readout": 24e-6})
    assert profile_arith.idle_share(s) == pytest.approx(0.6)


# ---------------------------------------------------------------------------
# found by name: added files, no edited file
# ---------------------------------------------------------------------------

def test_added_files_are_found_without_editing_any(monkeypatch, tmp_path):
    copy = tmp_path / "phybench"
    shutil.copytree(run.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    cfg = json.loads((copy / "configs" / "gw-eu868-dr5.json").read_text())
    cfg["min_power_db"] = -25.0
    (copy / "configs" / "gw-test-cfg.json").write_text(json.dumps(cfg))
    traffic = json.loads((copy / "traffic" / "gw-pool2048.json").read_text())
    traffic.update(channels=4, pool=2, frames_per_block=1)
    (copy / "traffic" / "gw-test-mix.json").write_text(json.dumps(traffic))
    limits = json.loads((copy / "workloads" / "gw-dr5-pool2048.json").read_text())["limits"]
    (copy / "workloads" / "gw-test-cell.json").write_text(json.dumps(
        {"config": "gw-test-cfg", "traffic": "gw-test-mix", "why": "a test", "trace_calls": 2,
         "check_calls": 2, "limits": limits}))
    (copy / "metrics" / "gw.test_events.py").write_text(
        'RANGES = ("test_range",)\n\n\ndef read(ctx):\n'
        '    return ctx.trace.calls + 0.5 + ctx.trace.ranges["test_range"][2]\n')
    (copy / "metrics" / "test_calls.py").write_text(
        "def read(ctx):\n    return float(ctx.window.calls)\n")
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "gw-test-cell", "config": "gw-test-cfg",
                               "traffic": "gw-test-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "gw.test_events", "unit": "calls", "better": "lower",
                               "source": "program_counter", "layer": "device",
                               "moves": "rx_msps", "workloads": ["gw-test-cell"]})
    bench["end_to_end"].append({"name": "test_calls", "unit": "calls", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["gw-test-cell"]})
    monkeypatch.setattr(run, "HERE", copy)
    cell = run.Cell.load("gw-test-cell", bench)
    assert cell.config["min_power_db"] == -25.0 and cell.traffic["channels"] == 4
    res = run.run_cell(cell, 77, 0.2, True, CPU, log=quiet)
    assert res["metrics"]["gw.test_events"]["value"] == 2.5
    assert res["correct"] is True, res["check"]
    res = run.run_cell(cell, 78, 0.2, False, CPU, log=quiet)
    assert res["metrics"]["test_calls"]["value"] == res["attempted"]
    assert res["correct"] is True, res["check"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_roofline_reader_counts_the_calls_rows():
    """The bulk cell's rows are its frames' sync and payload windows: 8 x
    8192 x 52 at 128 samples, 3.544e9 B, 1.058 ms at 3.35 TB/s."""
    cell = run.Cell.load("bulk-sf7-b65536")
    trace = profile_arith.TraceSummary(
        calls=2, window_s=1.0, busy_s=0.5, events=10, ranges={}, other=(0.0, 0),
        kernels={"void fused_demod_kernel<128, false>(...)": 2 * 2.049e-3, "other": 1.0},
        idle_by_host={})
    reader = run.load_file_module(run.HERE / "metrics" / "bulk.fused_demod_roofline.py",
                                  "bulk.fused_demod_roofline")
    value = reader.read(run.MetricContext(trace, cell.config, cell.traffic))
    assert value == pytest.approx(100 * 1.05796e-3 / 2.049e-3, rel=1e-4)
