"""The cell ``bulk-sf9-b13312`` (the upstream's ``sf9_bw250_cr48`` on the
bulk coded decoder's exact float32 route, CR 4/8) on the CPU at a small
size: a run end to end and traced, the readers on a synthetic trace with
known answers, the frozen count of the per-symbol stage's work at the
cell's size, the program's decode against the reference's on corrected
codewords, and the TF32 control failing the check.

Run: ``python -m pytest phybench/tests -q -p no:cacheprovider``.
"""

import numpy as np
import pytest
import torch

from phybench import run
from phybench.metrics import kernel_bound, profile_arith
from phybench.reference import bulk_wide as rwide
from phybench.tests.test_phybench_bulk_sf12 import HOST_READERS, READERS, bulk_call, reader
from phybench.traffic import generator

CPU = torch.device("cpu")
CELL = "bulk-sf9-b13312"


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
    res = run.run_cell(cell, 2 ** 33 + 13, 0.3, trace, CPU, log=quiet)
    assert res["correct"] is True, res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["check"]) == {"frame_mismatch", "cfo_err", "to_err", "cfo_err_f32",
                                 "to_err_f32", "decode_mismatch"}
    if not trace:
        assert set(res["metrics"]) == {"packets_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        # the SF12 cell's per-layer metrics, and no other
        assert {m["name"] for m in cell.metrics("per_layer")} == set(READERS)
        assert set(res["metrics"]) == HOST_READERS
        assert all(v["value"] > 0 for v in res["metrics"].values())


def test_decide_count_is_pinned_at_the_cells_size():
    """13,312 frames of 2 sync + 64 coded windows of 512 samples: 878,592
    rows; the bound is the bytes, 1.078 ms at 3.35 TB/s."""
    cell = run.Cell.load(CELL)
    frames = generator.call_size(cell.config, cell.traffic)[1]
    rows = frames * (2 + generator.payload_symbol_count(cell.config))
    assert (frames, rows) == (13_312, 878_592)
    assert generator.call_size(cell.config, cell.traffic)[0] == 13_312 * 33_792
    flops, nbytes = kernel_bound.fused_demod_count(rows, 512)
    assert flops == rows * (5 * 512 * 9 + 14 * 512) == 26_540_507_136
    assert nbytes == 4 * (2 * rows * 512 + 4 * rows + 2 * 512) == 3_612_774_400
    bound, by = kernel_bound.fused_demod_bound_s(rows, 512)
    assert by == "bytes" and bound * 1e3 == pytest.approx(1.07844, abs=1e-5)


def test_roofline_reads_the_cells_rows():
    """``bulk.decide_roofline`` on the SF12 file's synthetic call (40 us in
    ``planar.decide``) with this cell's configuration: the bound of
    878,592 rows of 512 over 40 us."""
    cell = run.Cell.load(CELL)
    ranges = tuple(dict.fromkeys(r for n in READERS for r in getattr(reader(n), "RANGES", ())))
    names = (*ranges, "readout")
    events = sorted(bulk_call(), key=lambda e: (e.time_range.start, -e.time_range.end))
    summary = profile_arith.summarize(events, names, (*names, "device"), calls=1, window_s=1e-3)
    got = reader("bulk.decide_roofline").read(run.MetricContext(summary, cell.config, cell.traffic))
    bound_ms = kernel_bound.fused_demod_bound_s(878_592, 512)[0] * 1e3
    assert got == pytest.approx(100.0 * bound_ms / 40e-3)


def test_program_decode_is_the_references_where_it_corrects():
    """On 2 x 16 frames of the cell's traffic the program's CR 4/8 decode
    flags codewords in some frames, and its bytes, ``crc_ok`` and
    ``fec_errors`` are the reference decoder's of the same symbols
    (``decode_mismatch`` 0); frames that carry flagged codewords come back
    with the bytes sent."""
    cell = small_cell((2, 16))
    item = generator.make_pool(cell.config, dict(cell.traffic, pool=1), 2 ** 33 + 5, CPU)[0]
    system = run.program_system(cell, CPU)
    handle = system.device(item)
    out = system.outputs(handle, system.readout(handle))
    nums = rwide.judge(item, out, rwide.reference_outputs(item, cell.config), cell.config)
    assert nums["decode_mismatch"] == 0
    sent = item.payloads.reshape(-1, item.payloads.shape[-1])
    right = np.all(out["bytes"].reshape(sent.shape) == sent, axis=-1)
    fec = out["fec_errors"].reshape(-1)
    assert np.any((fec > 0) & right), (fec, right)


def test_control_fails_the_check():
    """The TF32 control on 4 x 64 frames, one call compared: its decisions
    and bytes are those of the reference, while its CFO and timing
    estimates leave the reference's, float64 and float32 alike, by more
    than the cell's limits let through."""
    cell = small_cell((4, 64))
    cell.workload.update(check_calls=1)
    res = run.run_cell(cell, 2 ** 31 + 5, 0.1, False, CPU, control="tf32", log=quiet)
    assert res["correct"] is False, res["check"]
    over = {k for k, c in res["check"].items() if c["value"] > c["limit"]}
    assert over == {"cfo_err", "to_err", "cfo_err_f32", "to_err_f32"}, res["check"]
