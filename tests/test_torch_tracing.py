"""The port's stage ranges and host-sync counter on the two hot paths the
benchmark drives: the bulk coded decoder (``dechirp_planar`` ->
``demodulate_planar(fused=True)`` -> ``decode_payload``) and the block
receiver's circular path (``receive_block_planar``), with the host decode
(``modem.decode``) after it.

On the CPU: each range opens on its path while a profiler runs and none
opens without one; the stage ranges do not nest in one another;
``HOST_SYNCS`` goes up by the syncs each call passes, with the timing
offsets zero or not. On the card (``gpu``): that count equals the syncs
``torch.cuda.set_sync_debug_mode("warn")`` reports for the same calls.
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch

from lora_phy_tpu_torch import LoraParams
from lora_phy_tpu_torch.models import coded, modem, stream
from lora_phy_tpu_torch.models import sync as tsync
from lora_phy_tpu_torch.ops import planar, windows
from lora_phy_tpu_torch.utils import profiling

CPU = torch.device("cpu")
P7 = LoraParams(sf=7)
CFG = coded.CodedConfig(sf=7, cr=1, crc=True, whiten=True)
NBYTES = 8
# the program's stage ranges on the bulk path, in call order; none nests
# in another
BULK_STAGES = ("planar.dechirp", "planar.scale", "planar.estimate", "planar.windows",
               "planar.decide", "coded.decode")
NEW_RANGES = (*BULK_STAGES, "modem.decode", "host_sync")
# host syncs a call makes on a CUDA device (found there by the sync debug mode)
BULK_SYNCS, CIRCULAR_SYNCS = 2, 1


def rotate(xr, xi, cfo_bins: float, n: int):
    """The planes times exp(j 2 pi cfo k / N): a carrier offset in bins."""
    ph = (2 * np.pi * cfo_bins / n) * torch.arange(xr.shape[-1], dtype=torch.float64)
    c, s = torch.cos(ph).to(torch.float32), torch.sin(ph).to(torch.float32)
    return xr * c - xi * s, xr * s + xi * c


def bulk_input(cfo_bins: float, dev=CPU, frames: int = 4):
    """Frame-aligned coded captures [frames, (S+2) N] at one carrier offset."""
    pay = np.random.RandomState(7).randint(0, 256, (frames, NBYTES)).astype(np.uint8)
    syms = coded.encode_payload(torch.from_numpy(pay), CFG, device=CPU)
    xr, xi = rotate(*planar.modulate_planar(syms, P7), cfo_bins, P7.n)
    return xr.to(dev), xi.to(dev)


def bulk_call(xr, xi):
    dr, di = planar.dechirp_planar(xr, xi, P7)
    res = planar.demodulate_planar(dr, di, P7, fused=True)
    return res, coded.decode_payload(res.symbols, NBYTES, CFG)


def gateway_input(cfo_bins: float, dev=CPU, channels: int = 2):
    """Two framed payloads a channel, each followed by zero windows."""
    pay = np.random.RandomState(8).randint(0, 256, (channels, 16)).astype(np.uint8)
    fr, fi = stream.frame_modulate_planar(modem.encode(torch.from_numpy(pay)), P7)
    z = torch.zeros(channels, 4 * P7.step)
    xr, xi = torch.cat([z, fr, z], -1).repeat(1, 2), torch.cat([z, fi, z], -1).repeat(1, 2)
    xr, xi = rotate(xr, xi, cfo_bins, P7.n)
    return xr.to(dev), xi.to(dev)


def gateway_call(xr, xi):
    blk = tsync.receive_block_planar(xr, xi, P7, 32, max_frames=2, min_power_db=-30.0)
    return blk, modem.decode(blk.symbols.cpu())


def traced_ranges(fn) -> list:
    """(name, start, end) of every new range ``fn()`` opens under a CPU
    profiler, in start order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name in NEW_RANGES), key=lambda r: r[1])


def test_bulk_ranges_open_in_order_without_nesting():
    xr, xi = bulk_input(0.3)
    spans = traced_ranges(lambda: bulk_call(xr, xi))
    stages = [s for s in spans if s[0] in BULK_STAGES]
    assert [s[0] for s in stages] == list(BULK_STAGES)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:])), stages
    syncs = [s for s in spans if s[0] == "host_sync"]
    assert len(syncs) == BULK_SYNCS
    inside = [next(st[0] for st in stages if st[1] <= s[1] and s[2] <= st[2]) for s in syncs]
    assert inside == ["planar.estimate", "planar.windows"]


def test_gateway_and_host_decode_open_their_ranges():
    xr, xi = gateway_input(0.0)
    spans = traced_ranges(lambda: gateway_call(xr, xi))
    assert [s[0] for s in spans] == ["host_sync", "modem.decode"]


def test_no_range_opens_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"range {name!r} opened with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    for name in NEW_RANGES:
        assert isinstance(profiling.stage_range(name), contextlib.nullcontext)
    assert isinstance(profiling.host_sync(), contextlib.nullcontext)
    bulk_call(*bulk_input(0.3))
    gateway_call(*gateway_input(0.3))


def test_launch_range_is_an_operator_range_only_while_profiling():
    """Untraced a no-op; traced an operator-level event (not a user
    annotation) inside the stage range that opened it, holding the ops
    run inside it: what the profiler links a hand kernel's launch to."""
    from torch.profiler import ProfilerActivity, profile

    assert isinstance(profiling.launch_range("fused_demod.launch"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.stage_range("planar.decide"):
            with profiling.launch_range("fused_demod.launch"):
                torch.ones(4).add_(1)
    events = {e.name: e for e in prof.events()}
    launch = events["fused_demod.launch"]
    assert not getattr(launch, "is_user_annotation", False)
    assert [c.name for c in events["planar.decide"].cpu_children] == ["fused_demod.launch"]
    assert {"aten::ones", "aten::add_"} <= {c.name for c in launch.cpu_children}


def test_new_range_names_are_their_own():
    taken = (*tsync.CIRCULAR_STAGES, "device", "readout")
    assert len(set(NEW_RANGES)) == len(NEW_RANGES)
    assert not set(NEW_RANGES) & set(taken)


@pytest.mark.parametrize("cfo_bins", [0.0, 0.3], ids=["t_off-zero", "t_off-nonzero"])
def test_host_syncs_counted_per_call(cfo_bins):
    xr, xi = bulk_input(cfo_bins)
    before = profiling.HOST_SYNCS
    res, (payload, crc_ok, _) = bulk_call(xr, xi)
    assert profiling.HOST_SYNCS - before == BULK_SYNCS
    t_off = planar._round_half_away(res.time_offset)
    assert bool((t_off == 0).all()) == (cfo_bins == 0.0)
    assert bool(crc_ok.all())

    gr, gi = gateway_input(cfo_bins)
    before = profiling.HOST_SYNCS
    blk, _ = gateway_call(gr, gi)
    assert profiling.HOST_SYNCS - before == CIRCULAR_SYNCS
    assert int(blk.found.sum()) == 4


def test_chip_smoke_markers_off_silences_and_restores():
    """chip_smoke.py phase 20 (b)'s no-op markers: under markers_off the
    bulk call opens no range and counts no sync; after it, the markers
    are back."""
    import chip_smoke

    xr, xi = bulk_input(0.3)
    before = profiling.HOST_SYNCS
    with chip_smoke.markers_off():
        assert traced_ranges(lambda: bulk_call(xr, xi)) == []
    assert profiling.HOST_SYNCS == before
    assert planar.stage_range is coded.stage_range is modem.stage_range is profiling.stage_range
    assert planar.host_sync is windows.host_sync is profiling.host_sync
    bulk_call(xr, xi)
    assert profiling.HOST_SYNCS - before == BULK_SYNCS


@pytest.mark.gpu
def test_host_syncs_match_the_sync_debug_mode():
    """Every synchronizing CUDA call the debug mode sees in one bulk call
    and one gateway call is one that HOST_SYNCS counts; traced, the bulk
    call's hand kernel is linked under its planar.decide range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cases = {"bulk": (bulk_call, bulk_input(0.3, dev, frames=64), BULK_SYNCS),
             "gateway": (lambda xr, xi: tsync.receive_block_planar(
                 xr, xi, P7, 32, max_frames=2, min_power_db=-30.0),
                 gateway_input(0.3, dev, channels=16), CIRCULAR_SYNCS)}
    for label, (fn, args, want) in cases.items():
        fn(*args)                       # tables uploaded and kernels built once
        torch.cuda.synchronize()
        before = profiling.HOST_SYNCS
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in seen if "called a synchronizing CUDA operation" in str(w.message)]
        counted = profiling.HOST_SYNCS - before
        assert len(syncs) == counted == want, (label, len(syncs), counted)

    from torch.profiler import ProfilerActivity, profile

    def kernels(e):
        return [k.name for k in e.kernels] + [n for c in e.cpu_children for n in kernels(c)]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bulk_call(*cases["bulk"][1])
        torch.cuda.synchronize()
    decide = [n for e in prof.events() if e.name == "planar.decide" for n in kernels(e)]
    assert any("fused_demod" in n for n in decide), decide
