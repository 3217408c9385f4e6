"""The circular block receiver's per-lane spectra: ``lora_phy_tpu_torch.ops.lanes``
under ``models.sync._receive_block_circular`` (its ``demod`` and ``sro``
stages).

On the CPU, at N <= 128 on any device, and with ``with_spectra`` the
wrapper runs its plain twin ``lane_spectra_reference``, which must equal
the stages' ops as they stood before the kernel (the rotation planes, the
derotated rows, their cat, the planar DFT's |.|², its argmax, the SNR's
maxima and sums, the clock-drift estimate's own DFT) bit for bit and
launch nothing; so must the receiver's SNR, clock drift and bins. The
kernel's FFT is emulated in numpy and must give the twin's bins outside
near-ties and its powers, sums and clock drift within rounding; the C
interface of ``csrc/lanes.cu`` is checked against the wrapper's ``ENTRY``.
On the card (``gpu``) the kernel is held to the twin on the same device
tensors at N = 256, 512 and 4096, the receiver's frames with it to those
with the twin on the SF12 gateway cell's traffic, one launch a call,
inside the ``demod`` range.
"""

import ctypes
import json
import math
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from _fft_emulation import kernel_power
from _torch_util import cuda_device
from lora_phy_tpu_torch import LoraParams, _build
from lora_phy_tpu_torch.models import sync
from lora_phy_tpu_torch.ops import lanes as tlanes
from lora_phy_tpu_torch.ops import planar
from lora_phy_tpu_torch.utils import profiling
from phybench.traffic import generator

BENCH = pathlib.Path(__file__).resolve().parents[1] / "phybench"
# the kernel's bins against the twin's: equal wherever the twin's two
# largest powers of a row differ by more than this share of the larger
NEAR_TIE = 1e-5
# the kernel's peaks and sums against the twin's, relative to each, and the
# clock drift's powers relative to the row's peak (float32 FFTs that round
# otherwise)
POWER_REL = 1e-5
# the SF12 gateway cell's limit on the clock drift (ppm at N = 4096), the
# kernel's estimate held to the twin's; at another N the same share of a
# bin a symbol (a bin is 1e6 / N ppm)
SRO_LIMIT = json.loads((BENCH / "workloads" / "gw-dr0-pool128.json").read_text())[
    "limits"]["sro_err"]


def sro_limit(n):
    return SRO_LIMIT * 4096 / n
PREAMBLE, SYNC_ROWS, PAY_ROWS = 8, 2, 32


def lane_rows(sf, lead, seed, dev=torch.device("cpu"), pay_rows=PAY_ROWS, noise_lanes=2):
    """``(sync_r, sync_i, pay_r, pay_i, rate, q, q_p)`` of lanes as the
    receiver hands them to its demod stage: [*lead] lanes of dechirped
    tones at random bins, a fractional CFO and a small clock drift under
    noise (the last ``noise_lanes`` lanes noise alone, as lanes where no
    frame was found), the sync rows the last two of the preamble's rows
    (a strided slice), random nonzero section offsets."""
    n = 1 << sf
    frames = math.prod(lead)
    gen = torch.Generator().manual_seed(seed)
    rows = PREAMBLE + SYNC_ROWS + pay_rows
    cfo = torch.rand(frames, 1, 1, generator=gen, dtype=torch.float64) - 0.5
    drift = (torch.rand(frames, 1, 1, generator=gen, dtype=torch.float64) - 0.5) * 4e-3
    s = torch.arange(rows, dtype=torch.float64)[None, :, None]
    k = torch.randint(0, n, (frames, rows, 1), generator=gen).to(torch.float64)
    phase = 2 * np.pi * torch.rand(frames, rows, 1, generator=gen, dtype=torch.float64)
    ph = 2 * np.pi * (k + cfo + drift * s) * torch.arange(n, dtype=torch.float64) / n + phase
    amp = torch.ones(frames, 1, 1, dtype=torch.float64)
    amp[frames - noise_lanes:] = 0.0
    noise = torch.randn(2, frames, rows, n, generator=gen, dtype=torch.float64)
    xr = (amp * torch.cos(ph) + 0.8 * noise[0]).to(torch.float32).reshape(*lead, rows, n)
    xi = (amp * torch.sin(ph) + 0.8 * noise[1]).to(torch.float32).reshape(*lead, rows, n)
    pre = PREAMBLE + SYNC_ROWS
    ps_r, ps_i = xr[..., :pre, :].contiguous().to(dev), xi[..., :pre, :].contiguous().to(dev)
    pd_r, pd_i = xr[..., pre:, :].contiguous().to(dev), xi[..., pre:, :].contiguous().to(dev)
    resid = (cfo[:, 0, 0] + 0.01 * torch.randn(frames, generator=gen, dtype=torch.float64))
    rate = (-float(np.float32(2.0 * math.pi)) * resid.to(torch.float32) / float(n))
    q = torch.randint(1, n, (frames,), generator=gen, dtype=torch.int32)
    q_p = torch.randint(1, n, (frames,), generator=gen, dtype=torch.int32)
    return (ps_r[..., PREAMBLE:, :], ps_i[..., PREAMBLE:, :], pd_r, pd_i,
            rate.reshape(lead).to(dev), q.reshape(lead).to(dev), q_p.reshape(lead).to(dev))


def pre_change(sync_r, sync_i, pay_r, pay_i, rate, q, q_p, p):
    """The demod and sro stages' ops as ``_receive_block_circular`` ran them
    before the kernel (with ``estimate_sro_planar`` and ``_snr_db`` as they
    stood), written out here: ``(raw bins, snr_db, sro_ppm, payload
    |.|²)``."""
    n = p.n
    jj = torch.arange(n, dtype=torch.int32, device=sync_r.device)

    def rot_factor(qs):
        qs = qs[..., None]
        idx_true = (jj - qs + torch.where(jj < qs, n, 0)).to(torch.float32)
        ph = rate[..., None] * idx_true
        return torch.cos(ph), torch.sin(ph)

    def rot(a_r, a_i, c_, s_):
        c_, s_ = c_[..., None, :], s_[..., None, :]
        return a_r * c_ - a_i * s_, a_r * s_ + a_i * c_

    ca, sa = rot_factor(q)
    cb, sb_ = rot_factor(q_p)
    sy_r, sy_i = rot(sync_r, sync_i, ca, sa)
    pl_r, pl_i = rot(pay_r, pay_i, cb, sb_)
    fr = torch.cat([sy_r, pl_r], dim=-2)
    fi = torch.cat([sy_i, pl_i], dim=-2)
    mag2 = planar.dft_mag2_planar(fr, fi, n)
    raw = torch.argmax(mag2, dim=-1).to(torch.int32)
    mag2_pay = mag2[..., 2:, :]
    # estimate_sro_planar (osr 1)
    sr, si = planar.dft_planar(pay_r, pay_i, n)
    m2 = sr * sr + si * si
    index = torch.argmax(m2, dim=-1)
    peak = torch.sqrt(m2.amax(dim=-1))
    left_ix = torch.where(index > 0, index - 1, n - 1)[..., None]
    right_ix = torch.where(index < n - 1, index + 1, 0)[..., None]
    left = torch.sqrt(torch.gather(m2, -1, left_ix)[..., 0])
    right = torch.sqrt(torch.gather(m2, -1, right_ix)[..., 0])
    den_r, den_l = peak + right, peak + left
    one = torch.ones_like(den_r)
    frac = torch.where(
        right >= left,
        torch.where(den_r > 0.0, right / torch.where(den_r > 0.0, den_r, one),
                    torch.zeros_like(den_r)),
        -left / torch.where(den_l > 0.0, den_l, one))
    dd = frac[..., 1:] - frac[..., :-1]
    dd = torch.remainder(dd + 0.5, 1.0) - 0.5
    sro = 1e6 * torch.mean(dd, dim=-1) / float(np.float32(n * p.scale))
    # _snr_db
    pk = mag2_pay.amax(dim=-1)
    noise = (torch.sum(mag2_pay, dim=-1) - pk) / float(n - 1)
    snr = 10.0 * torch.log10(torch.mean(pk, dim=-1)
                             / torch.clamp(torch.mean(noise, dim=-1), min=1e-30))
    return raw, snr, sro, mag2_pay


def stage_outputs(spec, p):
    """The receiver's SNR and clock drift from a LaneSpectra with its
    clock-drift side."""
    return (sync._snr_from_powers(spec.peak, spec.total, p.n),
            planar.sro_from_powers(*spec.sro[1:], p))


@pytest.mark.parametrize("lead", [(5,), (2, 3)], ids=["K", "BK"])
@pytest.mark.parametrize("sf", [7, 8, 12])
def test_twin_equals_the_pre_change_ops(sf, lead):
    p = LoraParams(sf=sf)
    args = lane_rows(sf, lead, seed=100 + sf, pay_rows=6 if sf == 12 else PAY_ROWS)
    spec = tlanes.lane_spectra_reference(*args, p, with_spectra=True)
    raw, snr, sro, mag2_pay = pre_change(*args, p)
    assert spec.raw.dtype == torch.int32 and spec.raw.shape == raw.shape
    assert torch.equal(spec.raw, raw)
    got_snr, got_sro = stage_outputs(spec, p)
    assert torch.equal(got_snr, snr) and torch.equal(got_sro, sro)
    assert torch.equal(spec.spectra, mag2_pay)


def test_wrapper_runs_the_twin_on_the_cpu():
    """On a CPU tensor the wrapper is the twin without the clock-drift
    side (the sro stage takes its own DFT), with the spectra when asked,
    and launches nothing."""
    p = LoraParams(sf=9)
    args = lane_rows(9, (4,), seed=3)
    launches = tlanes.LAUNCHES
    got = tlanes.lane_spectra(*args, p)
    want = tlanes.lane_spectra_reference(*args, p, with_sro=False)
    assert got.sro is None and got.spectra is None
    for f in ("raw", "peak", "total"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    spec = tlanes.lane_spectra(*args, p, with_spectra=True)
    assert torch.equal(spec.spectra, pre_change(*args, p)[3])
    assert tlanes.LAUNCHES == launches


def dr0_block(channels, block_samples, seed, dev):
    """One pool item of the SF12 gateway cell's traffic (``gw-pool128-dr0``
    on ``gw-eu868-dr0``), at ``channels`` channels of ``block_samples``."""
    cfg = dict(json.loads((BENCH / "configs" / "gw-eu868-dr0.json").read_text()),
               block_samples=block_samples)
    traffic = dict(json.loads((BENCH / "traffic" / "gw-pool128-dr0.json").read_text()),
                   channels=channels, pool=1)
    return cfg, generator.make_pool(cfg, traffic, seed, dev)[0]


def receive(cfg, item, **kw):
    return sync.receive_block_planar(
        item.xr, item.xi, LoraParams(sf=cfg["sf"], sync_word=cfg["sync_word"]),
        2 * cfg["payload_bytes"], max_frames=cfg["max_frames"],
        preamble_len=cfg["preamble_len"], min_power_db=cfg["min_power_db"], **kw)


def test_receiver_on_the_cpu_keeps_the_pre_change_stages():
    """The receiver on the SF12 cell's frames (CPU): the stage's bins, its
    SNR and clock drift equal the pre-change ops' on the same rows, bit
    for bit; with_spectra returns the same spectra plane."""
    cfg, item = dr0_block(2, 1 << 18, 2 ** 33 + 5, torch.device("cpu"))
    p = LoraParams(sf=cfg["sf"], sync_word=cfg["sync_word"])
    seen = []

    def spy(*args, **kw):
        out = tlanes.lane_spectra(*args, **kw)
        seen.append((args, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sync, "lane_spectra", spy)
        blk = receive(cfg, item)
        blk_s, spectra = receive(cfg, item, with_spectra=True)
    assert int(blk.found.sum()) == 2
    (args, out), (_, out_s) = seen
    raw, snr, sro, mag2_pay = pre_change(*args[:7], p)
    assert torch.equal(out.raw, raw)
    assert torch.equal(blk.snr_db, snr) and torch.equal(blk.sro_ppm, sro)
    assert torch.equal(out_s.spectra, mag2_pay)
    for f in blk._fields:
        assert torch.equal(getattr(blk, f), getattr(blk_s, f)), f
    assert spectra.shape == (*blk.symbols.shape, p.n)


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def meta_args(n, frames=2, rows=(2, 4)):
    return (meta(frames, rows[0], n), meta(frames, rows[0], n), meta(frames, rows[1], n),
            meta(frames, rows[1], n), meta(frames), meta(frames, dtype=torch.int32),
            meta(frames, dtype=torch.int32))


def test_wrapper_routes_by_device_n_and_spectra():
    """At N <= 128, and with the spectra at any N, the wrapper is the twin
    on any device (a meta tensor here: the twin's ops run, no launch is
    tried); at N = 256 without them the same call goes to the launch,
    which refuses a device that is not CUDA."""
    launches = tlanes.LAUNCHES
    got = tlanes.lane_spectra(*meta_args(128), LoraParams(sf=7))
    assert got.raw.shape == (2, 6) and got.peak.shape == (2, 4) and got.sro is None
    got = tlanes.lane_spectra(*meta_args(256), LoraParams(sf=8), with_spectra=True)
    assert got.spectra.shape == (2, 4, 256)
    with pytest.raises(ValueError, match="^no lanes kernel for device meta$"):
        tlanes.lane_spectra(*meta_args(256), LoraParams(sf=8))
    assert tlanes.LAUNCHES == launches


def bad(index, value):
    args = list(meta_args(256))
    args[index] = value
    return tuple(args)


SF8 = LoraParams(sf=8)
# (what is wrong, the call's arguments, the error, its message)
BAD_CALLS = {
    "sync_dtype": (bad(0, meta(2, 2, 256, dtype=torch.float64)), TypeError,
                   "sync_r must be float32"),
    "pay_dtype": (bad(3, meta(2, 4, 256, dtype=torch.float16)), TypeError,
                  "pay_i must be float32"),
    "rate_dtype": (bad(4, meta(2, dtype=torch.float64)), TypeError, "rate must be float32"),
    "q_dtype": (bad(5, meta(2, dtype=torch.int64)), TypeError, "q must be int32"),
    "device": (bad(2, torch.empty(2, 4, 256)), ValueError, "pay_r is on cpu"),
    "shapes": (bad(1, meta(2, 3, 256)), ValueError, r"\[\.\.\., K, R, 256\]"),
    "lanes": (bad(2, meta(3, 4, 256)), ValueError, "planes of the same lanes"),
    "n": (bad(2, meta(2, 4, 512)), ValueError, r"\[\.\.\., K, S, 256\]"),
    "rate_shape": (bad(4, meta(3)), ValueError, r"rate has shape \(3,\)"),
    "q_p_shape": (bad(6, meta(2, 1, dtype=torch.int32)), ValueError,
                  r"q_p has shape \(2, 1\)"),
    "n_range": ((*meta_args(8192, rows=(2, 2)),), ValueError, "no lanes kernel for n=8192"),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, error, message = BAD_CALLS[case]
    params = types.SimpleNamespace(n=8192) if case == "n_range" else SF8
    launches = tlanes.LAUNCHES
    with pytest.raises(error, match=message):
        tlanes.lane_spectra(*args, params)
    assert tlanes.LAUNCHES == launches


def c_parameters(source: str, name: str):
    """The parameter types of ``extern "C" int name(...)`` in ``source``."""
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    assert m, f"{name} is not declared extern \"C\""
    return [re.sub(r"\s*\w+$", "", a.strip()) for a in m.group(1).split(",")]


def test_kernel_source_is_built_and_declared():
    src = next(s for s in _build.SOURCES if s.name == "lanes.cu")
    assert src.is_file()
    text = src.read_text()
    for header in re.findall(r'#include "([^"]+)"', text):
        assert header in {h.name for h in _build.HEADERS}, header
    fake = types.SimpleNamespace(lora_lanes=lambda *a: 0)
    _build.declare(fake, tlanes.ENTRY)
    argtypes = fake.lora_lanes.argtypes
    params = c_parameters(text, "lora_lanes")
    assert len(argtypes) == len(params) == 30
    want = {ctypes.c_longlong: "long long", ctypes.c_int: "int"}
    for ctype, decl in zip(argtypes, params):
        if "*" in decl:
            assert ctype is ctypes.c_void_p, decl
        else:
            assert decl == want[ctype], decl
    assert fake.lora_lanes.restype is ctypes.c_int


# ---------------------------------------------------------------------------
# The kernel's FFT, emulated in numpy float32 stage for stage (_fft_emulation)
# ---------------------------------------------------------------------------

def near_ties(mag):
    """Rows whose two largest powers lie within NEAR_TIE of each other."""
    top2 = mag.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) <= NEAR_TIE * top2[..., 0]


def emulated(args, p):
    """What the kernel computes, by its FFT emulated in numpy: a
    LaneSpectra with the clock-drift side (the sum in numpy's order)."""
    n = p.n
    fr, fi = tlanes.derotated_rows(*args, n)
    lead = fr.shape[:-2]
    mag = torch.from_numpy(kernel_power(fr.reshape(-1, n).numpy(), fi.reshape(-1, n).numpy()))
    mag = mag.reshape(*lead, -1, n)
    pay = mag[..., SYNC_ROWS:, :]
    raw_m = torch.from_numpy(kernel_power(args[2].reshape(-1, n).numpy(),
                                          args[3].reshape(-1, n).numpy()))
    raw_m = raw_m.reshape(*lead, -1, n)
    index = torch.argmax(raw_m, dim=-1)
    pick = lambda ix: torch.gather(raw_m, -1, (ix % n)[..., None])[..., 0]   # noqa: E731
    sro = (index, pick(index - 1), raw_m.amax(dim=-1), pick(index + 1))
    return tlanes.LaneSpectra(torch.argmax(mag, dim=-1).to(torch.int32), pay.amax(dim=-1),
                              pay.sum(dim=-1), sro, None)


def compare(got, want, args, p):
    """The kernel's (or its emulation's) LaneSpectra against the twin's
    with its clock-drift side: (rows, near-ties, bins that differ outside
    them, the widest relative gap of the peaks, of the sums and of the
    clock drift's powers (to the row's peak, where both take the same
    bin), the clock drift's gap in ppm)."""
    n = p.n
    fr, fi = tlanes.derotated_rows(*[a.cpu() for a in args], n)
    near = near_ties(planar.dft_mag2_planar(fr, fi, n))
    sr, si = planar.dft_planar(args[2].cpu(), args[3].cpu(), n)
    near_raw = near_ties(sr * sr + si * si)
    bad = int(((got.raw.cpu() != want.raw.cpu()) & ~near).sum())
    bad += int(((got.sro[0].cpu() != want.sro[0].cpu()) & ~near_raw).sum())
    keep = (got.sro[0].cpu() == want.sro[0].cpu())
    gap = 0.0
    for a, b, ref, m in ((got.peak, want.peak, want.peak.cpu(), None),
                         (got.total, want.total, want.total.cpu(), None),
                         *((got.sro[i], want.sro[i], want.sro[2].cpu(), keep)
                           for i in (1, 2, 3))):
        rel = (a.cpu() - b.cpu()).abs() / ref
        gap = max(gap, float((rel if m is None else rel[m]).max()))
    sro_gap = float((stage_outputs(got, p)[1].cpu() - stage_outputs(want, p)[1].cpu())
                    .abs().max())
    return near.numel() + near_raw.numel(), int(near.sum() + near_raw.sum()), bad, gap, sro_gap


@pytest.mark.parametrize("sf", [8, 9, 12])
def test_kernel_fft_emulation_matches_twin(sf):
    """On the twin's derotated rows and the raw payload rows, the kernel's
    FFT (emulated) gives the twin's bins except where the twin's two
    largest powers lie within NEAR_TIE of each other, its peaks, sums and
    the clock drift's powers within POWER_REL of the row's peak, and a
    clock drift within the SF12 cell's limit of the twin's."""
    p = LoraParams(sf=sf)
    args = lane_rows(sf, (6,), seed=700 + sf, pay_rows=8 if sf == 12 else PAY_ROWS)
    want = tlanes.lane_spectra_reference(*args, p)
    rows, near, bad, gap, sro_gap = compare(emulated(args, p), want, args, p)
    assert near <= 0.01 * rows and bad == 0, (rows, near, bad)
    assert gap <= POWER_REL and sro_gap <= sro_limit(p.n), (gap, sro_gap)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("sf", [8, 9, 12])
def test_cuda_kernel_against_twin(sf):
    """DR0-like lanes ([3, 37] lanes, a count no tile divides; nonzero
    section offsets, fractional CFO, noise lanes; the sync rows a strided
    slice): bins and the clock drift's bins equal to the twin's outside
    near-ties, peaks, sums and the clock drift's powers within POWER_REL
    of the row's peak, the clock drift within the SF12 cell's limit
    (scaled to N), one launch a call, the rows left as they were."""
    dev = cuda_device()
    p = LoraParams(sf=sf)
    args = lane_rows(sf, (3, 37), seed=900 + sf, dev=dev)
    before = [a.clone() for a in args[:4]]
    launches = tlanes.LAUNCHES
    got = tlanes.lane_spectra(*args, p)
    assert tlanes.LAUNCHES == launches + 1
    want = tlanes.lane_spectra_reference(*args, p)
    assert got.raw.shape == want.raw.shape and got.raw.dtype == torch.int32
    assert got.sro[0].dtype == torch.int32 and got.spectra is None
    rows, near, bad, gap, sro_gap = compare(got, want, args, p)
    assert bad == 0 and near <= 0.01 * rows, (rows, near, bad)
    assert gap <= POWER_REL and sro_gap <= sro_limit(p.n), (gap, sro_gap)
    for a, b in zip(args[:4], before):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_launches_by_route():
    """On the card: one launch a call at N = 256..4096, none at N = 128 or
    with the spectra, whose result is the twin's."""
    dev = cuda_device()
    for sf, spectra, want in ((7, False, 0), (8, True, 0), (8, False, 1), (12, False, 1)):
        p = LoraParams(sf=sf)
        args = lane_rows(sf, (4,), seed=40 + sf, dev=dev, pay_rows=6)
        launches = tlanes.LAUNCHES
        got = tlanes.lane_spectra(*args, p, with_spectra=spectra)
        assert tlanes.LAUNCHES == launches + want, (sf, spectra)
        assert (got.sro is None) == (want == 0)
        if want == 0:
            ref = tlanes.lane_spectra_reference(*args, p, with_sro=False,
                                                with_spectra=spectra)
            assert torch.equal(got.raw, ref.raw) and torch.equal(got.peak, ref.peak)


@pytest.mark.gpu
def test_cuda_receiver_on_the_sf12_cell_traffic():
    """The block receiver on the SF12 gateway cell's frames (8 channels of
    2^20 samples): one lanes launch a call (none with the spectra); every
    lane's decisions equal those it takes with the twin, its residual CFO
    the same floats, its clock drift within the cell's limit."""
    dev = cuda_device()
    cfg, item = dr0_block(8, 1 << 20, 2 ** 33 + 29, dev)
    launches = tlanes.LAUNCHES
    b_kernel = receive(cfg, item)
    assert tlanes.LAUNCHES == launches + 1
    receive(cfg, item, with_spectra=True)
    assert tlanes.LAUNCHES == launches + 1
    twin = lambda *a, **kw: tlanes.lane_spectra_reference(*a, with_sro=False, **kw)  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sync, "lane_spectra", twin)
        b_twin = receive(cfg, item)
    assert tlanes.LAUNCHES == launches + 1
    assert int(b_kernel.found.sum()) >= 7
    for f in ("found", "start", "cfo_bins", "symbols", "sync", "cfo", "time_offset"):
        assert torch.equal(getattr(b_kernel, f), getattr(b_twin, f)), f
    found = b_kernel.found
    gap = (b_kernel.sro_ppm - b_twin.sro_ppm)[found].abs().max()
    assert float(gap) <= SRO_LIMIT, float(gap)
    snr_gap = (b_kernel.snr_db - b_twin.snr_db)[found].abs().max()
    assert float(snr_gap) <= 1e-4, float(snr_gap)


@pytest.mark.gpu
def test_cuda_kernel_runs_in_the_demod_range():
    """Traced (``utils/profiling.range_profile``, the attribution the
    harness froze), the SF12 receiver: the lanes kernel's device time is
    linked under ``demod``, once a call, and no device time falls outside
    the receiver's ranges."""
    dev = cuda_device()
    cfg, item = dr0_block(4, 1 << 20, 2 ** 31 + 7, dev)
    prof = profiling.range_profile(lambda: receive(cfg, item), sync.CIRCULAR_STAGES, calls=2)
    kernel = {name: ms for name, ms in prof.kernels.items()
              if re.search(r"\blanes_block_kernel<", name)}
    assert len(kernel) == 1 and sum(kernel.values()) > 0, prof.kernels
    demod_ms, _, demod_events = prof.stages["demod"]
    assert demod_ms >= sum(kernel.values()) and demod_events >= 1, prof
    assert prof.other[2] == 0, prof
