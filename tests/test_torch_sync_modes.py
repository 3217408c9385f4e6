"""Port parity: the receive modes of lora_phy_tpu_torch.models.sync beyond
the plain block receiver — the multipath-robust ``pre_acc`` 2..3 mode
(scan and receiver), the ``tx_phase_step`` override, channel-activity
detection, blind SF and the wideband (channelizer + block receiver)
receiver — against lora_phy_tpu.models.sync on the same numpy-seeded
streams (the cases of tests/test_sync.py:283-620 and
tests/test_channelizer.py:164-234; the noise is numpy's in both
packages).

Decisions are bit-equal: the scan's six fields on every window, the
receivers' found on every lane and start / cfo_bins / symbols / sync /
sf on the found ones. Float outputs: residual cfo 1e-6 bins, snr_db
1e-2 dB on noisy streams (on noise-free ones both read above 60 dB:
the residual is rounding), sro_ppm 0.05 ppm (as
tests/test_torch_sync.py), correlation scores and spectra within 2e-5
of the frame's peak, CAD peak power 1e-4 dB.
"""

import numpy as np
import pytest

from _torch_util import nn, tparams, tt
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.models import stream as jstream
from lora_phy_tpu.models import sync as jsync
from lora_phy_tpu.ops import channelizer as jchan
from lora_phy_tpu.ops import impair as jimpair
from lora_phy_tpu.utils.params import Bandwidth, LoraParams, Window
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.models import sync as tsync
from lora_phy_tpu_torch.ops import impair as timpair

CFO_ATOL = 1e-6
SNR_ATOL_DB = 1e-2
SRO_ATOL_PPM = 0.05
SCORE_RTOL = 2e-5

N_PAYLOAD = 10
MAX_FRAMES = 4


def _frame(p, payload):
    return np.asarray(jstream.frame_modulate(jmodem.encode(payload), p))


def _place(frames_and_offsets, total):
    out = np.zeros(total, np.complex64)
    for iq, off in frames_and_offsets:
        out[off: off + iq.size] += iq
    return out


def _split(x):
    x = np.asarray(x)
    return (np.ascontiguousarray(x.real.astype(np.float32)),
            np.ascontiguousarray(x.imag.astype(np.float32)))


def _noise(shape, sigma, seed):
    rng = np.random.RandomState(seed)
    return (sigma * (rng.randn(*shape) + 1j * rng.randn(*shape))).astype(np.complex64)


def _as_np(nt):
    return type(nt)(*(nn(f) for f in nt))


def _assert_decisions_equal(got, ref):
    """``found`` on every lane; start, cfo_bins, sync and symbols on the
    found ones (a lane that found nothing carries unspecified values: in
    silence or stopband leakage they come from argmax near-ties)."""
    np.testing.assert_array_equal(got.found, ref.found)
    f = ref.found
    for name in ("start", "cfo_bins", "sync"):
        np.testing.assert_array_equal(getattr(got, name)[f], getattr(ref, name)[f],
                                      err_msg=name)
    np.testing.assert_array_equal(got.symbols[f], ref.symbols[f].astype(np.int32))


def _assert_floats_close(got, ref):
    f = ref.found
    np.testing.assert_allclose(got.cfo[f], ref.cfo[f], rtol=0, atol=CFO_ATOL)
    np.testing.assert_array_equal(got.time_offset[f], ref.time_offset[f])
    _assert_snr_close(got.snr_db[f], ref.snr_db[f])
    np.testing.assert_allclose(got.sro_ppm[f], ref.sro_ppm[f], rtol=0, atol=SRO_ATOL_PPM)


def _assert_snr_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    clean = (got > 60.0) & (ref > 60.0)
    np.testing.assert_allclose(got[~clean], ref[~clean], rtol=0, atol=SNR_ATOL_DB)


def _both(xr, xi, p, *args, **kw):
    ref = jsync.receive_block_planar(xr, xi, p, *args, **kw)
    got = tsync.receive_block_planar(tt(xr), tt(xi), tparams(p), *args, **kw)
    if kw.get("with_spectra"):
        (ref, rspec), (got, gspec) = ref, got
    ref, got = _as_np(ref), _as_np(got)
    _assert_decisions_equal(got, ref)
    _assert_floats_close(got, ref)
    if kw.get("with_spectra"):
        rspec, gspec = nn(rspec), nn(gspec)
        f = ref.found
        np.testing.assert_array_equal(gspec.argmax(-1)[f], got.symbols[f])
        peak = np.abs(rspec[f]).max(axis=(-1, -2), keepdims=True)
        assert (np.abs(gspec[f] - rspec[f]) <= SCORE_RTOL * peak).all()
    return got


# ---------------------------------------------------------------------------
# Streams: [C, T] planes of frames at arbitrary arrival phases
# ---------------------------------------------------------------------------

STREAMS = {
    # name: (params, per-channel arrival phases mod step, CFO bins, noise)
    "sf7": (LoraParams(sf=7), [[0, 37, 64], [100, 1, 127]], 0.0, 0.02),
    "sf7_cfo": (LoraParams(sf=7), [[11, 90], [45, 101]], 2.3, 0.05),
    "sf7_osr2": (LoraParams(sf=7, osr=2), [[1, 131], [64, 200]], 0.0, 0.02),
    "sf7_hann": (LoraParams(sf=7, window=Window.HANN), [[5, 70], [64, 120]], 0.0, 0.02),
    "sf7_bw250": (LoraParams(sf=7, bw=Bandwidth.BW_250), [[3, 20], [31, 0]], 0.0, 0.02),
    "sf8": (LoraParams(sf=8), [[17, 200]], -1.4, 0.05),
}


def _stream(p, phases, cfo, noise, seed):
    rng = np.random.RandomState(seed)
    payloads = rng.randint(0, 256, (len(phases), len(phases[0]),
                                    N_PAYLOAD // 2)).astype(np.uint8)
    step = p.step
    length = _frame(p, payloads[0, 0]).size
    starts = []
    for row in phases:
        pos, st = 2 * step, []
        for r in row:
            s = -(-pos // step) * step + r
            st.append(s)
            pos = s + length + 3 * step
        starts.append(st)
    total = max(s[-1] for s in starts) + length + 2 * step
    x = np.zeros((len(phases), total), np.complex64)
    for c, st in enumerate(starts):
        for k, s in enumerate(st):
            x[c, s:s + length] = _frame(p, payloads[c, k])
    x = x * np.exp(2j * np.pi * cfo * np.arange(total) / step)
    x = x + _noise(x.shape, noise, seed + 1)
    xr, xi = _split(x)
    return xr, xi, np.asarray(starts), payloads


@pytest.fixture(scope="module")
def streams():
    return {name: (p, *_stream(p, ph, cfo, noise, seed=60 + i))
            for i, (name, (p, ph, cfo, noise)) in enumerate(STREAMS.items())}


@pytest.mark.parametrize("gate", [None, -30.0], ids=["ungated", "gated"])
@pytest.mark.parametrize("pre_acc", [2, 3])
@pytest.mark.parametrize("case", sorted(STREAMS))
def test_scan_pre_acc_fields_bit_equal(streams, case, pre_acc, gate):
    p, xr, xi, _, _ = streams[case]
    ref = _as_np(jsync.frame_sync_scan_planar(xr, xi, p, min_power_db=gate,
                                              pre_acc=pre_acc))
    got = _as_np(tsync.frame_sync_scan_planar(tt(xr), tt(xi), tparams(p),
                                              min_power_db=gate, pre_acc=pre_acc))
    for f in ref._fields:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.valid.any()


@pytest.mark.parametrize("pre_acc", [2, 3])
@pytest.mark.parametrize("case", sorted(STREAMS))
def test_receive_block_pre_acc_vs_jax(streams, case, pre_acc):
    """The robust receiver (barrel path at every osr, robust CFO, path
    combining) with its combining scores: JAX's decisions, and every
    frame found with its payload (within one osr step at osr 2)."""
    p, xr, xi, starts, payloads = streams[case]
    got = _both(xr, xi, p, N_PAYLOAD, MAX_FRAMES, min_power_db=-30.0,
                pre_acc=pre_acc, with_spectra=True)
    k = starts.shape[1]
    assert got.found[:, :k].all()
    sent = nn(jmodem.encode(payloads)).astype(np.int64)
    np.testing.assert_array_equal(got.symbols[:, :k], (sent * int(p.scale)) % p.n)
    assert np.abs(got.start[:, :k] - starts).max() <= p.osr - 1


def test_robust_mode_clean_parity():
    """tests/test_sync.py's case: pre_acc=3 gives the default receiver's
    start, symbols and sync on a clean frame, in both packages."""
    p = LoraParams(sf=7)
    pl = np.random.RandomState(25).randint(0, 256, 8).astype(np.uint8)
    iq = _frame(p, pl)
    xr, xi = _split(_place([(iq, 3 * p.step + 50)], iq.size + 8 * p.step))
    r1 = tsync.block_rows(tsync.receive_block_planar(tt(xr), tt(xi), tparams(p), 16,
                                                     min_power_db=-30.0))
    r3 = tsync.block_rows(tsync.receive_block_planar(tt(xr), tt(xi), tparams(p), 16,
                                                     min_power_db=-30.0, pre_acc=3))
    assert len(r1) == len(r3) == 1
    assert r3[0]["start"] == r1[0]["start"] == 3 * p.step + 50
    np.testing.assert_array_equal(nn(r3[0]["symbols"]), nn(r1[0]["symbols"]))
    assert r3[0]["sync"] == r1[0]["sync"] == p.sync_word
    _both(xr, xi, p, 16, min_power_db=-30.0, pre_acc=3)


def test_robust_mode_two_ray_channel_vs_jax():
    """tests/test_sync.py's near-equal-power two-ray channel (0.95 echo at
    3 samples) through apply_multipath_planar, numpy AWGN at 5 dB: the
    same decisions as JAX in both modes on every trial, and the robust
    mode decodes the large majority where the plain one cannot."""
    p = LoraParams(sf=7)
    pl = np.random.RandomState(26).randint(0, 256, 8).astype(np.uint8)
    iq = _frame(p, pl)
    s = np.zeros(3 * p.step + iq.size + 4 * p.step, np.complex64)
    s[3 * p.step: 3 * p.step + iq.size] = iq
    taps = np.array([1.0, 0, 0, 0.95 * np.exp(2.0j)], np.complex64)
    sr, si = _split(s)
    yr, yi = timpair.apply_multipath_planar(tt(sr), tt(si), taps.real, taps.imag)
    jr, ji = jimpair.apply_multipath_planar(sr, si, taps.real, taps.imag)
    np.testing.assert_allclose(nn(yr), np.asarray(jr), rtol=0, atol=1e-6)
    sigma = np.sqrt(0.5 * 10.0 ** (-5.0 / 10.0))
    got = {1: 0, 3: 0}
    trials = 8
    for t in range(trials):
        n = _noise(s.shape, sigma, 4000 + t)
        xr, xi = (nn(yr) + n.real).astype(np.float32), (nn(yi) + n.imag).astype(np.float32)
        for acc in (1, 3):
            blk = _both(xr, xi, p, 16, min_power_db=-30.0, pre_acc=acc)
            for k in np.flatnonzero(blk.found):
                if (abs(blk.start[k] - 3 * p.step) <= p.step and np.array_equal(
                        nn(tmodem.decode(tt(blk.symbols[k]))), pl)):
                    got[acc] += 1
                    break
    assert got[3] >= 6 and got[1] <= 2, got


def test_robust_mode_rejects_loud_noise():
    """Accumulated sums correlate across windows, so loud noise forms long
    runs: the concentration gate rejects them (numpy noise at 0 dB)."""
    p = LoraParams(sf=7)
    xr, xi = _split(_noise((20000,), np.sqrt(0.5), 99))
    got = _both(xr, xi, p, 16, min_power_db=-30.0, pre_acc=3)
    assert not got.found.any()


@pytest.mark.parametrize("osr,pre_acc", [(1, 1), (2, 1), (1, 3)])
def test_tx_phase_step_override_vs_jax(osr, pre_acc):
    """tx_phase_step=0.0 (gr-lora_sdr transmitters) on the circular, the
    barrel and the robust paths: JAX's decisions and residual CFO (the
    fine-CFO estimator assumes no inter-symbol phase step)."""
    p = LoraParams(sf=7, osr=osr)
    xr, xi, _, _ = _stream(p, [[21, 77]], 0.4, 0.02, seed=7 + osr)
    got = _both(xr, xi, p, N_PAYLOAD, MAX_FRAMES, min_power_db=-30.0,
                pre_acc=pre_acc, tx_phase_step=0.0)
    assert got.found[0, :2].all()
    default = _as_np(tsync.receive_block_planar(tt(xr), tt(xi), tparams(p), N_PAYLOAD,
                                                MAX_FRAMES, min_power_db=-30.0,
                                                pre_acc=pre_acc))
    if p.osr == 1:        # the modulator's own step is pi: the override moves cfo
        assert np.abs(got.cfo[0, :2] - default.cfo[0, :2]).min() > 0.1


# ---------------------------------------------------------------------------
# Channel activity detection
# ---------------------------------------------------------------------------

def test_cad_activity_gate_vs_jax():
    """tests/test_sync.py's batch: silence, sub-threshold noise, a frame,
    a frame at 3.7 bins CFO -> [False, False, True, True], JAX's flags and
    peak powers."""
    p = LoraParams(sf=7)
    payload = np.random.RandomState(22).randint(0, 256, 4).astype(np.uint8)
    frame = _frame(p, payload)
    total = frame.size + 12 * p.step
    silent = np.zeros(total, np.complex64)
    noise = _noise((total,), 0.005, 22)
    active = _place([(frame, 5 * p.step)], total)
    cfo_active = _place([(np.asarray(jimpair.apply_cfo_continuous(frame, 3.7, p.n, p.osr)),
                          5 * p.step)], total)
    xr, xi = _split(np.stack([silent, noise, active, cfo_active]))
    for stride in (4, 1, 100):
        ref_act, ref_db = jsync.cad_planar(xr, xi, p, stride=stride)
        act, peak_db = tsync.cad_planar(tt(xr), tt(xi), tparams(p), stride=stride)
        np.testing.assert_array_equal(nn(act), np.asarray(ref_act))
        if stride <= 4:     # at 100 only window 0 (silence) is probed
            assert nn(act).tolist() == [False, False, True, True]
        fin = np.isfinite(np.asarray(ref_db))
        np.testing.assert_array_equal(np.isfinite(nn(peak_db)), fin)
        np.testing.assert_allclose(nn(peak_db)[fin], np.asarray(ref_db)[fin],
                                   rtol=0, atol=1e-4)
    assert float(nn(peak_db)[2]) > -1.0 or stride > 4


def test_cad_short_buffers_vs_jax():
    """Buffers shorter than the stride, down to sub-symbol (False,
    -inf)."""
    p = LoraParams(sf=7)
    frame = _frame(p, np.arange(4, dtype=np.uint8))
    for t in (p.step // 2, p.step, 2 * p.step, 3 * p.step):
        for x in (np.zeros(t, np.complex64), frame[:t]):
            xr, xi = _split(x)
            ref = jsync.cad_planar(xr, xi, p)
            got = tsync.cad_planar(tt(xr), tt(xi), tparams(p))
            assert bool(got[0]) == bool(ref[0])
            assert float(got[1]) == pytest.approx(float(ref[1]), abs=1e-4) \
                or float(got[1]) == float(ref[1]) == -np.inf
        assert bool(tsync.cad_planar(*(tt(a) for a in _split(frame[:t])), tparams(p))[0]) \
            == (t >= p.step)


# ---------------------------------------------------------------------------
# Blind SF
# ---------------------------------------------------------------------------

def _blind_rows_equal(got, ref):
    assert [(r["sf"], r["index"], r["k"], r["start"], r["sync"], r["cfo_bins"])
            for r in got] == [(r["sf"], r["index"], r["k"], r["start"], r["sync"],
                               r["cfo_bins"]) for r in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(nn(a["symbols"]), b["symbols"].astype(np.int32))
        _assert_snr_close([a["snr_db"]], [b["snr_db"]])
        assert abs(a["sro_ppm"] - b["sro_ppm"]) <= SRO_ATOL_PPM


def test_blind_sf_mixed_stream_vs_jax():
    """SF7 and SF9 frames in one stream: each found at its own SF with its
    start, sync and payload; JAX's rows."""
    rng = np.random.RandomState(12)
    pl7 = rng.randint(0, 256, 4).astype(np.uint8)
    pl9 = rng.randint(0, 256, 4).astype(np.uint8)
    f7, f9 = _frame(LoraParams(sf=7), pl7), _frame(LoraParams(sf=9), pl9)
    off7 = 3 * 128
    off9 = off7 + f7.size + 5 * 128
    xr, xi = _split(_place([(f7, off7), (f9, off9)], off9 + f9.size + 14 * 512))
    base = LoraParams(sf=7)
    ref = jsync.blind_frames(jsync.receive_blind_planar(xr, xi, base, 8, sfs=(7, 8, 9, 10)))
    res = tsync.receive_blind_planar(tt(xr), tt(xi), tparams(base), 8, sfs=(7, 8, 9, 10))
    assert sorted(res) == [7, 8, 9, 10]
    got = tsync.blind_frames(res)
    _blind_rows_equal(got, ref)
    assert [(r["sf"], r["start"]) for r in got] == [(7, off7), (9, off9)]
    for r, pl in zip(got, (pl7, pl9)):
        assert r["sync"] == 0x12
        np.testing.assert_array_equal(nn(tmodem.decode(r["symbols"])), pl)


def test_blind_sf_cross_sf_collision_vs_jax():
    """SF7 and SF9 frames fully overlapping in time, equal power: both
    decode without cancellation (cross-SF chirps are quasi-orthogonal).
    Batched over a second, time-shifted copy (leading index)."""
    rng = np.random.RandomState(21)
    pl7 = rng.randint(0, 256, 4).astype(np.uint8)
    pl9 = rng.randint(0, 256, 4).astype(np.uint8)
    f7, f9 = _frame(LoraParams(sf=7), pl7), _frame(LoraParams(sf=9), pl9)
    off9 = 2 * 512
    off7 = off9 + 3 * 512
    total = max(off7 + f7.size, off9 + f9.size) + 14 * 512
    s = _place([(f7, off7), (f9, off9)], total)
    xr, xi = _split(np.stack([s, np.roll(s, 300)]))
    base = LoraParams(sf=7)
    ref = jsync.blind_frames(jsync.receive_blind_planar(xr, xi, base, 8, sfs=(7, 9)))
    got = tsync.blind_frames(tsync.receive_blind_planar(tt(xr), tt(xi), tparams(base), 8,
                                                        sfs=(7, 9)))
    _blind_rows_equal(got, ref)
    assert [(r["index"], r["sf"], r["start"]) for r in got] == [
        ((0,), 9, off9), ((0,), 7, off7), ((1,), 9, off9 + 300), ((1,), 7, off7 + 300)]


def test_blind_sf_rejects_noise_and_skips_short_sfs():
    xr, xi = _split(_noise((9000,), 0.05, 13))
    res = tsync.receive_blind_planar(tt(xr), tt(xi), tparams(LoraParams(sf=7)), 8,
                                     sfs=(7, 8, 9, 12))
    assert sorted(res) == [7, 8, 9]                      # 9000 < (8+4)*4096
    assert tsync.blind_frames(res) == []
    ref = jsync.receive_blind_planar(xr, xi, LoraParams(sf=7), 8, sfs=(7, 8, 9, 12))
    assert sorted(ref) == [7, 8, 9]


# ---------------------------------------------------------------------------
# Wideband
# ---------------------------------------------------------------------------

def _wideband(k, p, chans_payloads, lead=600, tail=600, taps=15, offsets=None):
    """Framed payloads on the given channels of a k-channel synthesis
    bank (JAX's), as wideband planes."""
    syms = {c: np.asarray(jmodem.encode(pl), np.int32) for c, pl in chans_payloads.items()}
    frames = {c: np.asarray(jstream.frame_modulate(s, p)) for c, s in syms.items()}
    size = max(f.size for f in frames.values())
    F = lead + size + tail
    sr = np.zeros((k, F), np.float32)
    si = np.zeros((k, F), np.float32)
    for c, f in frames.items():
        off = lead if offsets is None else offsets[c]
        sr[c, off: off + f.size], si[c, off: off + f.size] = f.real, f.imag
    wr, wi = jchan.synthesize_channels_planar(sr, si, k, taps_per_branch=taps)
    return np.asarray(wr), np.asarray(wi)


@pytest.mark.parametrize("pre_acc", [1, 3])
def test_receive_wideband_planar_vs_jax(pre_acc):
    """tests/test_channelizer.py's one-call wideband case (channels 1 and 2
    of 4 occupied): JAX's decisions per channel, the payloads, and no
    frame on the quiet channels; with the spectra at pre_acc=1."""
    k = 4
    p = LoraParams(sf=7)
    pays = {1: np.arange(16, dtype=np.uint8),
            2: (np.arange(16, dtype=np.uint8) * 3 + 2).astype(np.uint8)}
    wr, wi = _wideband(k, p, pays)
    kw = dict(max_frames=2, taps_per_branch=15, pre_acc=pre_acc)
    ref = jsync.receive_wideband_planar(wr, wi, k, p, 32, with_spectra=pre_acc == 1, **kw)
    got = tsync.receive_wideband_planar(tt(wr), tt(wi), k, tparams(p), 32,
                                        with_spectra=pre_acc == 1, **kw)
    if pre_acc == 1:
        (ref, rspec), (got, gspec) = ref, got
        f = np.asarray(ref.found)
        peak = np.asarray(rspec)[f].max()
        assert np.abs(nn(gspec) - np.asarray(rspec))[f].max() <= SCORE_RTOL * peak
    ref, got = _as_np(ref), _as_np(got)
    _assert_decisions_equal(got, ref)
    _assert_floats_close(got, ref)
    assert got.found.shape == (k, 2)
    assert got.found[1].sum() == 1 and got.found[2].sum() == 1
    assert not got.found[[0, 3]].any()
    for chan, pay in pays.items():
        i = np.flatnonzero(got.found[chan])[0]
        np.testing.assert_array_equal(nn(tmodem.decode(tt(got.symbols[chan, i]))), pay)


def test_receive_wideband_pre_acc_composition():
    """tests/test_sync.py's composition case: one frame on channel 1 of 4
    at sample 700, pre_acc=3, a -15 dB gate: found there only, exact."""
    k = 4
    p = LoraParams(sf=7)
    pay = np.random.RandomState(27).randint(0, 256, 4).astype(np.uint8)
    wr, wi = _wideband(k, p, {1: pay}, lead=700, tail=4000 - 700, offsets={1: 700})
    kw = dict(taps_per_branch=15, min_power_db=-15.0, pre_acc=3)
    ref = _as_np(jsync.receive_wideband_planar(wr, wi, k, p, 8, **kw))
    got = _as_np(tsync.receive_wideband_planar(tt(wr), tt(wi), k, tparams(p), 8, **kw))
    _assert_decisions_equal(got, ref)
    assert got.found[1].any() and not got.found[[0, 2, 3]].any()
    kk = int(np.flatnonzero(got.found[1])[0])
    assert got.start[1, kk] == 700
    np.testing.assert_array_equal(nn(tmodem.decode(tt(got.symbols[1, kk]))), pay)


def test_array_input_goes_to_the_card(monkeypatch):
    """The new entry points given arrays and no device= compute on the
    first CUDA card, and without one raise; device="cpu" runs here."""
    import torch

    from lora_phy_tpu_torch.models import sic as tsic
    from lora_phy_tpu_torch.ops import channelizer as tchan

    p = tparams(LoraParams(sf=7))
    x = np.zeros(20 * p.step, np.float32)
    calls = (lambda **kw: tsync.cad_planar(x, x, p, **kw),
             lambda **kw: tsync.receive_blind_planar(x, x, p, 8, sfs=(7,), **kw),
             lambda **kw: tsync.receive_wideband_planar(x, x, 4, p, 8, **kw),
             lambda **kw: tchan.channelize_planar(x, x, 4, **kw),
             lambda **kw: tsic.receive_sic_planar(x, x, p, 8, **kw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
