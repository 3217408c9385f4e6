"""Port parity: lora_phy_tpu_torch.models.sync (the frame-sync scan and
the block receiver) against lora_phy_tpu.models.sync on the same
numpy-seeded streams: SF7 frames at arbitrary arrival phases (the
degenerate half-window phase included) under AWGN, with and without an
integer + fractional CFO, at osr 2 (the barrel path with its sub-osr
refinement), with the Hann window (barrel path at osr 1) and at BW250
(inside the slope envelope, ROADMAP.md Queue 3).

Decisions are bit-equal on every lane, found or not: the scan's six
fields, and the receiver's found / start / cfo_bins / symbols / sync.
Float outputs carry stated tolerances (module constants below); each
comes from float32 sums that torch's matmul and reductions take in
another order than XLA's dot and reduce.
"""

import numpy as np
import pytest
import torch

from _torch_util import cuda_device, nn, tparams, tt
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.models import stream as jstream
from lora_phy_tpu.models import sync as jsync
from lora_phy_tpu.utils.params import Bandwidth, LoraParams, Window
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.models import sync as tsync

# residual CFO (bins): a mean of fractional interpolations and phase
# slopes over 8 preamble windows, all read from float32 DFT values
CFO_ATOL = 1e-6
# SNR (dB): 10*log10 of mean peak over mean (sum - peak); at these streams'
# ~40 dB the residual sum cancels ~1e4-fold, so a float32 ulp of the
# spectrum sum moves it by ~1e-3 relative
SNR_ATOL_DB = 1e-2
# SRO (ppm): a mean of fractional-bin differences scaled by 1e6/N
SRO_ATOL_PPM = 0.05
# payload spectra, relative to each frame's peak |DFT|^2
SPECTRA_RTOL = 2e-5

N_PAYLOAD = 10            # symbols per frame (5 bytes)
MAX_FRAMES = 4

CASES = {
    # name: (params, per-channel arrival phases mod step, CFO in bins)
    "sf7": (LoraParams(sf=7), [[0, 37, 64], [100, 1, 127]], 0.0),
    "sf7_cfo": (LoraParams(sf=7), [[11, 90], [45, 101]], 2.3),
    "sf7_osr2": (LoraParams(sf=7, osr=2), [[1, 131], [64, 200]], 0.0),
    "sf7_hann": (LoraParams(sf=7, window=Window.HANN), [[5, 70], [64, 120]], 0.0),
    "sf7_bw250": (LoraParams(sf=7, bw=Bandwidth.BW_250), [[3, 20], [31, 0]], 0.0),
}


def _frames(p, payloads):
    """JAX-synthesized frames [..., L] (re, im) float32 numpy planes."""
    fr, fi = jstream.frame_modulate_planar(np.asarray(jmodem.encode(payloads)), p)
    return np.asarray(fr), np.asarray(fi)


def _stream(p, phases, cfo, seed, noise=0.02, lead_windows=2, gap_windows=3):
    """[C, T] planes holding one frame per phase (channel c, frame k
    arriving ``phases[c][k]`` samples into a window), their true starts
    and payloads."""
    rng = np.random.RandomState(seed)
    payloads = rng.randint(0, 256, (len(phases), len(phases[0]),
                                    N_PAYLOAD // 2)).astype(np.uint8)
    fr, fi = _frames(p, payloads)
    length, step = fr.shape[-1], p.step
    starts = []
    for row in phases:
        pos, st = lead_windows * step, []
        for r in row:
            s = -(-pos // step) * step + r
            st.append(s)
            pos = s + length + gap_windows * step
        starts.append(st)
    total = max(s[-1] for s in starts) + length + 2 * step
    x = np.zeros((len(phases), total), np.complex64)
    for c, st in enumerate(starts):
        for k, s in enumerate(st):
            x[c, s:s + length] = fr[c, k] + 1j * fi[c, k]
    t = np.arange(total)
    x = x * np.exp(2j * np.pi * cfo * t / step)
    x = x + noise * (rng.randn(*x.shape) + 1j * rng.randn(*x.shape))
    x = x.astype(np.complex64)
    return (np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag),
            np.asarray(starts), payloads)


def _as_np(nt):
    return type(nt)(*(nn(f) for f in nt))


@pytest.fixture(scope="module")
def streams():
    """Every case's stream through both packages: the scan with and
    without the power gate, and the block receiver (gated)."""
    out = {}
    for i, (name, (p, phases, cfo)) in enumerate(CASES.items()):
        xr, xi, starts, payloads = _stream(p, phases, cfo, seed=40 + i)
        tp = tparams(p)
        res = {"p": p, "xr": xr, "xi": xi, "starts": starts, "payloads": payloads}
        for gate in (None, -30.0):
            res["jscan", gate] = _as_np(jsync.frame_sync_scan_planar(
                xr, xi, p, min_power_db=gate))
            res["tscan", gate] = _as_np(tsync.frame_sync_scan_planar(
                tt(xr), tt(xi), tp, min_power_db=gate))
        jblk, jspec = jsync.receive_block_planar(
            xr, xi, p, N_PAYLOAD, MAX_FRAMES, min_power_db=-30.0, with_spectra=True)
        tblk, tspec = tsync.receive_block_planar(
            tt(xr), tt(xi), tp, N_PAYLOAD, MAX_FRAMES, min_power_db=-30.0,
            with_spectra=True)
        res["jblk"], res["jspec"] = _as_np(jblk), nn(jspec)
        res["tblk"], res["tspec"] = _as_np(tblk), nn(tspec)
        res["tblk_plain"] = _as_np(tsync.receive_block_planar(
            tt(xr), tt(xi), tp, N_PAYLOAD, MAX_FRAMES, min_power_db=-30.0))
        out[name] = res
    return out


def _assert_decisions_equal(got, ref):
    for f in ("found", "start", "cfo_bins", "sync"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    np.testing.assert_array_equal(got.symbols, ref.symbols.astype(np.int32))


@pytest.mark.parametrize("gate", [None, -30.0], ids=["ungated", "gated"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_fields_bit_equal(streams, case, gate):
    s = streams[case]
    got, ref = s["tscan", gate], s["jscan", gate]
    for f in ref._fields:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.valid.any()


@pytest.mark.parametrize("gate", [None, -30.0], ids=["ungated", "gated"])
def test_scan_noise_only_bit_equal(gate):
    """Noise alone (and a silent stretch): all six fields equal, nothing
    valid under the gate."""
    p = LoraParams(sf=7)
    rng = np.random.RandomState(4)
    x = 0.1 * (rng.randn(2, 4000) + 1j * rng.randn(2, 4000))
    x[1, 1000:2500] = 0.0
    xr, xi = (np.ascontiguousarray(a.astype(np.float32)) for a in (x.real, x.imag))
    ref = _as_np(jsync.frame_sync_scan_planar(xr, xi, p, min_power_db=gate))
    got = _as_np(tsync.frame_sync_scan_planar(tt(xr), tt(xi), tparams(p),
                                              min_power_db=gate))
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    if gate is not None:
        assert not got.valid.any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_receive_block_decisions_bit_equal(streams, case):
    s = streams[case]
    got, ref = s["tblk"], s["jblk"]
    _assert_decisions_equal(got, ref)
    _assert_decisions_equal(s["tblk_plain"], ref)
    # and every frame is found with its payload's symbols: at BW250 the
    # tone of symbol v sits at bin (v * scale) mod N, so SF7's 8-bit
    # codewords alias and sync 0x12 reads 0x24 (docs/SEMANTICS.md,
    # "BW250/500 bin aliasing"), in the JAX package as here
    p = s["p"]
    k = s["starts"].shape[1]
    assert got.found[:, :k].all() and not got.found[:, k:].any()
    sent = nn(jmodem.encode(s["payloads"])).astype(np.int64)
    np.testing.assert_array_equal(got.symbols[:, :k],
                                  (sent * int(p.scale)) % p.n)
    assert (got.sync[:, :k] == (0x12 if p.scale == 1 else 0x24)).all()
    if case != "sf7_osr2":        # osr 2 resolves the start to +-1 sample
        np.testing.assert_array_equal(got.start[:, :k], s["starts"])
    else:
        assert np.abs(got.start[:, :k] - s["starts"]).max() <= 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_receive_block_floats_within_tolerance(streams, case):
    s = streams[case]
    got, ref = s["tblk"], s["jblk"]
    f = ref.found
    np.testing.assert_allclose(got.cfo[f], ref.cfo[f], rtol=0, atol=CFO_ATOL)
    np.testing.assert_array_equal(got.time_offset[f], ref.time_offset[f])
    np.testing.assert_allclose(got.snr_db[f], ref.snr_db[f], rtol=0, atol=SNR_ATOL_DB)
    np.testing.assert_allclose(got.sro_ppm[f], ref.sro_ppm[f], rtol=0,
                               atol=SRO_ATOL_PPM)
    for a in (got.cfo, got.snr_db, got.sro_ppm):
        assert a.dtype == np.float32 and np.isfinite(a[f]).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_receive_block_with_spectra_vs_jax(streams, case):
    """Payload spectra in true bin order on both paths: their argmax is
    the reported symbols, and they match JAX's within SPECTRA_RTOL of the
    frame's peak."""
    s = streams[case]
    got, ref, blk = s["tspec"], s["jspec"], s["tblk"]
    f = s["jblk"].found
    assert got.shape == ref.shape == blk.symbols.shape + (s["p"].n,)
    np.testing.assert_array_equal(got.argmax(-1)[f], blk.symbols[f])
    peak = ref[f].max(axis=(-1, -2), keepdims=True)
    assert (np.abs(got[f] - ref[f]) <= SPECTRA_RTOL * peak).all()


# ---------------------------------------------------------------------------
# The cases of tests/test_sync.py that this slice covers
# ---------------------------------------------------------------------------

def _place(frames_and_offsets, total):
    out = np.zeros(total, np.complex64)
    for iq, off in frames_and_offsets:
        out[off: off + iq.size] = iq
    return out


def _jframe(p, payload):
    return np.asarray(jstream.frame_modulate(jmodem.encode(payload), p))


def _split(x):
    return (np.ascontiguousarray(x.real.astype(np.float32)),
            np.ascontiguousarray(x.imag.astype(np.float32)))


def _both(xr, xi, p, *args, **kw):
    ref = _as_np(jsync.receive_block_planar(xr, xi, p, *args, **kw))
    got = _as_np(tsync.receive_block_planar(tt(xr), tt(xi), tparams(p), *args, **kw))
    _assert_decisions_equal(got, ref)
    return got


def test_receive_block_multiframe_multichannel():
    p = LoraParams(sf=7)
    rng = np.random.RandomState(7)
    n_payload = 8
    chans, starts, wants = [], [], []
    for c in range(3):
        offs = [100 + 400 * c, 7000 + 150 * c]
        pls = [rng.randint(0, 256, n_payload // 2).astype(np.uint8) for _ in offs]
        chans.append(_place([(_jframe(p, pl), off) for pl, off in zip(pls, offs)],
                            14000))
        starts.append(offs)
        wants.append(pls)
    got = _both(*_split(np.stack(chans)), p, n_payload, max_frames=3)
    assert got.found[:, :2].all() and not got.found[:, 2].any()
    np.testing.assert_array_equal(got.start[:, :2], np.asarray(starts))
    assert (got.sync[:, :2] == p.sync_word).all()
    for c in range(3):
        for k in range(2):
            np.testing.assert_array_equal(nn(tmodem.decode(tt(got.symbols[c, k]))),
                                          wants[c][k])


def test_receive_block_frame_past_end_not_reported():
    p = LoraParams(sf=7)
    pl = np.random.RandomState(9).randint(0, 256, 4).astype(np.uint8)
    iq = _jframe(p, pl)
    cut = iq.size - 4 * p.step         # payload runs past the block end
    got = _both(*_split(_place([(iq[:cut], 0)], cut)[None]), p, 8, max_frames=2)
    assert not got.found.any()


def test_no_frame_no_candidates():
    p = LoraParams(sf=7)
    rng = np.random.RandomState(4)
    noise = (0.1 * (rng.randn(4000) + 1j * rng.randn(4000))).astype(np.complex64)
    xr, xi = _split(noise)
    scan = tsync.frame_sync_scan_planar(tt(xr), tt(xi), tparams(p))
    assert not bool(scan.valid.any())
    assert not _both(xr, xi, p, 8).found.any()


@pytest.mark.parametrize("off_in_window", [64, 192 + 64])
def test_receive_block_degenerate_half_window_offset(off_in_window):
    """A frame at exactly step/2 off the window grid (the two-sided
    split's sign ambiguity): the start probe resolves the exact start."""
    p = LoraParams(sf=7)
    pl = np.random.RandomState(23).randint(0, 256, 6).astype(np.uint8)
    iq = _jframe(p, pl)
    off = 2 * p.step + off_in_window
    got = _both(*_split(_place([(iq, off)], off + iq.size + 4 * p.step)), p,
                pl.size * 2)
    found = np.flatnonzero(got.found)
    assert found.size == 1 and got.start[found[0]] == off
    np.testing.assert_array_equal(nn(tmodem.decode(tt(got.symbols[found[0]]))), pl)


def test_degenerate_offset_with_cfo_mirrors_jax():
    """A frame at exactly step/2 off the grid AND an integer CFO: the
    two-sided split's alias (tau = +-step/2 against cfo = -+n/2) is
    resolved by the minimal-|cfo| prior, which the CFO defeats — the JAX
    receiver reports this frame step/2 late with cfo_bins off by n/2
    (ROADMAP.md Queue 3, reference side). The port gives the same
    decisions, and the frame beside it (phase 45) decodes."""
    p = LoraParams(sf=7)
    xr, xi, starts, payloads = _stream(p, [[45, 64]], 2.0, seed=41)
    got = _both(xr, xi, p, N_PAYLOAD, MAX_FRAMES, min_power_db=-30.0)
    assert got.found[0, :2].all()
    assert got.start[0, 0] == starts[0, 0] and got.start[0, 1] == starts[0, 1] + p.step // 2
    assert got.cfo_bins[0, 0] == 2 and got.cfo_bins[0, 1] == 2 - p.n // 2
    np.testing.assert_array_equal(nn(tmodem.decode(tt(got.symbols[0, 0]))),
                                  payloads[0, 0])


def test_circular_extraction_matches_barrel_path(streams, monkeypatch):
    """The port's two extraction paths on the same CFO'd noisy stream:
    equal decisions, floats within the JAX test's own tolerances."""
    s = streams["sf7_cfo"]
    tp = tparams(s["p"])
    xr, xi = tt(s["xr"]), tt(s["xi"])
    fast = _as_np(tsync.receive_block_planar(xr, xi, tp, N_PAYLOAD, MAX_FRAMES,
                                             min_power_db=-30.0))
    monkeypatch.setattr(tsync, "_circ_wrap_const", lambda _p: (1.0, False))
    slow = _as_np(tsync.receive_block_planar(xr, xi, tp, N_PAYLOAD, MAX_FRAMES,
                                             min_power_db=-30.0))
    np.testing.assert_array_equal(fast.found, slow.found)
    f = fast.found
    assert f[:, :2].all()
    for name in ("start", "sync", "symbols", "cfo_bins"):
        np.testing.assert_array_equal(getattr(fast, name)[f], getattr(slow, name)[f])
    np.testing.assert_allclose(fast.cfo[f], slow.cfo[f], atol=1e-3)
    np.testing.assert_allclose(fast.snr_db[f], slow.snr_db[f], atol=0.1)
    np.testing.assert_allclose(fast.sro_ppm[f], slow.sro_ppm[f], atol=0.5)


def test_pre_acc_not_ported():
    """pre_acc 2..3 runs (silence: no frame); values outside 1..3 raise
    ValueError, as in JAX (the robust mode's parity cases are in
    tests/test_torch_sync_modes.py)."""
    p = tparams(LoraParams(sf=7))
    x = torch.zeros(1, 40 * p.step)
    for pre_acc in (2, 3):
        assert not tsync.receive_block_planar(x, x, p, 8, pre_acc=pre_acc).found.any()
        assert not tsync.frame_sync_scan_planar(x, x, p, pre_acc=pre_acc).valid.any()
    for pre_acc in (0, 4):
        with pytest.raises(ValueError, match="pre_acc"):
            tsync.frame_sync_scan_planar(x, x, p, pre_acc=pre_acc)
        with pytest.raises(ValueError, match="pre_acc"):
            tsync.receive_block_planar(x, x, p, 8, pre_acc=pre_acc)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_max", [1, 3, 9])
def test_kth_valid_vs_jax(k_max):
    """Positions and found flags of the first k valid windows, with fewer,
    as many and more valid windows than k, and none."""
    rng = np.random.RandomState(k_max)
    valid = rng.rand(4, 37) < np.array([0.0, 0.05, 0.2, 0.6])[:, None]
    ref_pos, ref_found = (nn(a) for a in jsync._kth_valid(valid, k_max))
    pos, found = tsync._kth_valid(tt(valid), k_max)
    np.testing.assert_array_equal(nn(found), ref_found)
    np.testing.assert_array_equal(nn(pos), ref_pos)


def test_gather_window_rows_vs_jax():
    """Row slabs with the first row clamped at both ends."""
    rng = np.random.RandomState(5)
    rows = rng.randn(2, 20, 8).astype(np.float32)
    widx0 = np.array([[-3, 0, 5, 19], [17, 12, 1, -1]], np.int32)
    ref = nn(jsync._gather_window_rows(rows, widx0, 6, 8))
    got = nn(tsync._gather_window_rows(tt(rows), tt(widx0), 6, 8))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("p", [LoraParams(sf=7), LoraParams(sf=9),
                               LoraParams(sf=7, bw=Bandwidth.BW_250),
                               LoraParams(sf=7, bw=Bandwidth.BW_500),
                               LoraParams(sf=7, osr=2)],
                         ids=["sf7", "sf9", "bw250", "bw500", "osr2"])
def test_circ_wrap_const_vs_jax(p):
    assert tsync._circ_wrap_const(tparams(p)) == jsync._circ_wrap_const(p)


def test_signed_bin_and_round_half_even_vs_jax():
    b = np.arange(128, dtype=np.int32)
    np.testing.assert_array_equal(nn(tsync._signed_bin(tt(b), 128)),
                                  nn(jsync._signed_bin(b, 128)))
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -3.51], np.float32)
    np.testing.assert_array_equal(nn(tsync._round_half_even(tt(x))),
                                  nn(jsync._round_half_even(x)))


def test_block_rows_vs_jax(streams):
    s = streams["sf7"]
    jrows = jsync.block_rows(jsync.BlockFrames(*(f[1] for f in s["jblk"])))
    trows = tsync.block_rows(tsync.BlockFrames(*(tt(f[1]) for f in s["tblk"])))
    assert [r["k"] for r in trows] == [r["k"] for r in jrows] == [0, 1, 2]
    for a, b in zip(trows, jrows):
        for key in ("start", "cfo_bins", "sync"):
            assert a[key] == b[key], key
        np.testing.assert_array_equal(nn(a["symbols"]), b["symbols"].astype(np.int32))
        assert abs(a["cfo"] - b["cfo"]) <= CFO_ATOL


@pytest.mark.gpu
def test_receive_block_cuda_matches_cpu(streams):
    """The receiver on the card against the same call on the CPU: equal
    decisions on both paths."""
    dev = cuda_device()
    for case in ("sf7", "sf7_osr2"):
        s = streams[case]
        tp = tparams(s["p"])
        got = _as_np(tsync.receive_block_planar(
            tt(s["xr"]).to(dev), tt(s["xi"]).to(dev), tp, N_PAYLOAD, MAX_FRAMES,
            min_power_db=-30.0))
        _assert_decisions_equal(got, s["tblk"])
