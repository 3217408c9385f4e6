"""Port parity: lora_phy_tpu_torch.ops.planar (dechirp + demodulation)
against lora_phy_tpu.ops.planar and the reference goldens
(tests/fixtures/golden/*.npz, 17 cells over SF7-12, BW, osr, window).

Decisions — symbols, sync word, decoded bytes — are bit-equal. Float
outputs carry stated tolerances:

* dechirp: 1.3e-7 (one float32 ulp at magnitude 1): XLA may contract
  ``a*b - c*d`` into an FMA, torch rounds each product.
* cfo 1e-6 and time_offset 2e-3 from the same input planes: the
  fractional-bin interpolator reads neighbouring DFT magnitudes, whose
  float32 sums run in another order in torch's matmul than in XLA's dot,
  and time_offset scales that fraction by N*osr (the Hann window widens
  the peak further).
* At osr > 1 the estimator picks the osr phase of greatest power by
  exact float equality (``p == maxp``, src/phy/LoRaDemod.cpp:85-135). A
  clean tone ties exactly across phases in XLA's sums; the port compares
  the powers recomputed in float64 at the peak bin
  (``planar._tie_power_db``), so the tie holds and cfo / time_offset are
  JAX's on every golden cell (``sf7_bw250000_osr2_win0`` included).
"""

import numpy as np
import pytest
import torch

from _torch_util import GOLDEN, golden_params, nn, tt, tparams
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.ops import planar as jplanar
from lora_phy_tpu.utils.params import LoraParams, Window
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.ops import fft as tfft
from lora_phy_tpu_torch.ops import planar as tplanar
from lora_phy_tpu_torch.ops import windows as twindows

DECHIRP_ATOL = 1.3e-7
CFO_ATOL = 1e-6
TO_ATOL = 2e-3


def _golden(path):
    g = np.load(path)
    xr, xi = jplanar.split_complex(g["iq"])
    return g, golden_params(path.stem), xr, xi


def _assert_offsets_match(p, xr, xi, got, ref):
    """cfo / time_offset of port vs JAX on the same planes."""
    assert abs(float(got.cfo) - float(ref.cfo)) <= CFO_ATOL, (got.cfo, ref.cfo)
    assert abs(float(got.time_offset) - float(ref.time_offset)) <= TO_ATOL, \
        (got.time_offset, ref.time_offset)


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_demodulate_unfused(path):
    g, p, xr, xi = _golden(path)
    tp = tparams(p)
    jdr, jdi = jplanar.dechirp_planar(xr, xi, p)
    tdr, tdi = tplanar.dechirp_planar(tt(xr), tt(xi), tp)
    np.testing.assert_allclose(nn(tdr), nn(jdr), rtol=0, atol=DECHIRP_ATOL)
    np.testing.assert_allclose(nn(tdi), nn(jdi), rtol=0, atol=DECHIRP_ATOL)

    res = tplanar.demodulate_planar(tdr, tdi, tp)
    assert res.symbols.dtype == torch.int32
    np.testing.assert_array_equal(nn(res.symbols), g["demod"].astype(np.int32))
    assert int(res.sync_word) == int(g["sync"])
    np.testing.assert_array_equal(nn(tmodem.decode(res.symbols)), g["decoded"])

    ref = jplanar.demodulate_planar(jdr, jdi, p)
    same_in = tplanar.demodulate_planar(tt(jdr), tt(jdi), tp)
    np.testing.assert_array_equal(nn(same_in.symbols),
                                  nn(ref.symbols).astype(np.int32))
    assert int(same_in.sync_word) == int(ref.sync_word)
    _assert_offsets_match(p, nn(jdr), nn(jdi), same_in, ref)


@pytest.mark.parametrize("path", [g for g in GOLDEN if g.stem.startswith("sf7_")],
                         ids=lambda p: p.stem)
def test_golden_demodulate_fused(path):
    g, p, xr, xi = _golden(path)
    tp = tparams(p)
    tdr, tdi = tplanar.dechirp_planar(tt(xr), tt(xi), tp)
    res = tplanar.demodulate_planar(tdr, tdi, tp, fused=True)
    np.testing.assert_array_equal(nn(res.symbols), g["demod"].astype(np.int32))
    assert int(res.sync_word) == int(g["sync"])
    jdr, jdi = jplanar.dechirp_planar(xr, xi, p)
    ref = jplanar.demodulate_planar(jdr, jdi, p, fused=True)
    np.testing.assert_array_equal(nn(res.symbols), nn(ref.symbols).astype(np.int32))


def _noisy_case(p, snr_db, batch, payload_len, seed):
    rng = np.random.RandomState(seed)
    payloads = rng.randint(0, 256, (batch, payload_len)).astype(np.uint8)
    dech = np.asarray(jmodem.dechirp(jmodem.modulate(jmodem.encode(payloads), p), p))
    sigma = np.sqrt(0.5 * 10.0 ** (-snr_db / 10.0))
    noise = sigma * (rng.randn(*dech.shape) + 1j * rng.randn(*dech.shape))
    xr, xi = jplanar.split_complex((dech + noise).astype(np.complex64))
    return payloads, xr, xi


@pytest.mark.parametrize("sf", [7, 9])
def test_noisy_decisions_equal(sf):
    """numpy AWGN at +5 dB per-sample SNR: the same decisions as JAX."""
    p = LoraParams(sf=sf)
    tp = tparams(p)
    payloads, xr, xi = _noisy_case(p, 5.0, batch=4, payload_len=16, seed=sf)
    ref = jplanar.demodulate_planar(xr, xi, p)
    got = tplanar.demodulate_planar(tt(xr), tt(xi), tp)
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
    np.testing.assert_array_equal(nn(got.sync_word), nn(ref.sync_word))
    np.testing.assert_array_equal(nn(tmodem.decode(got.symbols)), payloads)
    if sf == 7:
        fused = tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=True)
        jfused = jplanar.demodulate_planar(xr, xi, p, fused=True)
        np.testing.assert_array_equal(nn(fused.symbols),
                                      nn(jfused.symbols).astype(np.int32))


@pytest.mark.parametrize("sf,window", [(7, Window.NONE), (9, Window.HANN)])
def test_complex_api_vs_jax(sf, window):
    """modem.modulate/dechirp/demodulate on complex64 (the README Quick
    Start surface). JAX's complex demod runs an FFT, not the planar DFT,
    so its floats are held to JAX's own planar-vs-complex tolerances
    (tests/test_planar.py)."""
    p = LoraParams(sf=sf, window=window)
    tp = tparams(p)
    payload = np.random.RandomState(6).randint(0, 256, 24).astype(np.uint8)
    jiq = jmodem.modulate(jmodem.encode(payload), p)
    jdech = jmodem.dechirp(jiq, p)
    ref = jmodem.demodulate(jdech, p)
    tiq = tmodem.modulate(tmodem.encode(tt(payload)), tp)
    tdech = tmodem.dechirp(tiq, tp)
    np.testing.assert_allclose(nn(tdech), nn(jdech), rtol=0, atol=2 * DECHIRP_ATOL)
    got = tmodem.demodulate(tdech, tp)
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
    assert int(got.sync_word) == int(ref.sync_word)
    np.testing.assert_allclose(float(got.cfo), float(ref.cfo), atol=1e-5)
    np.testing.assert_allclose(float(got.time_offset), float(ref.time_offset),
                               atol=0.5 + 2e-4 * p.step)
    np.testing.assert_array_equal(nn(tmodem.decode(got.symbols)), payload)


# JAX's estimates on a clean SF2-4 loopback: (time_offset, cfo in bins,
# sync words of the three frames), ROADMAP Queue 3
SMALL_SF_ESTIMATES = {2: (2.0, 0.3125, [34, 35, 33]),
                      3: (4.0, 0.140625, [18, 17, 17]),
                      4: (8.0, 0.06640625, [18, 18, 18])}


@pytest.mark.parametrize("sf", sorted(SMALL_SF_ESTIMATES))
def test_small_sf_estimator_reads_sync_as_offset_in_both_packages(sf):
    """A mirrored reference behaviour: at SF2-4 (N < 32) the 2-symbol
    estimator reads the wrapped sync word as a timing offset of N/2 (and a
    fractional CFO), so a clean loopback's symbols come back wrong, in JAX
    as in the port. 3 frames x 12 random symbols (numpy seed 50 + SF)
    through modem.modulate / dechirp, then the default demodulate_planar
    (estimator on): JAX's values asserted, the port's equal to them
    (decisions bit-equal, cfo 1e-6, time_offset 2e-3)."""
    p = LoraParams(sf=sf)
    tp = tparams(p)
    syms = np.random.RandomState(50 + sf).randint(0, p.n, (3, 12))
    jdech = jmodem.dechirp(jmodem.modulate(syms.astype(np.uint16), p), p)
    xr, xi = jplanar.split_complex(np.asarray(jdech))
    ref = jplanar.demodulate_planar(xr, xi, p)
    t_off, cfo, sync = SMALL_SF_ESTIMATES[sf]
    np.testing.assert_array_equal(nn(ref.time_offset), [t_off] * 3)
    assert t_off == p.n / 2
    np.testing.assert_allclose(nn(ref.cfo), [cfo] * 3, rtol=0, atol=CFO_ATOL)
    np.testing.assert_array_equal(nn(ref.sync_word), sync)
    assert not np.array_equal(nn(ref.symbols), syms)
    # the port on JAX's planes and on its own loopback
    tdech = tmodem.dechirp(tmodem.modulate(tt(syms.astype(np.int32)), tp), tp)
    np.testing.assert_allclose(nn(tdech), nn(jdech), rtol=0, atol=2 * DECHIRP_ATOL)
    for got in (tplanar.demodulate_planar(tt(xr), tt(xi), tp),
                tplanar.demodulate_planar(tdech.real.contiguous(),
                                          tdech.imag.contiguous(), tp)):
        np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
        np.testing.assert_array_equal(nn(got.sync_word), nn(ref.sync_word))
        np.testing.assert_allclose(nn(got.cfo), nn(ref.cfo), rtol=0, atol=CFO_ATOL)
        np.testing.assert_allclose(nn(got.time_offset), nn(ref.time_offset),
                                   rtol=0, atol=TO_ATOL)


def test_known_offsets_and_assume_normalized_vs_jax():
    p = LoraParams(sf=7)
    tp = tparams(p)
    _, xr, xi = _noisy_case(p, 10.0, batch=3, payload_len=8, seed=1)
    known = (np.float32(0.004), np.float32(2.0))
    for kw in ({"known_offsets": known}, {"assume_normalized": True}):
        ref = jplanar.demodulate_planar(xr, xi, p, **kw)
        got = tplanar.demodulate_planar(tt(xr), tt(xi), tp, **kw)
        np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
        np.testing.assert_allclose(nn(got.cfo), nn(ref.cfo), rtol=0, atol=CFO_ATOL)
        np.testing.assert_allclose(nn(got.time_offset), nn(ref.time_offset),
                                   rtol=0, atol=TO_ATOL)


def test_scale_normalisation_decodes():
    p = LoraParams(sf=7)
    tp = tparams(p)
    payloads, xr, xi = _noisy_case(p, 20.0, batch=2, payload_len=8, seed=2)
    got = tplanar.demodulate_planar(tt(4.0 * xr), tt(4.0 * xi), tp)
    np.testing.assert_array_equal(nn(tmodem.decode(got.symbols)), payloads)


@pytest.mark.parametrize("osr,dec_phase", [(1, 0), (2, 0), (2, 1)])
def test_shifted_symbol_gather_vs_jax(osr, dec_phase):
    """The guarded per-symbol timing shift, with nonzero offsets of both
    signs (the bench batch never takes this branch) and with all zero."""
    n, s = 32, 5
    rng = np.random.RandomState(osr + dec_phase)
    x = rng.randn(4, s * n * osr + 7).astype(np.float32)
    for t_off in (np.array([0, 37, -45, 3], np.int32), np.zeros(4, np.int32)):
        ref = jmodem._shifted_symbol_gather(x, s, n, osr, t_off, dec_phase)
        got = twindows.shifted_plane_reference(tt(x), s, n, osr, tt(t_off), dec_phase)
        np.testing.assert_array_equal(nn(got), nn(ref))


def test_round_half_away_vs_jax():
    x = np.array([-2.5, -1.5, -0.5, -0.49, 0.0, 0.5, 1.5, 2.5, 3.49], np.float32)
    np.testing.assert_array_equal(nn(tplanar._round_half_away(tt(x))),
                                  nn(jmodem._round_half_away(x)))


@pytest.mark.parametrize("n", [64, 128, 512, 4096])
def test_dft_planar_vs_jax(n):
    """Planar DFT (four-step above 128) against JAX's: float32 sums of up
    to n terms in another order, held to 2e-5*sqrt(n)*n relative to a
    unit-variance input's spectrum scale."""
    rng = np.random.RandomState(n)
    xr = rng.randn(3, n).astype(np.float32)
    xi = rng.randn(3, n).astype(np.float32)
    for mine, ref in zip(tplanar.dft_planar(tt(xr), tt(xi), n),
                         jplanar.dft_planar(xr, xi, n)):
        np.testing.assert_allclose(nn(mine), nn(ref), rtol=0, atol=2e-5 * np.sqrt(n) * 8)
    mag = tplanar.dft_mag2_planar(tt(xr), tt(xi), n)
    np.testing.assert_allclose(nn(mag), nn(jplanar.dft_mag2_planar(xr, xi, n)),
                               rtol=2e-5, atol=1e-3)
    np.testing.assert_array_equal(nn(tplanar.argmax_bins_planar(tt(xr), tt(xi), n)),
                                  nn(jplanar.argmax_bins_planar(xr, xi, n)))


def test_detect_planar_vs_jax():
    rng = np.random.RandomState(12)
    for n in (128, 256):
        xr = rng.randn(6, n).astype(np.float32)
        xi = rng.randn(6, n).astype(np.float32)
        got = tplanar.detect_planar(tt(xr), tt(xi), n)
        ref = jplanar.detect_planar(xr, xi, n)
        np.testing.assert_array_equal(nn(got.index), nn(ref.index))
        for f in ("power", "power_avg", "findex", "peak_re", "peak_im"):
            np.testing.assert_allclose(nn(getattr(got, f)), nn(getattr(ref, f)),
                                       rtol=1e-4, atol=1e-4, err_msg=f)


def test_argmax_natural_tie_vs_jax():
    """Equal maxima at natural bins 30 and 65 of a scrambled N=512
    spectrum (bin k = k1*n2 + k2 at position k2*n1 + k1): bin 65 comes
    first in scrambled order, bin 30 is the answer."""
    from lora_phy_tpu.ops.fft import _split

    n1, n2 = _split(512)
    flat = np.zeros((2, n2 * n1), np.float32)
    pos = lambda k: (k % n2) * n1 + k // n2
    assert pos(65) < pos(30)
    flat[:, [pos(30), pos(65)]] = 7.0
    flat[1, pos(100)] = 9.0
    got_b, got_p = tfft._argmax_natural(tt(flat), n1, n2)
    ref_b, ref_p = jplanar._argmax_natural(flat, n1, n2)
    np.testing.assert_array_equal(nn(got_b), nn(ref_b))
    np.testing.assert_array_equal(nn(got_p), nn(ref_p))
    assert nn(got_b).tolist() == [30, 100]


# ---------------------------------------------------------------------------
# The block receiver's estimators and the spectrum demod
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sf,osr,scale", [(7, 1, 1.0), (7, 2, 1.0), (7, 1, 2.0),
                                          (9, 4, 1.0), (8, 1, 4.0)])
def test_preamble_phase_step_bit_equal(sf, osr, scale):
    assert tplanar._preamble_phase_step(sf, osr, scale) == \
        jplanar._preamble_phase_step(sf, osr, scale)


def _preamble_windows(p, cfo_bins, windows, noise, seed):
    """Dechirped base upchirps at a CFO of ``cfo_bins``, plus AWGN."""
    rng = np.random.RandomState(seed)
    zeros = np.zeros((3, windows - 2), np.int32)
    re, im = jplanar.modulate_planar(zeros, LoraParams(sf=p.sf, osr=p.osr,
                                                       sync_word=0))
    x = np.asarray(re) + 1j * np.asarray(im)
    t = np.arange(x.shape[-1])
    x = x * np.exp(2j * np.pi * cfo_bins[:, None] * t / p.step)
    x = x + noise * (rng.randn(*x.shape) + 1j * rng.randn(*x.shape))
    xr, xi = jplanar.split_complex(x.astype(np.complex64))
    return jplanar.dechirp_planar(xr, xi, p)


@pytest.mark.parametrize("osr", [1, 2])
def test_estimate_preamble_planar_vs_jax(osr):
    """Residual CFO from 8 preamble windows at fractional CFOs, with and
    without a bin offset, and from one window. Held to CFO_ATOL (1e-6
    bins): the coarse mean reads the fractional interpolator and the fine
    term the peak phases, both from float32 DFT sums whose order differs
    between torch's matmul and XLA's dot."""
    p = LoraParams(sf=7, osr=osr)
    cfo = np.array([0.3, -1.45, 2.2])
    dr, di = _preamble_windows(p, cfo, 8, 0.05, seed=osr)
    pps = jplanar._preamble_phase_step(p.sf, p.osr, p.scale)
    b0 = np.array([0, 3, 127], np.int32)
    for kw in ({}, {"bin_offset": b0}):
        ref = jplanar.estimate_preamble_planar(dr, di, p.n, osr, phase_step=pps, **kw)
        got = tplanar.estimate_preamble_planar(tt(dr), tt(di), p.n, osr,
                                               phase_step=pps,
                                               **{k: tt(v) for k, v in kw.items()})
        assert got.dtype == torch.float32 and got.shape == (3,)
        np.testing.assert_allclose(nn(got), nn(ref), rtol=0, atol=CFO_ATOL)
    one = p.step
    ref = jplanar.estimate_preamble_planar(dr[..., :one], di[..., :one], p.n, osr)
    got = tplanar.estimate_preamble_planar(tt(dr[..., :one]), tt(di[..., :one]), p.n, osr)
    np.testing.assert_allclose(nn(got), nn(ref), rtol=0, atol=CFO_ATOL)


SRO_ATOL_PPM = 0.05


@pytest.mark.parametrize("osr,continuous", [(1, False), (2, False), (2, True)])
def test_estimate_sro_planar_vs_jax(osr, continuous):
    """Clock drift in ppm from dechirped noisy payload windows (fold-aware
    decimation phase at osr 2). Held to 0.05 ppm: a mean of per-window
    fractional-bin differences, each a ratio of float32 DFT magnitudes
    summed in another order, scaled by 1e6/N (one float32 ulp of a
    fractional bin is ~1e-7, i.e. ~1e-3 ppm at N = 128, with headroom
    for the noise windows' flatter peaks)."""
    p = LoraParams(sf=7, osr=osr, continuous_chirp=continuous)
    payloads, xr, xi = _noisy_case(p, 10.0, batch=2, payload_len=10, seed=osr)
    ref = jplanar.estimate_sro_planar(xr, xi, p)
    got = tplanar.estimate_sro_planar(tt(xr), tt(xi), tparams(p))
    np.testing.assert_allclose(nn(got), nn(ref), rtol=0, atol=SRO_ATOL_PPM)
    short = tplanar.estimate_sro_planar(tt(xr[..., : p.step]), tt(xi[..., : p.step]),
                                        tparams(p))
    np.testing.assert_array_equal(nn(short), np.zeros(2, np.float32))


SPECTRUM_RTOL = 2e-5


@pytest.mark.parametrize("osr,window,dec_phase", [(1, Window.NONE, 0),
                                                  (2, Window.NONE, 1),
                                                  (1, Window.HANN, 0)])
def test_demodulate_spectrum_planar_vs_jax(osr, window, dec_phase):
    """The spectrum demod with injected offsets (the block receiver's
    call) and with its own estimator: the argmax of the spectra, the sync
    word and the decoded bytes bit-equal; spectra within 2e-5 relative to
    each frame's peak (float32 sums of N terms in another order)."""
    p = LoraParams(sf=7, osr=osr, window=window)
    tp = tparams(p)
    payloads, xr, xi = _noisy_case(p, 10.0, batch=3, payload_len=8, seed=4)
    cfo = np.array([0.01, -0.02, 0.015], np.float32)    # true CFO is 0
    for known in ((cfo, np.zeros(3, np.float32)), None):
        ref = jplanar.demodulate_spectrum_planar(xr, xi, p, known_offsets=known,
                                                 dec_phase=dec_phase)
        tknown = None if known is None else tuple(tt(k) for k in known)
        got = tplanar.demodulate_spectrum_planar(tt(xr), tt(xi), tp,
                                                 known_offsets=tknown,
                                                 dec_phase=dec_phase)
        mag, rmag = nn(got[0]), nn(ref[0])
        assert mag.shape == rmag.shape == (3, 16, p.n)
        np.testing.assert_array_equal(mag.argmax(-1), rmag.argmax(-1))
        np.testing.assert_array_equal(nn(got[1]), nn(ref[1]))
        peak = rmag.max(-1, keepdims=True)
        assert np.abs(mag - rmag).max() <= SPECTRUM_RTOL * peak.max()
        np.testing.assert_allclose(nn(got[2]), nn(ref[2]), rtol=0, atol=CFO_ATOL)
        if known is not None:
            np.testing.assert_array_equal(
                nn(tmodem.decode(torch.argmax(got[0], -1).to(torch.int32))), payloads)
    # precision='bf16': the same bf16-rounded spectra as JAX's (products
    # exact in float32, sums in another order: 1e-6 of the peak at N=128)
    ref = jplanar.demodulate_spectrum_planar(xr, xi, p, precision="bf16",
                                             dec_phase=dec_phase)
    got = tplanar.demodulate_spectrum_planar(tt(xr), tt(xi), tp, precision="bf16",
                                             dec_phase=dec_phase)
    mag, rmag = nn(got[0]), nn(ref[0])
    np.testing.assert_array_equal(mag.argmax(-1), rmag.argmax(-1))
    np.testing.assert_array_equal(nn(got[1]), nn(ref[1]))
    assert np.abs(mag - rmag).max() <= 1e-6 * rmag.max()
    np.testing.assert_allclose(nn(got[2]), nn(ref[2]), rtol=0, atol=CFO_ATOL)
