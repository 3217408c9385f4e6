"""Port parity: lora_phy_tpu_torch.models.soft (max-log LLRs, the ML
codeword correlator, soft payload decoding and the Hamming 8/4 ML
detector) against lora_phy_tpu.models.soft, on the same numpy-seeded
spectra, clean and noisy.

Decisions (nibbles, bytes, crc_ok) are bit-equal. Floats carry stated
tolerances: LLRs within 1e-6 of the frame's peak magnitude
(sqrt(max |X|^2)); min_score within 1e-5 relative; ML margins of
random LLRs within 1e-5 of the codeword's score scale, sum |LLR| (a
margin is the difference of two scores, each summed in another order
than XLA's, so a small margin carries the scores' rounding)."""

import numpy as np
import pytest
import torch

from _torch_util import nn, tparams, tt
from lora_phy_tpu.models import coded as jcoded
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.models import soft as jsoft
from lora_phy_tpu.ops import planar as jplanar
from lora_phy_tpu.utils.params import Bandwidth, LoraParams
from lora_phy_tpu_torch.models import coded as tcoded
from lora_phy_tpu_torch.models import soft as tsoft
from lora_phy_tpu_torch.ops import planar as tplanar

LLR_TOL = 1e-6      # of the frame's peak magnitude
SCORE_RTOL = 1e-5   # min_score relative; ML margins of the score scale


def _noisy_planes(bins, params, snr_db, seed):
    """Modulated coded bins (with sync) plus numpy-seeded complex AWGN at
    ``snr_db`` per sample (unit-power chirps), as float32 planes."""
    re, im = (nn(a) for a in jplanar.modulate_planar(np.asarray(bins, np.int32), params))
    if snr_db is None:
        return re, im
    rng = np.random.RandomState(seed)
    sigma = np.sqrt(10.0 ** (-snr_db / 10.0) / 2.0)
    return ((re + sigma * rng.randn(*re.shape)).astype(np.float32),
            (im + sigma * rng.randn(*im.shape)).astype(np.float32))


def _spectra(bins, params, snr_db=None, seed=0):
    """JAX's |DFT|^2 spectra of the data symbols: [..., S, N] numpy."""
    xr, xi = _noisy_planes(bins, params, snr_db, seed)
    dr, di = jplanar.dechirp_planar(xr, xi, params)
    return np.array(jplanar.demodulate_spectrum_planar(dr, di, params)[0])


@pytest.mark.parametrize("n,ppm,shift,offset", [
    (128, 7, 0, 0), (128, 5, 2, 0), (256, 8, 0, 1), (4096, 10, 2, 0), (4096, 12, 0, 1)])
def test_bit_masks_vs_jax(n, ppm, shift, offset):
    mine = tsoft._bit_masks(n, ppm, shift, offset)
    assert mine.dtype == np.bool_ and mine.shape == (ppm, n)
    np.testing.assert_array_equal(mine, jsoft._bit_masks(n, ppm, shift, offset))


@pytest.mark.parametrize("cr", [1, 2, 3, 4])
def test_codebook_vs_jax(cr):
    mine = tsoft._codebook(cr)
    assert mine.dtype == np.float32
    np.testing.assert_array_equal(mine, jsoft._codebook(cr))


@pytest.mark.parametrize("n,scale", [(128, 1), (128, 2), (256, 4), (4096, 1)])
def test_hamming84_bin_onehot_vs_jax(n, scale):
    np.testing.assert_array_equal(tsoft._hamming84_bin_onehot(n, scale),
                                  jsoft._hamming84_bin_onehot(n, scale))


@pytest.mark.parametrize("shift,offset", [(0, 0), (2, 0), (0, 1)])
def test_bin_llrs_vs_jax(shift, offset):
    """Noisy spectra (and a few negative bins, which both clamp at 0):
    LLRs within LLR_TOL of the frame's peak magnitude."""
    p = LoraParams(sf=7)
    cfg = jcoded.CodedConfig(sf=7, cr=2, ldro=bool(shift))
    payload = np.random.RandomState(5).randint(0, 256, (3, 12)).astype(np.uint8)
    mag2 = _spectra(nn(jcoded.encode_payload(payload, cfg)), p, snr_db=-6.0, seed=5)
    mag2[0, 0, :5] = -1e-3
    ppm = 7 - shift
    ref = nn(jsoft.bin_llrs(mag2, ppm, shift, offset))
    got = tsoft.bin_llrs(tt(mag2), ppm, shift, offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    peak = np.sqrt(mag2.max(axis=(-2, -1)))[:, None, None]
    assert np.all(np.abs(nn(got) - ref) <= LLR_TOL * peak)
    np.testing.assert_array_equal(
        nn(tsoft.symbol_llrs(tt(mag2), tcoded.CodedConfig(sf=7, cr=2, ldro=bool(shift)))),
        nn(tsoft.bin_llrs(tt(mag2), ppm, shift)))


@pytest.mark.parametrize("cr", [1, 2, 3, 4])
def test_ml_decode_vs_jax(cr):
    rng = np.random.RandomState(40 + cr)
    llrs = (rng.randn(4, 33, 4 + cr) * 20.0).astype(np.float32)
    nib, margin = tsoft.ml_decode(tt(llrs), cr)
    rnib, rmargin = (nn(a) for a in jsoft.ml_decode(llrs, cr))
    assert nib.dtype == torch.uint8
    np.testing.assert_array_equal(nn(nib), rnib)
    scale = np.abs(llrs).sum(axis=-1)
    assert np.all(np.abs(nn(margin) - rmargin) <= SCORE_RTOL * scale)
    assert np.all(nn(margin) >= 0.0)


@pytest.mark.parametrize("ppm,rdd", [(7, 1), (7, 4), (5, 2), (12, 3)])
def test_deinterleave_llrs_vs_jax(ppm, rdd):
    llrs = np.random.RandomState(ppm + rdd).randn(2, 3 * (4 + rdd) + 1, ppm).astype(np.float32)
    got = tsoft.deinterleave_llrs(tt(llrs), ppm, rdd)
    np.testing.assert_array_equal(nn(got), nn(jsoft.deinterleave_llrs(llrs, ppm, rdd)))


@pytest.mark.parametrize("cr", [1, 2, 3, 4])
@pytest.mark.parametrize("ldro", [False, True], ids=["noldro", "ldro"])
@pytest.mark.parametrize("snr_db", [None, -7.0], ids=["clean", "noisy"])
def test_decode_payload_soft_vs_jax(cr, ldro, snr_db):
    """Batched frames at SF8: payload bytes and crc_ok equal to JAX's,
    min_score within SCORE_RTOL; clean frames decode bit-exact."""
    p = LoraParams(sf=8)
    jc = jcoded.CodedConfig(sf=8, cr=cr, ldro=ldro)
    tc = tcoded.CodedConfig(sf=8, cr=cr, ldro=ldro)
    rng = np.random.RandomState(cr * 2 + ldro)
    payload = rng.randint(0, 256, (6, 16)).astype(np.uint8)
    mag2 = _spectra(nn(jcoded.encode_payload(payload, jc)), p, snr_db, seed=cr)
    got = tsoft.decode_payload_soft(tt(mag2), 16, tc)
    ref = [nn(a) for a in jsoft.decode_payload_soft(mag2, 16, jc)]
    np.testing.assert_array_equal(nn(got[0]), ref[0])
    np.testing.assert_array_equal(nn(got[1]), ref[1])
    np.testing.assert_allclose(nn(got[2]), ref[2], rtol=SCORE_RTOL, atol=0)
    if snr_db is None:
        np.testing.assert_array_equal(nn(got[0]), payload)
        assert bool(got[1].all()) and bool((got[2] > 0).all())


def test_decode_payload_soft_on_port_spectra():
    """The port's own chain (encode_payload -> modulate_planar ->
    dechirp_planar -> demodulate_spectrum_planar -> decode_payload_soft)
    gives JAX's bytes and crc_ok on the same noisy IQ."""
    p = LoraParams(sf=7)
    jc = jcoded.CodedConfig(sf=7, cr=1)
    tc = tcoded.CodedConfig(sf=7, cr=1)
    payload = np.random.RandomState(77).randint(0, 256, (8, 20)).astype(np.uint8)
    bins = nn(tcoded.encode_payload(tt(payload), tc))
    np.testing.assert_array_equal(bins, nn(jcoded.encode_payload(payload, jc)).astype(np.int32))
    xr, xi = _noisy_planes(bins, p, -8.0, seed=77)
    tp = tparams(p)
    mag2 = tplanar.demodulate_spectrum_planar(*tplanar.dechirp_planar(tt(xr), tt(xi), tp), tp)[0]
    got = tsoft.decode_payload_soft(mag2, 20, tc)
    dr, di = jplanar.dechirp_planar(xr, xi, p)
    ref = jsoft.decode_payload_soft(jplanar.demodulate_spectrum_planar(dr, di, p)[0], 20, jc)
    np.testing.assert_array_equal(nn(got[0]), nn(ref[0]))
    np.testing.assert_array_equal(nn(got[1]), nn(ref[1]))
    np.testing.assert_allclose(nn(got[2]), nn(ref[2]), rtol=SCORE_RTOL, atol=0)
    assert bool(got[1].any())


@pytest.mark.parametrize("scale,bw", [(1, Bandwidth.BW_125), (2, Bandwidth.BW_250),
                                      (4, Bandwidth.BW_500)])
def test_hamming84_ml_decode_vs_jax(scale, bw):
    """The simple chain's spectra at BW125/250/500 (bins alias by the
    chirp slope): bytes equal to JAX's, clean and noisy."""
    p = LoraParams(sf=7, bw=bw)
    assert int(p.scale) == scale
    payload = np.random.RandomState(scale).randint(0, 256, (4, 10)).astype(np.uint8)
    syms = nn(jmodem.encode(payload)).astype(np.int32)
    for snr_db in (None, -6.0):
        mag2 = _spectra(syms, p, snr_db, seed=scale)
        got = tsoft.hamming84_ml_decode(tt(mag2), scale)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (4, 10)
        np.testing.assert_array_equal(nn(got), nn(jsoft.hamming84_ml_decode(mag2, scale)))
        if snr_db is None:
            np.testing.assert_array_equal(nn(got), payload)
    odd = tsoft.hamming84_ml_decode(tt(mag2[:, :5]), scale)      # odd symbol count
    np.testing.assert_array_equal(nn(odd), nn(jsoft.hamming84_ml_decode(mag2[:, :5], scale)))
