"""Port parity: the estimate / compensate API and the complex detector
(lora_phy_tpu_torch ops/planar.py, ops/fft.py, ops/detect.py,
models/modem.py) and the impairment injectors (ops/impair.py) against
their JAX twins on the same numpy-seeded inputs and the golden fixtures.

Decisions (symbols, sync words, decoded bytes, the argmax bin) are
bit-equal. Float tolerances:

* cfo 1e-6 bins and time_offset 2e-3 samples from the same planes (as
  tests/test_torch_planar.py: float32 DFT sums in another order; the
  time offset scales the fractional bin by N*osr). The complex API
  (the port's planar DFT against JAX's FFT): cfo 1e-5, time_offset
  2e-4*step.
* compensated planes 1e-6: a rotation by cos / sin of the same float32
  phase (one ulp of each apart) and a zero-filled shift.
* the injectors 1e-6 (cos / sin of the same float32 phase; the linear
  interpolation of apply_sro is exact arithmetic on the same floats).
* the random draws (apply_awgn, rayleigh_taps) take a torch.Generator, not
  a JAX key, so they are held to statistics: noise power within 2 % of
  the nominal at 2**20 samples, tap powers to the profile within 10 %
  over 4000 draws.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_util import GOLDEN, golden_params, nn, tparams, tt
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.models import stream as jstream
from lora_phy_tpu.ops import detect as jdetect
from lora_phy_tpu.ops import fft as jfft
from lora_phy_tpu.ops import impair as jimpair
from lora_phy_tpu.ops import planar as jplanar
from lora_phy_tpu.utils.params import LoraParams
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.ops import detect as tdetect
from lora_phy_tpu_torch.ops import fft as tfft
from lora_phy_tpu_torch.ops import impair as timpair
from lora_phy_tpu_torch.ops import planar as tplanar

CFO_ATOL = 1e-6
TO_ATOL = 2e-3
PLANE_ATOL = 1e-6


def _golden_dechirped(path):
    g = np.load(path)
    p = golden_params(path.stem)
    xr, xi = jplanar.split_complex(g["iq"])
    dr, di = (np.asarray(a) for a in jplanar.dechirp_planar(xr, xi, p))
    return g, p, dr, di


def _dechirped(p, payload_len=16, seed=0):
    rng = np.random.RandomState(seed)
    payload = rng.randint(0, 256, payload_len).astype(np.uint8)
    iq = jmodem.modulate(jmodem.encode(payload), p)
    return payload, np.asarray(jmodem.dechirp(iq, p))


def _c(x):
    return torch.from_numpy(np.asarray(x).astype(np.complex64))


# ---------------------------------------------------------------------------
# ops/planar.py: estimate / compensate, the robust preamble estimator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_estimate_offsets_planar_golden(path):
    """The 2 sync symbols (phy.cpp:78-145, no index tie-break): cfo and
    time_offset within tolerance; at osr > 1 the osr-phase tie holds.
    Over the whole frame at osr 1, cfo too. (Over data symbols at osr > 1
    JAX's float32 powers break true osr-phase ties by rounding, so the
    pick there is rounding noise: ROADMAP.md Queue 3. The whole frame's
    time_offset is the fraction of a mean of up to N-sized bins times
    N*osr, float32 noise of order N*osr*1e-4.)"""
    g, p, dr, di = _golden_dechirped(path)
    tp = tparams(p)
    cut = 2 * p.step
    ref = [float(a) for a in jplanar.estimate_offsets_planar(dr[:cut], di[:cut], p)]
    got = [float(a) for a in tplanar.estimate_offsets_planar(tt(dr[:cut]), tt(di[:cut]), tp)]
    if path.stem == "sf7_bw250000_osr2_win0":
        # the clean sync tones tie across the two osr phases; JAX's jitted
        # estimate_offsets_planar breaks that tie in its float32 sums
        # (phase 1 of symbol 0 4.1e-6 dB up) and reads 0.1914 / 0.5, where
        # the reference (the golden) keeps it: the port keeps it here too.
        # The witness: in float64 the two phases' peaks agree to 1.4e-8
        # (below float32's half ulp) with phase 0 never the smaller, and
        # their dB values round to the same float32, so the reference's
        # ``p > best`` scan keeps phase 0 in both symbols
        assert (round(ref[0], 4), ref[1]) == (0.1914, 0.5)
        v = (dr[:cut].astype(np.float64) + 1j * di[:cut].astype(np.float64))
        peak = np.abs(np.fft.fft(v.reshape(2, p.n, p.osr).swapaxes(-1, -2))).max(-1)
        assert (np.abs(peak[:, 1] / peak[:, 0] - 1.0) < 3e-8).all()
        assert (peak[:, 0] >= peak[:, 1]).all()
        db = (20.0 * np.log10(peak)).astype(np.float32)
        assert (db[:, 0] == db[:, 1]).all()
        ref = [float(g["cfo"]), float(g["time_offset"])]
    assert abs(got[0] - ref[0]) <= CFO_ATOL, (got, ref)
    assert abs(got[1] - ref[1]) <= TO_ATOL, (got, ref)
    if p.osr == 1:
        ref = jplanar.estimate_offsets_planar(dr, di, p)
        got = tplanar.estimate_offsets_planar(tt(dr), tt(di), tp)
        assert abs(float(got[0]) - float(ref[0])) <= CFO_ATOL, (got, ref)


@pytest.mark.parametrize("path", [g for g in GOLDEN if "osr1" not in g.stem],
                         ids=lambda p: p.stem)
def test_tie_power_holds_jax_osr_phase_pick(path):
    """At osr > 1 the phase pick compares the powers of
    planar._tie_power_db: the same winning phases as JAX's float32 powers
    on every golden cell, and where JAX's powers tie they tie here."""
    _, p, dr, di = _golden_dechirped(path)
    n, step = p.n, p.step
    view = lambda a: a[: 2 * step].reshape(2, n, p.osr).swapaxes(-1, -2)
    jdet = jplanar.detect_planar(view(dr), view(di), n)
    jp = nn(jdet.power)
    tp = nn(tplanar._tie_power_db(tt(view(dr)), tt(view(di)), tt(nn(jdet.index)), n))
    np.testing.assert_array_equal(tp == tp.max(-1, keepdims=True),
                                  jp == jp.max(-1, keepdims=True))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)


def test_estimate_offsets_planar_golden_values():
    """The golden cell of the old osr-phase tie gives the golden cfo and
    time_offset (JAX's) through the port's demod."""
    path = [g for g in GOLDEN if g.stem == "sf7_bw250000_osr2_win0"][0]
    g, p, dr, di = _golden_dechirped(path)
    res = tplanar.demodulate_planar(tt(dr), tt(di), tparams(p))
    assert float(res.time_offset) == float(g["time_offset"]) == 0.0
    assert abs(float(res.cfo) - float(g["cfo"])) <= CFO_ATOL


@pytest.mark.parametrize("osr", [1, 2])
def test_compensate_offsets_planar_vs_jax(osr):
    """Per-row CFO and time offsets of both signs, a whole-batch scalar,
    an offset of the full length (no shift, as the reference) and a
    smaller offset batch that pairs per row."""
    p = LoraParams(sf=7, osr=osr)
    tp = tparams(p)
    rng = np.random.RandomState(osr)
    xr = rng.randn(3, 4, 600).astype(np.float32)
    xi = rng.randn(3, 4, 600).astype(np.float32)
    cases = [
        (np.float32(0.3), np.float32(5.0)),
        (rng.uniform(-2, 2, (3, 4)).astype(np.float32),
         np.array([[3.4, -7.5, 0.0, 600.0], [-600.0, 599.0, -2.5, 2.5],
                   [12.0, -12.49, 1.0, -1.0]], np.float32)),
        (rng.uniform(-1, 1, (4,)).astype(np.float32),
         np.array([2.0, -3.0, 0.6, -0.6], np.float32)),
    ]
    for cfo, to in cases:
        ref = jplanar.compensate_offsets_planar(xr, xi, p, cfo, to)
        got = tplanar.compensate_offsets_planar(tt(xr), tt(xi), tp, tt(cfo), tt(to))
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(nn(a), nn(b), rtol=0, atol=PLANE_ATOL)
            # zero fill lands on the same samples
            np.testing.assert_array_equal(nn(a) == 0, nn(b) == 0)


@pytest.mark.parametrize("osr,s", [(1, 8), (2, 8), (1, 1)])
def test_estimate_preamble_robust_planar_vs_jax(osr, s):
    """Common-bin CFO (and the accumulated spectrum) from preamble windows
    at fractional CFOs under a two-ray echo, and from one window."""
    p = LoraParams(sf=7, osr=osr, sync_word=0)
    rng = np.random.RandomState(10 + osr + s)
    re, im = jplanar.modulate_planar(np.zeros((3, max(s - 2, 0)), np.int32), p)
    x = (np.asarray(re) + 1j * np.asarray(im))[..., : s * p.step]
    t = np.arange(x.shape[-1])
    x = x * np.exp(2j * np.pi * np.array([0.3, -1.45, 2.2])[:, None] * t / p.step)
    x = x + 0.9 * np.exp(1.3j) * np.roll(x, 3, axis=-1)
    x = (x + 0.05 * (rng.randn(*x.shape) + 1j * rng.randn(*x.shape))).astype(np.complex64)
    dr, di = (np.asarray(a) for a in jplanar.dechirp_planar(*jplanar.split_complex(x), p))
    pps = jplanar._preamble_phase_step(p.sf, p.osr, p.scale)
    ref_cfo, ref_acc = jplanar.estimate_preamble_robust_planar(
        dr, di, p.n, osr, phase_step=pps, return_acc=True)
    got_cfo, got_acc = tplanar.estimate_preamble_robust_planar(
        tt(dr), tt(di), p.n, osr, phase_step=pps, return_acc=True)
    np.testing.assert_allclose(nn(got_cfo), nn(ref_cfo), rtol=0, atol=CFO_ATOL)
    np.testing.assert_array_equal(nn(got_acc).argmax(-1), nn(ref_acc).argmax(-1))
    peak = nn(ref_acc).max(-1, keepdims=True)
    assert (np.abs(nn(got_acc) - nn(ref_acc)) <= 2e-5 * peak).all()
    only = tplanar.estimate_preamble_robust_planar(tt(dr), tt(di), p.n, osr,
                                                   phase_step=pps)
    np.testing.assert_array_equal(nn(only), nn(got_cfo))


# ---------------------------------------------------------------------------
# ops/fft.py and ops/detect.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "dft", "auto"])
@pytest.mark.parametrize("n", [16, 128, 512, 4096])
def test_fft_backends_vs_jax(n, backend):
    """Both backends against JAX's on the same complex64 rows: float32
    sums of n terms in another order, held to 2e-5*sqrt(n)*8 of a
    unit-variance input's spectrum (as test_torch_planar's DFT case)."""
    rng = np.random.RandomState(n)
    x = (rng.randn(3, n) + 1j * rng.randn(3, n)).astype(np.complex64)
    ref = np.asarray(jfft.fft(x, backend="dft" if backend == "dft" else "xla"))
    got = nn(tfft.fft(_c(x), backend=backend))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * np.sqrt(n) * 8)
    with pytest.raises(ValueError, match="backend"):
        tfft.fft(_c(x), backend="nope")


@pytest.mark.parametrize("backend", ["xla", "dft"])
def test_detect_vs_jax(backend):
    rng = np.random.RandomState(3)
    for n in (128, 1024):
        x = (rng.randn(5, n) + 1j * rng.randn(5, n)).astype(np.complex64)
        x[0] = np.exp(2j * np.pi * 17.3 * np.arange(n) / n)      # a tone
        ref = jdetect.detect(x, backend=backend)
        got = tdetect.detect(_c(x), backend=backend)
        np.testing.assert_array_equal(nn(got.index), nn(ref.index))
        for f in ("power", "power_avg", "findex"):
            np.testing.assert_allclose(nn(getattr(got, f)), nn(getattr(ref, f)),
                                       rtol=1e-4, atol=1e-4, err_msg=f)
        np.testing.assert_allclose(nn(got.peak_bin), nn(ref.peak_bin),
                                   rtol=1e-4, atol=2e-3)


# ---------------------------------------------------------------------------
# models/modem.py: the complex demodulators and the offsets API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "auto", "dft"])
@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_demodulate_backend(path, backend):
    """The complex demodulator (a wrapper over the planar pipeline, whose
    DFT is JAX's ``dft`` formulation) under each of JAX's backend names
    gives the golden decisions and that JAX backend's offsets; an unknown
    name is refused."""
    g, p, dr, di = _golden_dechirped(path)
    dech = (dr + 1j * di).astype(np.complex64)
    ref = jmodem.demodulate(dech, p, backend=backend)
    got = tmodem.demodulate(_c(dech), tparams(p), backend=backend)
    with pytest.raises(ValueError, match="backend"):
        tmodem.demodulate(_c(dech), tparams(p), backend="cufft")
    np.testing.assert_array_equal(nn(got.symbols), g["demod"].astype(np.int32))
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
    assert int(got.sync_word) == int(ref.sync_word) == int(g["sync"])
    np.testing.assert_allclose(float(got.cfo), float(ref.cfo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got.time_offset), float(ref.time_offset),
                               rtol=0, atol=2e-4 * p.step)
    np.testing.assert_array_equal(nn(tmodem.decode(got.symbols)), g["decoded"])


@pytest.mark.parametrize("sf,osr", [(7, 1), (8, 2), (9, 1)])
def test_demodulate_integrated_vs_jax(sf, osr):
    """Raw chirped IQ through the integrated path round-trips with JAX's
    decisions and offsets."""
    p = LoraParams(sf=sf, osr=osr)
    payload = np.random.RandomState(sf).randint(0, 256, 12).astype(np.uint8)
    iq = np.asarray(jmodem.modulate(jmodem.encode(payload), p))
    ref = jmodem.demodulate_integrated(iq, p)
    got = tmodem.demodulate_integrated(_c(iq), tparams(p))
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
    assert int(got.sync_word) == int(ref.sync_word) == 0x12
    np.testing.assert_array_equal(nn(tmodem.decode(got.symbols)), payload)
    np.testing.assert_allclose(float(got.cfo), float(ref.cfo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got.time_offset), float(ref.time_offset),
                               rtol=0, atol=2e-4 * p.step)


@pytest.mark.parametrize("backend", ["xla", "auto", "dft"])
def test_demodulate_integrated_quirk_compat(backend):
    """quirk_compat=True estimates on the raw sync chirps, as the
    reference: a bogus CFO and corrupted decisions (tests/test_e2e.py's
    gate). A raw chirp's spectrum is flat, so its argmax is a float
    near-tie that JAX's own two backends break differently (deadbeef at
    SF7: cfo 0.601 with ``xla``, 0.674 with ``dft``). The port's DFT is
    the ``dft`` formulation, so under that name it gives JAX's ``dft``
    values: cfo, time_offset and the corrupted payload 7c475cce."""
    p = LoraParams(sf=7)
    payload = np.frombuffer(bytes.fromhex("deadbeef"), dtype=np.uint8)
    iq = np.asarray(jmodem.modulate(jmodem.encode(payload), p))
    res = tmodem.demodulate_integrated(_c(iq), tparams(p), backend=backend,
                                       quirk_compat=True)
    assert abs(float(res.cfo)) > 0.2
    assert not np.array_equal(nn(tmodem.decode(res.symbols)), payload)
    if backend == "dft":
        ref = jmodem.demodulate_integrated(iq, p, backend="dft", quirk_compat=True)
        np.testing.assert_allclose(float(res.cfo), float(ref.cfo), rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(res.cfo), 0.674, atol=1e-3)
        np.testing.assert_allclose(float(res.time_offset), float(ref.time_offset),
                                   rtol=0, atol=2e-4 * p.step)
        np.testing.assert_array_equal(nn(res.symbols), nn(ref.symbols).astype(np.int32))
        assert bytes(nn(tmodem.decode(res.symbols))).hex() == "7c475cce"


def test_estimate_offsets_clean_and_backends():
    """tests/test_offsets.py's clean case: cfo ~0.0903 on the clean sync
    pair, equal to JAX's through both of its backends under each of the
    port's names; an unknown name is refused."""
    p = LoraParams(sf=7)
    _, dech = _dechirped(p)
    with pytest.raises(ValueError, match="backend"):
        tmodem.estimate_offsets(_c(dech[: 2 * p.step]), tparams(p), backend="cufft")
    for jb, backend in (("xla", "xla"), ("dft", "auto"), ("dft", "dft")):
        ref = jmodem.estimate_offsets(dech[: 2 * p.step], p, backend=jb)
        got = tmodem.estimate_offsets(_c(dech[: 2 * p.step]), tparams(p), backend=backend)
        np.testing.assert_allclose(float(got[0]), 0.0903, atol=5e-3)
        np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=0, atol=TO_ATOL)


@pytest.mark.parametrize("cfo_frac", [-0.3, 0.2])
def test_cfo_estimate_compensate_loop_vs_jax(cfo_frac):
    """tests/test_offsets.py's closed loop through the port: estimate ->
    compensate -> the residual returns toward the clean baseline, and the
    rotated stream decodes; every step within tolerance of JAX."""
    p = LoraParams(sf=7)
    tp = tparams(p)
    payload, dech = _dechirped(p)
    rotated = np.asarray(jimpair.apply_cfo_continuous(dech, cfo_frac, p.n, p.osr))
    trot = timpair.apply_cfo_continuous(_c(dech), cfo_frac, p.n, p.osr)
    np.testing.assert_allclose(nn(trot), rotated, rtol=0, atol=PLANE_ATOL)
    base, _ = tmodem.estimate_offsets(_c(dech[: 2 * p.step]), tp)
    cfo, to = tmodem.estimate_offsets(_c(rotated[: 2 * p.step]), tp)
    jcfo, jto = jmodem.estimate_offsets(rotated[: 2 * p.step], p)
    assert abs(float(cfo) - float(jcfo)) <= 1e-5
    fixed = tmodem.compensate_offsets(_c(rotated), tp, cfo - base, to)
    jfixed = np.asarray(jmodem.compensate_offsets(rotated, p, float(cfo - base), float(to)))
    np.testing.assert_allclose(nn(fixed), jfixed, rtol=0, atol=1e-5)
    resid, _ = tmodem.estimate_offsets(fixed[: 2 * p.step], tp)
    assert abs(float(resid) - float(base)) <= abs(float(cfo) - float(base)) + 0.3 / p.n
    out = tmodem.decode(tmodem.demodulate(_c(rotated), tp).symbols)
    np.testing.assert_array_equal(nn(out), payload)


@pytest.mark.parametrize("shift", [-3, 2, 6])
def test_compensate_inverts_time_shift_vs_jax(shift):
    p = LoraParams(sf=7)
    _, dech = _dechirped(p)
    shifted = np.asarray(jimpair.apply_time_shift(dech, shift))
    tshift = timpair.apply_time_shift(_c(dech), shift)
    np.testing.assert_array_equal(nn(tshift), shifted)
    fixed = tmodem.compensate_offsets(tshift, tparams(p), 0.0, float(shift))
    np.testing.assert_allclose(nn(fixed)[8:-8], dech[8:-8], atol=1e-6)
    ref = np.asarray(jmodem.compensate_offsets(shifted, p, 0.0, float(shift)))
    np.testing.assert_allclose(nn(fixed), ref, rtol=0, atol=PLANE_ATOL)


@pytest.mark.parametrize("sf,osr,cont,ppm", [(9, 2, True, 30.0), (9, 2, False, 30.0),
                                             (9, 1, True, 60.0)])
def test_estimate_sro_complex_vs_jax(sf, osr, cont, ppm):
    p = LoraParams(sf=sf, osr=osr, continuous_chirp=cont)
    payload = np.random.RandomState(3).randint(0, 256, 16).astype(np.uint8)
    iq = np.asarray(jmodem.modulate(jmodem.encode(payload), p))
    drifted = np.asarray(jimpair.apply_sro(iq, ppm))
    tdrift = timpair.apply_sro(_c(iq), ppm)
    np.testing.assert_allclose(nn(tdrift), drifted, rtol=0, atol=PLANE_ATOL)
    dech = np.asarray(jmodem.dechirp(drifted, p))
    ref = float(jmodem.estimate_sro(dech, p))
    got = float(tmodem.estimate_sro(_c(dech), tparams(p)))
    assert abs(got - ppm) < 0.15 * abs(ppm)
    assert abs(got - ref) <= 0.05


# ---------------------------------------------------------------------------
# ops/impair.py
# ---------------------------------------------------------------------------

def test_injectors_vs_jax():
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 3000) + 1j * rng.randn(2, 3000)).astype(np.complex64)
    cfo = np.array([1.5, -0.7], np.float32)
    for name, args in (("apply_cfo", (cfo, 128, 2)), ("apply_cfo_continuous", (cfo, 128, 2))):
        ref = np.asarray(getattr(jimpair, name)(x, *args))
        got = nn(getattr(timpair, name)(_c(x), tt(args[0]), *args[1:]))
        np.testing.assert_allclose(got, ref, rtol=0, atol=PLANE_ATOL, err_msg=name)
    for shift in (-5, 0, 7, 3000, -3001):
        np.testing.assert_array_equal(nn(timpair.apply_time_shift(_c(x), shift)),
                                      np.asarray(jimpair.apply_time_shift(x, shift)))
    for ppm in (0.0, 40.0, -25.0):
        np.testing.assert_allclose(nn(timpair.apply_sro(_c(x), ppm)),
                                   np.asarray(jimpair.apply_sro(x, ppm)),
                                   rtol=0, atol=PLANE_ATOL)
        np.testing.assert_allclose(nn(timpair.compensate_sro(_c(x), ppm)),
                                   np.asarray(jimpair.compensate_sro(x, ppm)),
                                   rtol=0, atol=PLANE_ATOL)
    # identity resampling keeps the last sample, real planes too
    np.testing.assert_array_equal(nn(timpair.apply_sro(_c(x), 0.0)), x)
    np.testing.assert_array_equal(nn(timpair.apply_sro(tt(x.real.copy()), 0.0)), x.real)
    taps = np.array([0.8, 0, 0.4 - 0.3j, 0.1j], np.complex64)
    ref = np.asarray(jimpair.apply_multipath(x, taps))
    np.testing.assert_allclose(nn(timpair.apply_multipath(_c(x), taps)), ref,
                               rtol=0, atol=PLANE_ATOL)
    yr, yi = timpair.apply_multipath_planar(tt(x.real.copy()), tt(x.imag.copy()),
                                            taps.real, taps.imag)
    jr, ji = jimpair.apply_multipath_planar(x.real, x.imag, taps.real, taps.imag)
    np.testing.assert_allclose(nn(yr), np.asarray(jr), rtol=0, atol=PLANE_ATOL)
    np.testing.assert_allclose(nn(yi), np.asarray(ji), rtol=0, atol=PLANE_ATOL)
    np.testing.assert_allclose(nn(yr)[:, 0], 0.8 * x.real[:, 0], atol=1e-6)
    kw = {"dc": 0.08 - 0.05j, "gain_imbalance": 1.25, "phase_skew_deg": 8.0}
    np.testing.assert_allclose(nn(timpair.apply_frontend(_c(x), **kw)),
                               np.asarray(jimpair.apply_frontend(x, **kw)),
                               rtol=0, atol=PLANE_ATOL)


def test_frontend_estimate_compensate_vs_jax():
    """tests/test_offsets.py's front-end loop: blind estimate within its
    gates of the injected defect and within 1e-5 of JAX's statistics;
    the compensated planes within 1e-5 of JAX's; a quiet row returns the
    identity (the guard)."""
    p = LoraParams(sf=7)
    pl = np.random.RandomState(8).randint(0, 256, 8).astype(np.uint8)
    s = np.asarray(jstream.frame_modulate(np.asarray(jmodem.encode(pl), np.int32), p))
    bad = np.asarray(jimpair.apply_frontend(s, dc=0.08 - 0.05j, gain_imbalance=1.25,
                                            phase_skew_deg=8.0))
    re = np.stack([bad.real, np.zeros_like(bad.real)]).astype(np.float32)
    im = np.stack([bad.imag, 1e-6 * np.ones_like(bad.imag)]).astype(np.float32)
    ref = [np.asarray(a) for a in jimpair.estimate_frontend_planar(re, im)]
    got = [nn(a) for a in timpair.estimate_frontend_planar(tt(re), tt(im))]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    dc_i, dc_q, g, sin_phi = (a[0] for a in got)
    assert abs(g - 1.25) < 0.01 and abs(sin_phi - np.sin(np.radians(8.0))) < 0.01
    assert abs(dc_i - 0.08) < 0.03 and abs(dc_q + 0.05) < 0.03
    assert [a[1] for a in got] == [0.0, 0.0, 1.0, 0.0]           # quiet row
    cr, ci = timpair.compensate_frontend_planar(tt(re), tt(im), *(tt(a) for a in got))
    jr, ji = jimpair.compensate_frontend_planar(re, im, *ref)
    np.testing.assert_allclose(nn(cr), np.asarray(jr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(nn(ci), np.asarray(ji), rtol=0, atol=1e-5)
    assert max(np.abs(nn(cr)[0] - s.real).max(), np.abs(nn(ci)[0] - s.imag).max()) < 0.05


def test_apply_awgn_statistics():
    """Noise power within 2 % of sigma**2 at 2**20 samples, per-row SNR,
    each component half of it, and a seeded generator repeats."""
    x = torch.zeros(2, 1 << 20, dtype=torch.complex64)
    snr = torch.tensor([0.0, 10.0])
    y = timpair.apply_awgn(torch.Generator().manual_seed(1), x, snr)
    power = (y.abs() ** 2).mean(-1).double()
    nominal = 10.0 ** (-snr.double() / 10.0)
    assert (abs(power / nominal - 1.0) < 0.02).all(), power
    re_share = (y.real ** 2).mean(-1).double() / power
    assert (abs(re_share - 0.5) < 0.01).all()
    again = timpair.apply_awgn(torch.Generator().manual_seed(1), x, snr)
    assert torch.equal(y, again)


def test_add_awgn_draws_on_jax_draws():
    """apply_awgn's noise from given unit normal planes: fed the two draws
    JAX's apply_awgn splits from its key, the noisy samples are JAX's
    (per-row SNR too); apply_awgn is the same function on its generator's
    draws."""
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    x = (rng.randn(2, 4096) + 1j * rng.randn(2, 4096)).astype(np.complex64)
    snr = np.array([-6.0, 9.0], np.float32)
    key = jax.random.PRNGKey(11)
    kr, ki = jax.random.split(key)
    nr = np.array(jax.random.normal(kr, x.shape, jnp.float32))
    ni = np.array(jax.random.normal(ki, x.shape, jnp.float32))
    want = np.asarray(jimpair.apply_awgn(key, x, snr))
    got = timpair.add_awgn_draws(tt(x), nr, ni, tt(snr))
    np.testing.assert_array_equal(nn(got), want)
    gen = torch.Generator().manual_seed(3)
    draws = (torch.randn(x.shape, generator=gen), torch.randn(x.shape, generator=gen))
    y = timpair.apply_awgn(torch.Generator().manual_seed(3), tt(x), tt(snr))
    assert torch.equal(y, timpair.add_awgn_draws(tt(x), *draws, tt(snr)))


def test_rayleigh_taps_statistics():
    """Dense taps on the delays only, unit total power on average, each
    tap's mean power its profile share within 10 % over 4000 draws."""
    gen = torch.Generator().manual_seed(7)
    delays, pdp = (0, 1, 3, 6), (0.0, -3.0, -6.0, -9.0)
    taps = torch.stack([timpair.rayleigh_taps(gen, delays, pdp) for _ in range(4000)])
    assert taps.shape == (4000, 7) and taps.dtype == torch.complex64
    assert (taps[:, [2, 4, 5]] == 0).all()
    share = 10.0 ** (np.array(pdp) / 10.0)
    share /= share.sum()
    power = nn((taps.abs() ** 2).mean(0).double())[list(delays)]
    np.testing.assert_allclose(power, share, rtol=0.1)
    jtaps = np.asarray(jimpair.rayleigh_taps(jax.random.PRNGKey(0), delays, pdp))
    assert jtaps.shape == (7,) and (jtaps[[2, 4, 5]] == 0).all()


def test_multipath_channel_decodes_vs_jax():
    """tests/test_offsets.py's two-ray case (-6 dB echo, 3 samples): the
    block receiver decodes it and gives JAX's decisions."""
    from lora_phy_tpu.models import sync as jsync
    from lora_phy_tpu_torch.models import sync as tsync

    p = LoraParams(sf=7)
    payload = np.random.RandomState(6).randint(0, 256, 16).astype(np.uint8)
    frame = np.asarray(jstream.frame_modulate(np.asarray(jmodem.encode(payload), np.int32), p))
    sig = np.zeros(frame.size + 6 * p.step, np.complex64)
    sig[2 * p.step: 2 * p.step + frame.size] = frame
    taps = np.array([1.0, 0, 0, 0.5 * np.exp(1j * 2.1)], np.complex64)
    y = nn(timpair.apply_multipath(_c(sig), taps))
    re, im = jplanar.split_complex(y)
    ref = jsync.receive_block_planar(re, im, p, 32)
    got = tsync.receive_block_planar(tt(re), tt(im), tparams(p), 32)
    np.testing.assert_array_equal(nn(got.found), nn(ref.found))
    k = int(np.flatnonzero(nn(got.found))[0])
    np.testing.assert_array_equal(nn(tmodem.decode(got.symbols[k])), payload)
