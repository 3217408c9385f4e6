"""Port parity of the reduced-precision decision path: ``mxu_dtype=`` on
the DFT functions and ``precision="bf16"`` on the demodulators of
lora_phy_tpu_torch.ops.planar, and the plain version of the bf16
decision kernel (lora_phy_tpu_torch.ops.bf16_decide), against
lora_phy_tpu.ops.planar with ``mxu_dtype=jnp.bfloat16`` on the CPU.

Both packages round the same float32 operands to bf16 (round to nearest
even) and multiply exactly; only the order of the float32 sums differs.
Decisions are bit-equal. Floats are held to:

* 1e-6 of the spectrum's peak for N <= 1024 (float32 sums of up to 2N
  exact products in another order);
* 2e-4 of the peak above (the four-step's stage-1 sums feed a second bf16
  rounding: a sum-order difference of one float32 ulp can move a stage-2
  operand by one bf16 step, 2^-8 relative; measured 1.4e-5 at N = 4096).

The front of the demodulators stays float32, so cfo / time_offset carry
the float32 path's tolerances. The CUDA kernel itself is checked against
its plain version on the card (``gpu``-marked test; ``chip_smoke.py``
phase 19).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_util import GOLDEN, cuda_device, golden_params, nn, tparams, tt
from lora_phy_tpu.models import modem as jmodem
from lora_phy_tpu.ops import planar as jplanar
from lora_phy_tpu.utils.params import LoraParams, Window
from lora_phy_tpu_torch.models import modem as tmodem
from lora_phy_tpu_torch.ops import bf16_decide as tbf16
from lora_phy_tpu_torch.ops import fft as tfft
from lora_phy_tpu_torch.ops import planar as tplanar

BF16 = torch.bfloat16
CFO_ATOL = 1e-6
TO_ATOL = 2e-3
SIZES = [4, 16, 64, 128, 256, 512, 1024, 2048, 4096]


def spectrum_rtol(n: int) -> float:
    """Float tolerance relative to the peak (module docstring)."""
    return 1e-6 if n <= 1024 else 2e-4


def _rows(n, b, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n).astype(np.float32), rng.randn(b, n).astype(np.float32))


@pytest.mark.parametrize("n", SIZES)
def test_mxu_dtype_knobs_vs_jax(n):
    """dft_planar, dft_mag2_planar, argmax_bins_planar (with and without
    the peak) and detect_planar at mxu_dtype=bf16 against JAX's
    mxu_dtype=jnp.bfloat16: decisions equal, floats within spectrum_rtol
    of the peak (amplitudes of the peak amplitude)."""
    xr, xi = _rows(n, 6, n)
    jb = jnp.bfloat16
    rmag = np.asarray(jplanar.dft_mag2_planar(xr, xi, n, mxu_dtype=jb))
    mag = nn(tplanar.dft_mag2_planar(tt(xr), tt(xi), n, mxu_dtype=BF16))
    peak = rmag.max()
    tol = spectrum_rtol(n)
    assert np.abs(mag - rmag).max() <= tol * peak

    rr, ri = jplanar.dft_planar(xr, xi, n, mxu_dtype=jb)
    gr, gi = tplanar.dft_planar(tt(xr), tt(xi), n, mxu_dtype=BF16)
    amp = np.sqrt(peak)
    assert np.abs(nn(gr) - np.asarray(rr)).max() <= tol * amp
    assert np.abs(nn(gi) - np.asarray(ri)).max() <= tol * amp

    ref_bins = np.asarray(jplanar.argmax_bins_planar(xr, xi, n, mxu_dtype=jb))
    got_bins = tplanar.argmax_bins_planar(tt(xr), tt(xi), n, mxu_dtype=BF16)
    assert got_bins.dtype == torch.int32
    np.testing.assert_array_equal(nn(got_bins), ref_bins)
    rb, rp = jplanar.argmax_bins_planar(xr, xi, n, mxu_dtype=jb, with_peak=True)
    gb, gp = tplanar.argmax_bins_planar(tt(xr), tt(xi), n, mxu_dtype=BF16, with_peak=True)
    np.testing.assert_array_equal(nn(gb), np.asarray(rb))
    assert np.abs(nn(gp) - np.asarray(rp)).max() <= tol * peak
    np.testing.assert_array_equal(ref_bins, rmag.argmax(-1))

    rd = jplanar.detect_planar(xr, xi, n, mxu_dtype=jb)
    gd = tplanar.detect_planar(tt(xr), tt(xi), n, mxu_dtype=BF16)
    np.testing.assert_array_equal(nn(gd.index), np.asarray(rd.index))
    for f in ("peak_re", "peak_im"):
        assert np.abs(nn(getattr(gd, f)) - np.asarray(getattr(rd, f))).max() <= tol * amp, f
    # powers in dB: a relative error e of |.|^2 moves 10*log10 by 4.35*e
    for f in ("power", "power_avg"):
        np.testing.assert_allclose(nn(getattr(gd, f)), np.asarray(getattr(rd, f)),
                                   rtol=0, atol=5.0 * tol * n, err_msg=f)


def _noisy(p, snr_db, batch, payload_len, seed):
    """Dechirped frames of random payloads, plus numpy AWGN at ``snr_db``
    per sample (None: clean)."""
    rng = np.random.RandomState(seed)
    payloads = rng.randint(0, 256, (batch, payload_len)).astype(np.uint8)
    dech = np.asarray(jmodem.dechirp(jmodem.modulate(jmodem.encode(payloads), p), p))
    if snr_db is not None:
        sigma = np.sqrt(0.5 * 10.0 ** (-snr_db / 10.0))
        dech = dech + sigma * (rng.randn(*dech.shape) + 1j * rng.randn(*dech.shape))
    xr, xi = jplanar.split_complex(dech.astype(np.complex64))
    return payloads, xr, xi


DEMOD_CASES = [(7, None), (7, -3.0), (12, None), (12, -15.0)]


@pytest.mark.parametrize("sf,snr_db", DEMOD_CASES)
def test_demodulate_planar_bf16_vs_jax(sf, snr_db):
    """precision='bf16' end to end at SF7 and SF12 (osr 1), clean loopback
    and under numpy AWGN: symbols and sync equal to JAX's, the payloads
    decoded; cfo / time_offset within the float32 tolerances, and equal
    to the port's own float32 run (the front stays float32)."""
    p = LoraParams(sf=sf)
    tp = tparams(p)
    payloads, xr, xi = _noisy(p, snr_db, batch=3, payload_len=6, seed=sf)
    ref = jplanar.demodulate_planar(xr, xi, p, precision="bf16")
    got = tplanar.demodulate_planar(tt(xr), tt(xi), tp, precision="bf16")
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
    np.testing.assert_array_equal(nn(got.sync_word), nn(ref.sync_word))
    np.testing.assert_array_equal(nn(tmodem.decode(got.symbols)), payloads)
    np.testing.assert_allclose(nn(got.cfo), nn(ref.cfo), rtol=0, atol=CFO_ATOL)
    np.testing.assert_allclose(nn(got.time_offset), nn(ref.time_offset), rtol=0, atol=TO_ATOL)
    f32 = tplanar.demodulate_planar(tt(xr), tt(xi), tp)
    torch.testing.assert_close(got.cfo, f32.cfo, rtol=0, atol=0)
    torch.testing.assert_close(got.time_offset, f32.time_offset, rtol=0, atol=0)


def _pack_symbols(payloads, sf):
    """[..., B] uint8 payloads -> [..., ceil(8B / sf)] int32 symbols of sf
    bits each, the payload's bits LSB first, zero-padded (numpy, as
    chip_smoke.pack_symbols packs them)."""
    bits = ((payloads[..., None] >> np.arange(8)) & 1).reshape(*payloads.shape[:-1], -1)
    pad = -bits.shape[-1] % sf
    bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    bits = bits.reshape(*bits.shape[:-1], -1, sf)
    return (bits << np.arange(sf)).sum(-1).astype(np.int32)


# SF4-6 carry packed symbols: modem.encode's 8-bit codewords do not
# round-trip at SF5 in either package (ROADMAP Queue 3); SF4 takes known
# zero offsets, since the estimator reads the wrapped sync word at N < 32
# as an offset in both packages
PACKED_CASES = [(4, None), (4, -3.0), (5, None), (5, -3.0), (6, None), (6, -3.0)]


@pytest.mark.parametrize("sf,snr_db", PACKED_CASES)
def test_demodulate_planar_bf16_packed_vs_jax(sf, snr_db):
    """precision='bf16' at SF4-6 on payloads packed into SF-bit symbols,
    with the estimator at SF5 and SF6 and known zero offsets (given to
    both packages) at SF4, clean and under numpy AWGN: symbols and sync
    equal to JAX's, cfo / time_offset within the float32 tolerances; the
    clean loopback returns the sent symbols and sync 0x12."""
    p = LoraParams(sf=sf)
    tp = tparams(p)
    rng = np.random.RandomState(50 + sf)
    payloads = rng.randint(0, 256, (3, 6)).astype(np.uint8)
    syms = _pack_symbols(payloads, sf)
    dech = np.asarray(jmodem.dechirp(jmodem.modulate(syms, p), p))
    if snr_db is not None:
        sigma = np.sqrt(0.5 * 10.0 ** (-snr_db / 10.0))
        dech = dech + sigma * (rng.randn(*dech.shape) + 1j * rng.randn(*dech.shape))
    xr, xi = jplanar.split_complex(dech.astype(np.complex64))
    zero = np.zeros(3, np.float32)
    known = (zero, zero) if sf == 4 else None
    ref = jplanar.demodulate_planar(xr, xi, p, precision="bf16", known_offsets=known)
    got = tplanar.demodulate_planar(tt(xr), tt(xi), tp, precision="bf16", known_offsets=(
        None if known is None else (tt(zero), tt(zero))))
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
    np.testing.assert_array_equal(nn(got.sync_word), nn(ref.sync_word))
    np.testing.assert_allclose(nn(got.cfo), nn(ref.cfo), rtol=0, atol=CFO_ATOL)
    np.testing.assert_allclose(nn(got.time_offset), nn(ref.time_offset), rtol=0, atol=TO_ATOL)
    if snr_db is None:
        np.testing.assert_array_equal(nn(got.symbols), syms)
        assert (nn(got.sync_word) == 0x12).all()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_sf5_modem_encode_does_not_round_trip_in_either_package(precision):
    """A limit of the reference that the port mirrors (ROADMAP Queue 3):
    modem.encode's Hamming(8,4) codewords have 8 bits, more than an SF5
    symbol carries, so a clean SF5 loopback of 3 x 6 bytes (known zero
    offsets) decodes some bytes wrong in both packages, the same symbols
    and the same bytes. Payloads that must come back at SF5 are packed
    into 5-bit symbols (test_demodulate_planar_bf16_packed_vs_jax)."""
    p = LoraParams(sf=5)
    payloads, xr, xi = _noisy(p, None, batch=3, payload_len=6, seed=5)
    zero = np.zeros(3, np.float32)
    ref = jplanar.demodulate_planar(xr, xi, p, precision=precision, known_offsets=(zero, zero))
    got = tplanar.demodulate_planar(tt(xr), tt(xi), tparams(p), precision=precision,
                                    known_offsets=(tt(zero), tt(zero)))
    np.testing.assert_array_equal(nn(got.symbols), nn(ref.symbols).astype(np.int32))
    jbytes = np.asarray(jmodem.decode(ref.symbols))
    tbytes = nn(tmodem.decode(got.symbols))
    np.testing.assert_array_equal(tbytes, jbytes)
    assert (tbytes != payloads).sum() == 2


@pytest.mark.parametrize("sf,snr_db", DEMOD_CASES)
def test_demodulate_spectrum_planar_bf16_vs_jax(sf, snr_db):
    """The spectrum demod at precision='bf16': spectra within
    spectrum_rtol of the peak, their argmax and the sync word equal."""
    p = LoraParams(sf=sf)
    tp = tparams(p)
    _, xr, xi = _noisy(p, snr_db, batch=2, payload_len=4, seed=sf + 1)
    ref = jplanar.demodulate_spectrum_planar(xr, xi, p, precision="bf16")
    got = tplanar.demodulate_spectrum_planar(tt(xr), tt(xi), tp, precision="bf16")
    mag, rmag = nn(got[0]), nn(ref[0])
    assert mag.shape == rmag.shape
    np.testing.assert_array_equal(mag.argmax(-1), rmag.argmax(-1))
    np.testing.assert_array_equal(nn(got[1]), nn(ref[1]))
    assert np.abs(mag - rmag).max() <= spectrum_rtol(p.n) * rmag.max()
    np.testing.assert_allclose(nn(got[2]), nn(ref[2]), rtol=0, atol=CFO_ATOL)
    np.testing.assert_allclose(nn(got[3]), nn(ref[3]), rtol=0, atol=TO_ATOL)


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_demodulate_bf16(path):
    """Every golden cell (SF7-12, BW, osr, window) through
    demodulate_planar(precision='bf16'): the golden decisions, sync word
    and bytes (JAX's bf16 path gives them too)."""
    g = np.load(path)
    p = golden_params(path.stem)
    xr, xi = jplanar.split_complex(g["iq"])
    tdr, tdi = tplanar.dechirp_planar(tt(xr), tt(xi), tparams(p))
    res = tplanar.demodulate_planar(tdr, tdi, tparams(p), precision="bf16")
    np.testing.assert_array_equal(nn(res.symbols), g["demod"].astype(np.int32))
    assert int(res.sync_word) == int(g["sync"])
    np.testing.assert_array_equal(nn(tmodem.decode(res.symbols)), g["decoded"])


def _rotation_case(p, rows_per_rot, b, seed):
    """Dechirped symbol windows [b * rows_per_rot, N] at per-sample SNR
    0 dB with a per-frame CFO of up to half a bin, and the per-frame rate,
    scale and rotation planes of both packages."""
    n = p.n
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, n, (b, rows_per_rot))
    cfo = rng.uniform(-0.5, 0.5, (b, 1, 1))
    k = np.arange(n)
    tone = np.exp(2j * np.pi * (bins[..., None] + cfo) * k / n)
    noise = (rng.randn(b, rows_per_rot, n) + 1j * rng.randn(b, rows_per_rot, n)) * np.sqrt(0.5)
    y = (2.0 * tone + noise).astype(np.complex64)
    yr, yi = jplanar.split_complex(y)
    rate = (-2 * np.pi * rng.uniform(-0.5, 0.5, b) / n).astype(np.float32)
    scale = rng.uniform(0.3, 1.0, b).astype(np.float32)
    return yr, yi, rate, scale


@pytest.mark.parametrize("window", [Window.NONE, Window.HANN], ids=["none", "hann"])
@pytest.mark.parametrize("sf", [2, 5, 7, 8, 10, 12])
def test_bf16_decide_reference_vs_jax(sf, window):
    """The kernel's plain version, with the rotation planes (scale and
    window folded in) and without, against JAX's argmax_bins_planar at
    mxu_dtype=bf16 after JAX's own derotation: equal bins, peaks within
    spectrum_rtol; through demodulate_planar's rotation planes too."""
    p = LoraParams(sf=sf, window=window)
    tp = tparams(p)
    n, s, b = p.n, 5, 3
    yr, yi, rate, scale = _rotation_case(p, s, b, seed=sf)
    t_off = np.zeros(b, np.int32)
    fr, fi = jplanar._rotated_windows_planar(yr, yi, rate, t_off, scale, p)
    ref, rpeak = jplanar.argmax_bins_planar(fr, fi, n, mxu_dtype=jnp.bfloat16,
                                            with_peak=True)
    cr, si = tplanar._rotation_planes(tt(rate), tt(scale), tp)
    got, peak = tbf16.bf16_decide_rows(tt(yr).reshape(-1, n), tt(yi).reshape(-1, n), n,
                                       cr, si, rows_per_rot=s, with_peak=True)
    np.testing.assert_array_equal(nn(got), np.asarray(ref).reshape(-1))
    rpeak = np.asarray(rpeak).reshape(-1)
    assert np.abs(nn(peak) - rpeak).max() <= spectrum_rtol(n) * rpeak.max()

    # without rotation: the rows as they are
    ref = jplanar.argmax_bins_planar(yr, yi, n, mxu_dtype=jnp.bfloat16)
    got = tbf16.bf16_decide_rows_reference(tt(yr).reshape(-1, n), tt(yi).reshape(-1, n), n)
    np.testing.assert_array_equal(nn(got), np.asarray(ref).reshape(-1))


@pytest.mark.parametrize("sf", [8, 9, 10, 11, 12])
def test_bf16_tie_break_lowest_natural_bin(sf):
    """At N > 128 the bf16 path keeps the reference's first-max tie-break
    in natural bin order (tests/equal_power_bin_test.cpp:31-55):
    tests/test_planar.py's crafted ties on the scrambled [k2, k1] layout
    (natural bin 1 against bin n2, which comes first in that layout), and
    a row whose bf16 spectrum ties exactly on every odd bin
    (x = delta(0) - delta(N/2): |X_k|^2 = 4 for odd k), which must give
    bin 1 through the plain version, as through JAX's."""
    n = 1 << sf
    m2, m1r, twr, twi, n1, n2 = tfft._scrambled_mats(n)
    flat = np.zeros((3, n), np.float32)
    flat[:, 1] = 5.0       # scrambled-first, natural bin n2
    flat[:, n1] = 5.0      # scrambled-later, natural bin 1
    flat[0, 0] = 7.0
    bins, peak = tfft._argmax_natural(tt(flat), n1, n2)
    np.testing.assert_array_equal(nn(bins), [0, 1, 1])
    np.testing.assert_array_equal(nn(peak), [7.0, 5.0, 5.0])

    xr = np.zeros((2, n), np.float32)
    xr[:, 0], xr[:, n // 2] = 1.0, -1.0
    xr[1] *= 3.0
    xi = np.zeros_like(xr)
    mag = nn(tplanar.dft_mag2_planar(tt(xr), tt(xi), n, mxu_dtype=BF16))
    assert np.all(mag[:, 1::2] == mag[:, 1:2])          # an exact tie on the odd bins
    ref = np.asarray(jplanar.argmax_bins_planar(xr, xi, n, mxu_dtype=jnp.bfloat16))
    got = tbf16.bf16_decide_rows(tt(xr), tt(xi), n)
    np.testing.assert_array_equal(nn(got), [1, 1])
    np.testing.assert_array_equal(ref, [1, 1])


def test_precision_refusals():
    """fused=True with precision='bf16' is refused in both packages, as is
    an unknown precision (JAX refuses it only with fused=True; the port
    always)."""
    p = LoraParams(sf=7)
    tp = tparams(p)
    _, xr, xi = _noisy(p, None, batch=1, payload_len=2, seed=0)
    with pytest.raises(ValueError, match="f32"):
        jplanar.demodulate_planar(xr, xi, p, fused=True, precision="bf16")
    with pytest.raises(ValueError, match="f32"):
        tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=True, precision="bf16")
    with pytest.raises(ValueError):
        jplanar.demodulate_planar(xr, xi, p, fused=True, precision="fp8")
    for fused in (False, True):
        with pytest.raises(ValueError, match="precision"):
            tplanar.demodulate_planar(tt(xr), tt(xi), tp, fused=fused, precision="fp8")
    with pytest.raises(ValueError, match="precision"):
        tplanar.demodulate_spectrum_planar(tt(xr), tt(xi), tp, precision="fp8")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """bf16_decide_rows checks N, shapes, dtypes and the rotation planes
    before any route; on the CPU it runs the plain version and launches
    nothing."""
    n = 64
    yr, yi = (tt(a) for a in _rows(n, 6, 1))
    cr, si = torch.ones(3, n), torch.zeros(3, n)
    with pytest.raises(ValueError, match="power of two"):
        tbf16.bf16_decide_rows(yr[:, :48], yi[:, :48], 48)
    with pytest.raises(ValueError, match="power of two"):
        tbf16.bf16_decide_rows(torch.zeros(2, 8192), torch.zeros(2, 8192), 8192)
    with pytest.raises(ValueError, match="rows"):
        tbf16.bf16_decide_rows(yr.reshape(-1), yi.reshape(-1), n)
    with pytest.raises(TypeError, match="float32"):
        tbf16.bf16_decide_rows(yr.double(), yi.double(), n)
    with pytest.raises(ValueError, match="both"):
        tbf16.bf16_decide_rows(yr, yi, n, cr=cr)
    with pytest.raises(ValueError, match="rows_per_rot"):
        tbf16.bf16_decide_rows(yr, yi, n, cr, si, rows_per_rot=4)
    launches = tbf16.LAUNCHES
    got = tbf16.bf16_decide_rows(yr, yi, n, cr, si, rows_per_rot=2)
    ref = tbf16.bf16_decide_rows_reference(yr, yi, n)      # cr = 1, si = 0
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert tbf16.LAUNCHES == launches


def fourstep_untwiddles(flat, n1, n2):
    """The inverse of bf16_decide.fourstep_twiddles: the [n1, n2] plane back,
    every entry written, and every copy (the tile's other frame rows) equal
    to it."""
    row, k2 = tbf16._fragment_index(n2)
    tw = np.full((n1, n2), np.nan, np.float32)
    flat = np.asarray(flat)
    tw[row % n1, k2] = flat
    np.testing.assert_array_equal(tw[row % n1, k2], flat)
    return tw


def test_kernel_tables_are_the_plain_versions_bits():
    """The kernel's bf16 tables are torch's rounding of the port's float32
    builders, transposed and zero-padded (N < 16), so kernel and plain
    version multiply the same bits; the twiddles are the float32 ones.
    (N = 16, k permuted: test_n16_tables_are_the_plain_versions_bits; N =
    32..128: test_wgmma_tables_are_the_plain_versions_bits; N > 128, in the
    four-step's layouts: test_fourstep_tables_are_the_plain_versions_bits.)"""
    for n in (4, 8):
        wr, wi, wbr, wbi, twr, twi = tbf16._kernel_tables(n, torch.device("cpu"))
        m = torch.from_numpy(tfft._combined_dft_mat(n)).to(BF16)
        assert wr.shape == (max(n, 8), max(n, 16)) and wr.dtype == BF16
        torch.testing.assert_close(wr[:n, :n], m[:n, :n].T, rtol=0, atol=0)
        torch.testing.assert_close(wi[:n, :n], m[:n, n:].T, rtol=0, atol=0)
        assert not wr[n:].any() and not wr[:, n:].any()
        assert wbr is None and twr is None
    m2, m1r, ftwr, ftwi, n1, n2 = tfft._scrambled_mats(4096)
    wr, wi, wbr, wbi, twr, twi = tbf16._kernel_tables(4096, torch.device("cpu"))

    def table(t, k):  # the kernel's flat table back to [bin][k]
        return torch.from_numpy(tbf16.wgmma_unlayout(nn(t.view(torch.int16)), k, k,
                                                     permute=False)).view(BF16)

    torch.testing.assert_close(table(wr, n2), torch.from_numpy(m2[:n2, :n2].T.copy()).to(BF16),
                               rtol=0, atol=0)
    torch.testing.assert_close(table(wbi, n1),
                               torch.from_numpy(m1r[:n1, n1:].T.copy()).to(BF16),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(fourstep_untwiddles(nn(twi), n1, n2), ftwi)


@pytest.mark.parametrize("n", tbf16.FOURSTEP_N)
def test_fourstep_tables_are_the_plain_versions_bits(n):
    """At N = 256..4096 the kernel's four stage tables are flat [n2 * n2] /
    [n1 * n1] bf16 in the no-swizzle K-major core-matrix layout (no k
    permutation): wgmma_unlayout takes them back to exactly the bits of
    _pair_tables(M(n2)) and _pair_tables(M1R), and core matrices sit where
    the kernel's descriptors look (k-step s 256 bytes in, 8-bin groups 16 k
    bytes apart). The twiddles are the plain version's float32 [n1, n2],
    in the fragment order fourstep_untwiddles inverts, with every copy
    equal; element (w, j, lane, c) is tile row 16 w + g + 8 (c // 2), bin
    8 j + 2 t + c % 2."""
    m2, m1r, ftwr, ftwi, n1, n2 = tfft._scrambled_mats(n)
    assert (n1, n2) == tfft._split(n) and 64 % n1 == 0
    w1r, w1i, w2r, w2i, twr, twi = tbf16._kernel_tables(n, torch.device("cpu"))
    assert w1r.shape == (n2 * n2,) and w2r.shape == (n1 * n1,) and w1r.dtype == BF16
    assert twr.shape == (64 * n2,) and twr.dtype == torch.float32
    for (got_r, got_i), m, k in (((w1r, w1i), m2, n2), ((w2r, w2i), m1r, n1)):
        mb = torch.from_numpy(m).to(BF16)
        for got, want in ((got_r, mb[:k, :k].T), (got_i, mb[:k, k:].T)):
            bits = nn(got.view(torch.int16))
            want = nn(want.contiguous().view(torch.int16))
            np.testing.assert_array_equal(tbf16.wgmma_unlayout(bits, k, k, permute=False), want)
            for b, q in ((0, 0), (7, 15), (8, k // 2), (k - 1, k - 1), (13, 9)):
                pos = (b // 8) * 8 * k + (q // 16) * 128 + ((q % 16) // 8) * 64 + (b % 8) * 8 + q % 8
                assert bits[pos] == want[b, q]
    for got, want in ((twr, ftwr), (twi, ftwi)):
        np.testing.assert_array_equal(fourstep_untwiddles(nn(got), n1, n2), want)
    flat = nn(twr)
    for w, j, lane, c in ((0, 0, 0, 0), (3, n2 // 8 - 1, 31, 3), (1, 1, 6, 2)):
        row, k2 = 16 * w + lane // 4 + 8 * (c // 2), 8 * j + 2 * (lane % 4) + c % 2
        assert flat[((w * (n2 // 8) + j) * 32 + lane) * 4 + c] == ftwr[row % n1, k2]


@pytest.mark.parametrize("n", tbf16.WGMMA_N)
def test_wgmma_tables_are_the_plain_versions_bits(n):
    """At N = 32..128 the kernel's tables are flat [N * N] in the wgmma
    layout: a permutation of _pair_tables' bf16 bits, which the documented
    inverse map (wgmma_unlayout) takes back to Wr^T and Wi^T exactly; the
    layout's core matrices sit where the kernel's descriptors look."""
    wr, wi, wbr, wbi, twr, twi = tbf16._kernel_tables(n, torch.device("cpu"))
    assert wr.shape == (n * n,) and wr.dtype == BF16 and wbr is None and twr is None
    m = torch.from_numpy(tfft._combined_dft_mat(n)).to(BF16)
    for got, want in ((wr, m[:n, :n].T), (wi, m[:n, n:].T)):
        bits = nn(got.view(torch.int16))
        back = tbf16.wgmma_unlayout(bits, n, n)
        np.testing.assert_array_equal(back, nn(want.contiguous().view(torch.int16)))
        assert sorted(bits.tolist()) == sorted(back.reshape(-1).tolist())
    # element (bin b, k slot q) at core matrix (b // 8, q // 8): k-step s is
    # 256 bytes = 128 elements in, 8-bin groups 16 N bytes = 8 N elements apart
    cols = tbf16._wgmma_columns(n)
    flat = nn(wr.view(torch.int16))
    want = nn(m[:n, :n].T.contiguous().view(torch.int16))
    for b, q in ((0, 0), (7, 15), (8, 16), (n - 1, n - 1), (13, 9)):
        pos = (b // 8) * 8 * n + (q // 16) * 128 + ((q % 16) // 8) * 64 + (b % 8) * 8 + q % 8
        assert flat[pos] == want[b, cols[q]]
    assert [cols[q] for q in (0, 1, 2, 8, 9)] == [0, 1, 4, 2, 3]


def test_n16_tables_are_the_plain_versions_bits():
    """At N = 16 the kernel's tables are [16, 16] bf16, Wr^T and Wi^T with
    k permuted by _wgmma_columns: un-permuted they are _pair_tables' bits
    exactly, and the registers a thread (g, t) loads for n-tile j (bin 8j +
    g, slots 2t, 2t + 1 and 2t + 8, 2t + 9) hold the weights of its float4's
    columns 4t .. 4t + 3 in that order."""
    n = tbf16.N16_N
    wr, wi, wbr, wbi, twr, twi = tbf16._kernel_tables(n, torch.device("cpu"))
    assert wr.shape == (n, n) and wr.dtype == BF16 and wbr is None and twr is None
    m = torch.from_numpy(tfft._combined_dft_mat(n)).to(BF16)
    cols = tbf16._wgmma_columns(n)
    assert sorted(cols.tolist()) == list(range(n))
    for got, want in ((wr, m[:n, :n].T), (wi, m[:n, n:].T)):
        back = torch.empty_like(got)
        back[:, torch.from_numpy(cols)] = got
        torch.testing.assert_close(back, want.contiguous(), rtol=0, atol=0)
        for j, g, t in ((0, 0, 0), (1, 7, 3), (0, 5, 2), (1, 2, 1)):
            b = 8 * j + g
            slots = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
            torch.testing.assert_close(got[b, slots], want[b, 4 * t:4 * t + 4], rtol=0, atol=0)


def test_chip_smoke_ablations_find_their_anchors():
    """Each of chip_smoke.py's copies of bf16_decide.cu (phase 19 (f), (b)
    and (c): where the wgmma kernel's time goes at N = 32 and N = 128, and
    the four-step's) finds every statement it replaces exactly once in the
    kernel's source, and changes it."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_anchors", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shipped = smoke.bf16_ablation_source([])
    sets = (smoke.BF16_N32_ABLATIONS, smoke.BF16_ABLATIONS, smoke.FOURSTEP_ABLATIONS)
    assert [smoke.BF16_PATH_ABLATIONS[sf] for sf in (5, 7, 12)] == list(sets)
    for ablations in sets:
        for name, edits in ablations.items():
            src = smoke.bf16_ablation_source(edits)
            assert src != shipped, name
            assert all(old not in src for old, _ in edits), name


def test_kernel_design_per_n():
    """N = 32, 64, 128 run the wgmma design, N = 256..4096 the four-step on
    wgmma, N = 16 mma.sync with A from registers, N = 4, 8 mma.sync."""
    assert [tbf16.design(n) for n in tbf16.KERNEL_N] == (
        ["mma.sync"] * 2 + ["mma.sync-warp"] + ["wgmma"] * 3 + ["wgmma-fourstep"] * 5)


@pytest.mark.parametrize("n", tbf16.FOURSTEP_N)
def test_fourstep_tile_is_whole_m64_tiles(n):
    """FOURSTEP_TILE (the kernel's Fs<n1, n2>): a tile's stage-1 rows
    (rb, i1) are one m64 tile (four at N = 256) and its stage-2 rows
    (rb, k2) one to four m64 chains; a block's warpgroups, times the blocks
    an SM holds, fit the SM's 2048 threads."""
    rb, warpgroups, blocks = tbf16.FOURSTEP_TILE[n]
    n1, n2 = tfft._split(n)
    assert rb * n1 == (256 if n == 256 else 64)
    assert rb * n2 % 64 == 0 and 1 <= rb * n2 // 64 <= 4
    assert 128 * warpgroups * blocks <= 2048


@pytest.mark.gpu
@pytest.mark.parametrize("sf", list(range(2, 13)))
def test_cuda_kernel_matches_plain_version(sf):
    """The CUDA kernel against its plain version on the card, with and
    without rotation (row counts that do not fill a tile), on tones at 0 dB
    per-sample SNR: a differing bin only where the plain version's top two
    |.|^2 lie within bf16_decide.near_tie relative (the sums' order), peaks
    within it too; one launch per call; demodulate_planar at
    precision='bf16' decodes through it (SF5 and SF6: on packed symbols,
    which must come back as sent). Row counts 63, 64, 65 and 4097 sit at
    the edges of the wgmma design's 64-row tile, and just over 16 x 64 x
    SMs rows, in frames of 1, 3 and 66 rows a rotation row, are more than
    the resident warpgroups (at most 16 an SM) take in one tile each; at
    N > 128 the four-step's tile of RB frame rows
    (FOURSTEP_TILE) gets RB - 1, RB + 1 (with and without a shared
    rotation) and 2 RB x (resident warpgroups) + 1 rows, more than the
    resident warpgroups take in one tile each."""
    dev = cuda_device()
    p = LoraParams(sf=sf)
    n = p.n
    cases = [(1, 1), (7, 3), (301, 5), (63, 1), (32, 2), (13, 5), (4097, 1)]
    if n in tbf16.WGMMA_N:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        # frames of 1, 3 and 66 rows, more rows than one pass of the
        # resident warpgroups takes: each walks tiles and carries its
        # rotation index from tile to tile; the last tile is partial
        cases += [(16 * 64 * sms // r + 1, r) for r in (1, 3, 66)]
    if n > 128:
        rb, warpgroups, blocks = tbf16.FOURSTEP_TILE[n]
        resident = warpgroups * blocks * torch.cuda.get_device_properties(
            dev).multi_processor_count
        cases += [(b, 1) for b in (rb - 1, rb + 1) if b > 0]
        cases += [(rb + 1, 3), (2 * rb * resident + 1, 1)]
    for b, rows_per_rot in cases:
        yr, yi, rate, scale = _rotation_case(p, rows_per_rot, b, seed=sf + b)
        yr, yi = tt(yr).reshape(-1, n).to(dev), tt(yi).reshape(-1, n).to(dev)
        cr, si = tplanar._rotation_planes(tt(rate).to(dev), tt(scale).to(dev), tparams(p))
        for rot in ((cr.contiguous(), si.contiguous()), (None, None)):
            launches = tbf16.LAUNCHES
            k, kp = tbf16.bf16_decide_rows(yr, yi, n, *rot, rows_per_rot=rows_per_rot,
                                           with_peak=True)
            assert tbf16.LAUNCHES == launches + 1
            r, rp = tbf16.bf16_decide_rows_reference(yr, yi, n, *rot,
                                                     rows_per_rot=rows_per_rot,
                                                     with_peak=True)
            differ = (k != r).nonzero().flatten()
            if differ.numel():
                fr, fi = tbf16._derotate(yr, yi, n, *rot, rows_per_rot)
                mag = tplanar.dft_mag2_planar(fr[differ], fi[differ], n, mxu_dtype=BF16)
                top2 = mag.topk(2, dim=-1).values
                tie = tbf16.near_tie(n) * top2[:, 0]
                assert bool(((top2[:, 0] - top2[:, 1]) <= tie).all())
            torch.testing.assert_close(kp, rp, rtol=tbf16.near_tie(n), atol=0)
    if sf >= 7:
        payloads, xr, xi = _noisy(p, None, batch=2, payload_len=4, seed=sf)
        res = tplanar.demodulate_planar(tt(xr).to(dev), tt(xi).to(dev), tparams(p),
                                        precision="bf16")
        np.testing.assert_array_equal(nn(tmodem.decode(res.symbols)), payloads)
    if sf in (5, 6):
        syms = _pack_symbols(np.random.RandomState(sf).randint(0, 256, (4, 8)).astype(np.uint8),
                             sf)
        dech = np.asarray(jmodem.dechirp(jmodem.modulate(syms, p), p))
        xr, xi = jplanar.split_complex(dech.astype(np.complex64))
        launches = tbf16.LAUNCHES
        res = tplanar.demodulate_planar(tt(xr).to(dev), tt(xi).to(dev), tparams(p),
                                        precision="bf16")
        assert tbf16.LAUNCHES == launches + 1
        np.testing.assert_array_equal(nn(res.symbols), syms)
        assert (nn(res.sync_word) == 0x12).all()


@pytest.mark.gpu
@pytest.mark.parametrize("frames,rows_per_rot", [(1, 5), (3, 7), (37, 3), (101, 66), (0, 1),
                                                 (0, 3), (0, 66)])
def test_cuda_n16_kernel_walks_tasks(frames, rows_per_rot):
    """The N = 16 kernel (one warp a 32-row task, the next task's copies in
    flight, rotation rows by adds) against its plain version on the card,
    with and without rotation: row counts that are no multiple of 16 (so
    none of a task), fewer than a task too, with rotation rows that cross
    tile and task boundaries, the last task partly past the rows; frames 0
    stands for just over 64 x 16 x SMs rows (more than the resident warps
    take in one task each), so every warp walks on and carries its
    rotation index. Bins differ only within near_tie(16), peaks within it
    relative; one launch a call."""
    dev = cuda_device()
    p = LoraParams(sf=4)
    n = p.n
    if frames == 0:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        frames = 64 * 16 * sms // rows_per_rot + 1
    assert (frames * rows_per_rot) % 16
    yr, yi, rate, scale = _rotation_case(p, rows_per_rot, frames, seed=frames + rows_per_rot)
    yr, yi = tt(yr).reshape(-1, n).to(dev), tt(yi).reshape(-1, n).to(dev)
    cr, si = tplanar._rotation_planes(tt(rate).to(dev), tt(scale).to(dev), tparams(p))
    for rot in ((cr.contiguous(), si.contiguous()), (None, None)):
        launches = tbf16.LAUNCHES
        k, kp = tbf16.bf16_decide_rows(yr, yi, n, *rot, rows_per_rot=rows_per_rot,
                                       with_peak=True)
        assert tbf16.LAUNCHES == launches + 1
        r, rp = tbf16.bf16_decide_rows_reference(yr, yi, n, *rot, rows_per_rot=rows_per_rot,
                                                 with_peak=True)
        differ = (k != r).nonzero().flatten()
        if differ.numel():
            fr, fi = tbf16._derotate(yr, yi, n, *rot, rows_per_rot)
            top2 = tplanar.dft_mag2_planar(fr[differ], fi[differ], n,
                                           mxu_dtype=BF16).topk(2, dim=-1).values
            assert bool(((top2[:, 0] - top2[:, 1]) <= tbf16.near_tie(n) * top2[:, 0]).all())
        torch.testing.assert_close(kp, rp, rtol=tbf16.near_tie(n), atol=0)
