"""The gateway scan's per-window part: ``lora_phy_tpu_torch.ops.scan``
under ``models.sync.frame_sync_scan_planar``.

On the CPU the wrapper runs its plain twin ``scan_peaks_reference``,
which must equal the scan's ops as they stood before the kernel (four
dechirp planes, two stacks, the planar DFT's argmax) bit for bit and
launch nothing; ``pre_acc`` 2..3 keep the whole spectra
(``scan_spectra``, counted in ``SPECTRA``). The kernel's FFT is emulated
in numpy, stage for stage, and must give the twin's bins outside
near-ties; the C interface of ``csrc/scan.cu`` is checked against the
wrapper's ``ENTRY``. On the card (``gpu``) the kernel is held to the twin
on the same device tensors, the scan's and the block receiver's decisions
to those the twin gives, one launch a scan, inside the ``front`` range.
"""

import ctypes
import json
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from _torch_util import cuda_device
from lora_phy_tpu_torch import LoraParams, _build
from lora_phy_tpu_torch.models import sync
from lora_phy_tpu_torch.ops import planar
from lora_phy_tpu_torch.ops import scan as tscan
from lora_phy_tpu_torch.ops.fused_demod import _twiddles
from lora_phy_tpu_torch.utils import profiling
from phybench.traffic import generator

LEADS = {"B": (3,), "BC": (2, 2)}
# the kernel's bins against the twin's: equal wherever the twin's two
# largest powers of a window differ by more than this share of the larger
NEAR_TIE = 1e-5


def planes(sf, osr, lead, seed, windows=3, dev=torch.device("cpu")):
    """(xr, xi) float32 noise rows of ``windows`` whole windows and a
    tail of a part window."""
    step = (1 << sf) * osr
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, *lead, windows * step + step // 2 + 3, generator=gen)
    return x[0].to(dev), x[1].to(dev)


def tables(p, dev=torch.device("cpu")):
    dr, di = sync._downchirp(p, dev)
    return dr, di, p.n, p.osr, planar._decimation_phase(p)


def pre_change(xr, xi, p):
    """The scan's per-window ops as ``frame_sync_scan_planar`` ran them
    before the kernel, written out here."""
    n, osr, step = p.n, p.osr, p.step
    nwin = xr.shape[-1] // step
    lead = xr.shape[:-1]
    ar = xr[..., : nwin * step].reshape(*lead, nwin, step)
    ai = xi[..., : nwin * step].reshape(*lead, nwin, step)
    dr, di = sync._downchirp(p, xr.device)
    dph = planar._decimation_phase(p)

    def windows(pr, pi):
        return (pr.reshape(*lead, nwin, n, osr)[..., dph],
                pi.reshape(*lead, nwin, n, osr)[..., dph])

    ur, ui = windows(ar * dr - ai * di, ar * di + ai * dr)
    vr, vi = windows(ar * dr + ai * di, ai * dr - ar * di)
    bins, peaks = planar.argmax_bins_planar(torch.stack([ur, vr]), torch.stack([ui, vi]), n,
                                            with_peak=True)
    return bins[0], bins[1], peaks[0], peaks[1]


@pytest.mark.parametrize("lead", sorted(LEADS))
@pytest.mark.parametrize("osr", [1, 2])
@pytest.mark.parametrize("sf", [5, 7, 8, 12])
def test_twin_equals_the_pre_change_ops(sf, osr, lead):
    p = LoraParams(sf=sf, osr=osr)
    xr, xi = planes(sf, osr, LEADS[lead], seed=100 * sf + 10 * osr + len(lead))
    got = tscan.scan_peaks_reference(xr, xi, *tables(p))
    want = pre_change(xr, xi, p)
    for g, w in zip(got, want):
        assert g.shape == xr.shape[:-1] + (3,) and g.dtype == w.dtype
        assert torch.equal(g, w)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.float32


def test_wrapper_runs_the_twin_on_the_cpu():
    """On a CPU tensor the wrapper is the twin and launches nothing, also
    under frame_sync_scan_planar; the scan's fields are the pre-change
    ops' bins."""
    p = LoraParams(sf=7)
    xr, xi = planes(7, 1, (2,), seed=3, windows=12)
    launches, spectra = tscan.LAUNCHES, tscan.SPECTRA
    got = tscan.scan_peaks(xr, xi, *tables(p))
    want = tscan.scan_peaks_reference(xr, xi, *tables(p))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    s = sync.frame_sync_scan_planar(xr, xi, p, min_power_db=-40.0)
    assert tscan.LAUNCHES == launches and tscan.SPECTRA == spectra
    ub, db, _, _ = pre_change(xr, xi, p)
    assert torch.equal(s.up_bins, ub) and torch.equal(s.dn_bins, db)


@pytest.mark.parametrize("pre_acc", [2, 3])
def test_pre_acc_keeps_the_spectra_path(pre_acc):
    """pre_acc 2..3 sum whole spectra over windows: one scan_spectra call
    a scan (counted in SPECTRA), and the spectra are the stacked planar
    |DFT|² of the dechirped windows."""
    p = LoraParams(sf=7)
    xr, xi = planes(7, 1, (2,), seed=40 + pre_acc, windows=10)
    spectra, launches = tscan.SPECTRA, tscan.LAUNCHES
    sync.frame_sync_scan_planar(xr, xi, p, pre_acc=pre_acc)
    assert tscan.SPECTRA == spectra + 1 and tscan.LAUNCHES == launches
    sync.frame_sync_scan_planar(xr, xi, p, pre_acc=1)
    assert tscan.SPECTRA == spectra + 1
    m_up, m_dn = tscan.scan_spectra(xr, xi, *tables(p))
    ur, ui, vr, vi = tscan.dechirped_windows(xr, xi, *tables(p))
    assert torch.equal(m_up, planar.dft_mag2_planar(ur, ui, p.n))
    assert torch.equal(m_dn, planar.dft_mag2_planar(vr, vi, p.n))


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


# (what is wrong, the call's arguments, the error, its message)
BAD_CALLS = {
    "xr_dtype": ((meta(2, 512, dtype=torch.float64), meta(2, 512), meta(128), meta(128),
                  128, 1, 0), TypeError, "xr must be float32"),
    "chirp_dtype": ((meta(2, 512), meta(2, 512), meta(128, dtype=torch.float16), meta(128),
                     128, 1, 0), TypeError, "dr must be float32"),
    "shapes": ((meta(2, 512), meta(2, 256), meta(128), meta(128), 128, 1, 0), ValueError,
               "xi has shape"),
    "device": ((meta(2, 512), torch.empty(2, 512), meta(128), meta(128), 128, 1, 0),
               ValueError, "xi is on cpu"),
    "chirp_shape": ((meta(2, 512), meta(2, 512), meta(256), meta(256), 128, 1, 0),
                    ValueError, r"contiguous \[128\] planes"),
    "n": ((meta(2, 512), meta(2, 512), meta(96), meta(96), 96, 1, 0), ValueError,
          "no scan kernel for n=96"),
    "dph": ((meta(2, 512), meta(2, 512), meta(256), meta(256), 128, 2, 2), ValueError,
            "no scan kernel for n=128, osr=2, dph=2"),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, error, message = BAD_CALLS[case]
    launches = tscan.LAUNCHES
    with pytest.raises(error, match=message):
        tscan.scan_peaks(*args)
    assert tscan.LAUNCHES == launches


def c_parameters(source: str, name: str):
    """The parameter types of ``extern "C" int name(...)`` in ``source``."""
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    assert m, f"{name} is not declared extern \"C\""
    return [re.sub(r"\s*\w+$", "", a.strip()) for a in m.group(1).split(",")]


def test_kernel_source_is_built_and_declared():
    src = next(s for s in _build.SOURCES if s.name == "scan.cu")
    assert src.is_file()
    fake = types.SimpleNamespace(lora_scan=lambda *a: 0)
    _build.declare(fake, tscan.ENTRY)
    argtypes = fake.lora_scan.argtypes
    params = c_parameters(src.read_text(), "lora_scan")
    assert len(argtypes) == len(params) == 19
    want = {ctypes.c_longlong: "long long", ctypes.c_int: "int"}
    for ctype, decl in zip(argtypes, params):
        if "*" in decl:
            assert ctype is ctypes.c_void_p, decl
        else:
            assert decl == want[ctype], decl
    assert fake.lora_scan.restype is ctypes.c_int


def test_every_included_header_rebuilds_the_library():
    """Each header a kernel source includes is in _build.HEADERS, whose
    times the rebuild check reads."""
    included = {m for s in _build.SOURCES
                for m in re.findall(r'#include "([^"]+)"', s.read_text())}
    assert included == {h.name for h in _build.HEADERS}
    assert all(h.is_file() for h in _build.HEADERS)


# ---------------------------------------------------------------------------
# The kernel's FFT, emulated in numpy float32 stage for stage
# ---------------------------------------------------------------------------

def _bit_reverse(v, bits):
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def _dif(re_, im_, w):
    """In-place radix-2 DIF FFT over the last axis (fft_rows.cuh fft_dif);
    ``w[e]`` = (cos, -sin) of W_M^e. Position p then holds bin
    bit_reverse(p)."""
    m = re_.shape[-1]
    half = m // 2
    while half >= 1:
        for blk in range(m // (2 * half)):
            for i in range(half):
                a = 2 * half * blk + i
                b = a + half
                e = i * (m // (2 * half))
                dr, di = re_[..., a] - re_[..., b], im_[..., a] - im_[..., b]
                re_[..., a] += re_[..., b]
                im_[..., a] += im_[..., b]
                if e == 0:
                    re_[..., b], im_[..., b] = dr, di
                elif 4 * e == m:
                    re_[..., b], im_[..., b] = di, -dr
                else:
                    wr, wi = w[e]
                    re_[..., b] = dr * wr - di * wi
                    im_[..., b] = dr * wi + di * wr
        half //= 2


def _natural(re_, im_, bits):
    """Positions of a bit-reversed DIF output, last axis, in bin order."""
    order = [_bit_reverse(p, bits) for p in range(re_.shape[-1])]
    nr, ni = np.empty_like(re_), np.empty_like(im_)
    nr[..., order], ni[..., order] = re_, im_
    return nr, ni


def _twiddle(re_, im_, w):
    return re_ * w[..., 0] - im_ * w[..., 1], re_ * w[..., 1] + im_ * w[..., 0]


def kernel_power(xr, xi):
    """|X|² in natural bin order of [W, N] windows as csrc/scan.cu takes
    them: one N-point FFT at N <= 16; at N = 32..128 a 16-point FFT over
    j of samples t + G*j, the twiddles W_N^(t*k1), G-point FFTs over t;
    at N = 256..4096 a 16-point FFT over j of samples t + M*j, the
    twiddles W_N^(t*k1), a 16-point FFT over tb of y[ta + L*tb], the
    twiddles W_M^(ta*c), L-point FFTs over ta, bin k1 + 16*c + 256*d."""
    w, n = xr.shape
    tw = _twiddles(n)
    if n <= 16:
        re_, im_ = xr.copy(), xi.copy()
        _dif(re_, im_, tw)
        re_, im_ = _natural(re_, im_, n.bit_length() - 1)
        return re_ * re_ + im_ * im_
    m = n // 16                                             # threads a window
    # pass 1: [W, t, j], thread t holds sample t + m*j
    re_ = xr.reshape(w, 16, m).transpose(0, 2, 1).copy()
    im_ = xi.reshape(w, 16, m).transpose(0, 2, 1).copy()
    _dif(re_, im_, tw[::m])
    re_, im_ = _natural(re_, im_, 4)                        # [W, t, k1]
    re_, im_ = _twiddle(re_, im_, tw[np.outer(np.arange(m), np.arange(16))])
    if n <= 128:
        # G-point FFTs over t: [W, k1, t]
        re_, im_ = re_.transpose(0, 2, 1).copy(), im_.transpose(0, 2, 1).copy()
        _dif(re_, im_, tw[::16])
        re_, im_ = _natural(re_, im_, m.bit_length() - 1)   # [W, k1, k2]
        mag = re_ * re_ + im_ * im_
        return mag.transpose(0, 2, 1).reshape(w, n)         # bin k1 + 16*k2
    el = m // 16
    # pass 2: t = ta + el*tb -> [W, k1, ta, tb]
    re_ = re_.reshape(w, 16, el, 16).transpose(0, 3, 2, 1).copy()
    im_ = im_.reshape(w, 16, el, 16).transpose(0, 3, 2, 1).copy()
    _dif(re_, im_, tw[::m])
    re_, im_ = _natural(re_, im_, 4)                        # [W, k1, ta, c]
    re_, im_ = _twiddle(re_, im_, tw[16 * np.outer(np.arange(el), np.arange(16))])
    if el > 1:
        # pass 3: [W, k1, c, ta], L-point FFTs over ta
        re_, im_ = re_.transpose(0, 1, 3, 2).copy(), im_.transpose(0, 1, 3, 2).copy()
        _dif(re_, im_, tw[:: n // el])
        re_, im_ = _natural(re_, im_, el.bit_length() - 1)  # [W, k1, c, d]
    else:
        re_, im_ = re_[:, :, 0, :, None], im_[:, :, 0, :, None]
    mag = re_ * re_ + im_ * im_
    return mag.transpose(0, 3, 2, 1).reshape(w, n)          # bin k1 + 16*c + 256*d


@pytest.mark.parametrize("sf", list(range(2, 13)))
def test_kernel_fft_emulation_matches_twin(sf):
    """On noise windows the kernel's FFT (emulated) gives the twin's bins
    in both directions, except where the twin's two largest powers lie
    within NEAR_TIE of each other, and its peaks within 2e-5; on a tone
    at each bin, that bin."""
    p = LoraParams(sf=sf)
    windows = max(8, (1 << 14) >> sf)
    xr, xi = planes(sf, 1, (1,), seed=500 + sf, windows=windows)
    ub, db, up, dn = tscan.scan_peaks_reference(xr, xi, *tables(p))
    ur, ui, vr, vi = tscan.dechirped_windows(xr, xi, *tables(p))
    m_up, m_dn = tscan.scan_spectra(xr, xi, *tables(p))
    for (pr, pi), bins, peaks, spec in (((ur, ui), ub, up, m_up), ((vr, vi), db, dn, m_dn)):
        mag = kernel_power(pr[0].numpy(), pi[0].numpy())
        got = np.argmax(mag, axis=-1)
        want = bins[0].numpy()
        top2 = spec[0].topk(2, dim=-1).values.numpy()
        near = (top2[:, 0] - top2[:, 1]) <= NEAR_TIE * top2[:, 0]
        assert (got[~near] == want[~near]).all(), np.flatnonzero((got != want) & ~near)
        np.testing.assert_allclose(mag.max(axis=-1), peaks[0].numpy(), rtol=2e-5)
    n = p.n
    ang = 2 * np.pi * np.outer(np.arange(n), np.arange(n)) / n     # row k: a tone at bin k
    mag = kernel_power(np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
    assert (np.argmax(mag, axis=-1) == np.arange(n)).all()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def gateway_block(sf, channels, seed, dev):
    """One pool item of the benchmark's gateway traffic at ``sf`` (DR5 or
    DR0), ``channels`` channel blocks: (config, item)."""
    bench = pathlib.Path(__file__).resolve().parents[1] / "phybench"
    name, mix = {7: ("gw-eu868-dr5", "gw-pool2048"), 12: ("gw-eu868-dr0", "gw-pool128-dr0")}[sf]
    cfg = json.loads((bench / "configs" / f"{name}.json").read_text())
    traffic = dict(json.loads((bench / "traffic" / f"{mix}.json").read_text()),
                   channels=channels, pool=1)
    return cfg, generator.make_pool(cfg, traffic, seed, dev)[0]


def compare(xr, xi, p):
    """The kernel against the twin on the same device planes: (windows,
    near-ties, mismatches outside them, largest relative peak gap)."""
    args = tables(p, xr.device)
    got = tscan.scan_peaks(xr, xi, *args)
    want = tscan.scan_peaks_reference(xr, xi, *args)
    spectra = tscan.scan_spectra(xr, xi, *args)
    windows = near_n = bad = 0
    gap = 0.0
    for g_bin, w_bin, g_pk, w_pk, spec in zip(got[:2], want[:2], got[2:], want[2:], spectra):
        top2 = spec.topk(2, dim=-1).values
        near = (top2[..., 0] - top2[..., 1]) <= NEAR_TIE * top2[..., 0]
        windows += near.numel()
        near_n += int(near.sum())
        bad += int(((g_bin != w_bin) & ~near).sum())
        gap = max(gap, float(((g_pk - w_pk).abs() / w_pk.clamp_min(1e-30)).max()))
    return windows, near_n, bad, gap


@pytest.mark.gpu
@pytest.mark.parametrize("osr", [1, 2])
@pytest.mark.parametrize("sf", list(range(2, 13)))
def test_cuda_kernel_against_twin(sf, osr):
    """Noise planes ([4, 3] rows with a tail) and a complex tensor's
    .real / .imag views: bins equal to the twin's outside near-ties,
    mismatches under 1e-4 of windows, peaks within a relative 2e-5, one
    launch a call, the planes left as they were."""
    dev = cuda_device()
    p = LoraParams(sf=sf, osr=osr)
    windows = max(16, (1 << 20) // p.step // 12)
    xr, xi = planes(sf, osr, (4, 3), seed=900 + 10 * sf + osr, windows=windows, dev=dev)
    before = xr.clone(), xi.clone()
    launches = tscan.LAUNCHES
    total, _, bad, gap = compare(xr, xi, p)
    assert tscan.LAUNCHES == launches + 1
    assert bad == 0 and gap <= 2e-5, (bad, gap)
    assert torch.equal(xr, before[0]) and torch.equal(xi, before[1])
    iq = torch.complex(xr[0], xi[0])
    total, _, bad, gap = compare(iq.real, iq.imag, p)
    assert bad <= 1e-4 * total and gap <= 2e-5, (bad, gap)


@pytest.mark.gpu
@pytest.mark.parametrize("sf", [7, 12])
def test_cuda_kernel_on_gateway_blocks(sf):
    """The benchmark's gateway traffic: bins equal outside near-ties, no
    more than 1e-4 of windows near a tie, peaks within 2e-5; the scan's
    valid / start / cfo_bins with the kernel equal those with the twin,
    one launch a scan; so do the block receiver's frames."""
    dev = cuda_device()
    cfg, item = gateway_block(sf, 64 if sf == 7 else 8, 2 ** 33 + 25, dev)
    p = LoraParams(sf=sf, sync_word=cfg["sync_word"])
    total, near, bad, gap = compare(item.xr, item.xi, p)
    assert bad == 0 and near <= 1e-4 * total and gap <= 2e-5, (total, near, bad, gap)

    def scan():
        return sync.frame_sync_scan_planar(item.xr, item.xi, p, cfg["preamble_len"],
                                           cfg["min_power_db"])

    def receive():
        return sync.receive_block_planar(
            item.xr, item.xi, p, 2 * cfg["payload_bytes"], max_frames=cfg["max_frames"],
            preamble_len=cfg["preamble_len"], min_power_db=cfg["min_power_db"])

    launches = tscan.LAUNCHES
    s_kernel = scan()
    assert tscan.LAUNCHES == launches + 1
    b_kernel = receive()
    assert tscan.LAUNCHES == launches + 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sync, "scan_peaks", tscan.scan_peaks_reference)
        s_twin, b_twin = scan(), receive()
    assert tscan.LAUNCHES == launches + 2
    assert int(s_kernel.valid.sum()) > 0
    for f in ("valid", "start", "cfo_bins"):
        assert torch.equal(getattr(s_kernel, f), getattr(s_twin, f)), f
    assert int(b_kernel.found.sum()) > 0
    for f in b_kernel._fields:
        assert torch.equal(getattr(b_kernel, f), getattr(b_twin, f)), f


@pytest.mark.gpu
def test_cuda_kernel_runs_in_the_front_range():
    """Traced (``utils/profiling.range_profile``, the attribution the
    harness froze), the scan inside the ``front`` range as the block
    receiver opens it: the scan kernel's device time is linked under
    ``front``, once a call, and no device time falls outside the range."""
    dev = cuda_device()
    cfg, item = gateway_block(7, 16, 2 ** 31 + 3, dev)
    p = LoraParams(sf=7, sync_word=cfg["sync_word"])

    def front():
        with profiling.stage_range("front"):
            return sync.frame_sync_scan_planar(item.xr, item.xi, p, cfg["preamble_len"],
                                               cfg["min_power_db"])

    prof = profiling.range_profile(front, ("front",), calls=2)
    kernel = {name: ms for name, ms in prof.kernels.items()
              if re.search(r"\bscan_(small|rows|block)_kernel<", name)}
    assert len(kernel) == 1 and sum(kernel.values()) > 0, prof.kernels
    front_ms, _, front_events = prof.stages["front"]
    assert front_ms >= sum(kernel.values()) and front_events > 0, prof
    assert prof.other[2] == 0, prof
