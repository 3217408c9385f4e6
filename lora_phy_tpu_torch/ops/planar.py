"""Planar-complex (split re/im float32) modulation, dechirp and
demodulation — the PyTorch twin of ``lora_phy_tpu/ops/planar.py``: the
main path, the preamble (plain and multipath-robust) and clock-drift
estimators, the spectrum demod that the block receiver
(:mod:`..models.sync`) runs, the public estimate / compensate API, and
the helpers these share (rounding, phase wrap, the osr-phase view and
pick, the sync byte, the window tensor), whose JAX twins are in
``lora_phy_tpu/models/modem.py``; the derotation's are in :mod:`.decide`.

This module sits above the ops it dispatches to: the planar DFT of
:mod:`.fft`, the hand kernels' wrappers :mod:`.dechirp`,
:mod:`.windows`, :mod:`.fused_demod`, :mod:`.decide` and
:mod:`.bf16_decide`, and :mod:`.chirp`. None of them imports it, and it
imports nothing of :mod:`..models`.

Same estimator, tie-breaks and rounding as the JAX module (and so as the
reference, src/phy/LoRaDemod.cpp:49-195), computed in float32 on
(re, im) planes with the DFT as real matmuls (four-step for N > 128).
``demodulate_planar(fused=True)`` sends the per-symbol stage at N <= 128
through the hand-written CUDA kernel of :mod:`.fused_demod`; with
``fused=False`` the exact float32 stage at N = 256..4096 on a CUDA tensor
is the hand-written kernel of :mod:`.decide`.

Reduced precision is opt-in, as in the JAX module: ``mxu_dtype=torch.bfloat16``
on the DFT functions and ``precision="bf16"`` on the demodulators round
the DFT operands to bf16 and sum their products in float32 (:func:`.fft._mm`).
On a CUDA tensor the bf16 decisions (``demodulate_planar`` and
``argmax_bins_planar``) run through the hand-written kernel of
:mod:`.bf16_decide`; everything else stays torch ops. The JAX module's
``_decision_bins_bf16``, which it substitutes for ``precision="f32"`` on
any non-CPU backend, is not ported: the port honours float32 on every
device.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import LoraParams, device_of, device_table
from ..utils.params import _window_table
from ..utils.profiling import host_sync, stage_range
from .bf16_decide import bf16_decide_rows
from .chirp import base_downchirp_planar, gen_chirp_np, modulate_symbols_planar
from .dechirp import dechirp
from .decide import _rotated_windows_planar, _rotation_planes, decide_rows
from .fft import _argmax_bins_ops, dft_mag2_planar, dft_planar
from .fused_demod import fused_demod
from .windows import shifted_windows

_TWO_PI = 2.0 * math.pi
_TWO_PI_F32 = float(np.float32(_TWO_PI))


class PlanarDemodResult(NamedTuple):
    symbols: torch.Tensor       # [..., S] int32 data symbols
    sync_word: torch.Tensor     # [...] uint8
    cfo: torch.Tensor           # [...] float32
    time_offset: torch.Tensor   # [...] float32


class PlanarDetection(NamedTuple):
    index: torch.Tensor
    power: torch.Tensor       # fundamental power, dB (LoRaDetector.hpp:64)
    power_avg: torch.Tensor   # residual/noise power, dB
    findex: torch.Tensor
    peak_re: torch.Tensor
    peak_im: torch.Tensor


def as_planes(xr, xi, device=None):
    """(re, im) float32 tensors on ``device``: tensors stay where they
    live, arrays go to the first CUDA card unless ``device`` is given
    (:func:`..device_of`)."""
    dev = device_of(xr, device)
    return (torch.as_tensor(xr, dtype=torch.float32, device=dev),
            torch.as_tensor(xi, dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# Helpers of the estimator and the demodulators
# ---------------------------------------------------------------------------

def _window_tensor(params: LoraParams, device):
    """The Hann window (:func:`..utils.params._window_table`) as a device
    tensor, or None. The JAX twin passes the NumPy table itself."""
    return device_table(_window_table, params, device=device)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """std::round semantics (half away from zero) — torch.round is half-even.
    JAX twin: ``lora_phy_tpu/models/modem.py:_round_half_away``."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def _wrap_pi(d: torch.Tensor) -> torch.Tensor:
    """The reference's while-loop phase wrap into [-pi, pi]
    (src/phy/LoRaDemod.cpp:116-118); inputs are within +-2pi. JAX twin:
    ``lora_phy_tpu/models/modem.py:_wrap_pi``."""
    d = torch.where(d > math.pi, d - _TWO_PI, d)
    return torch.where(d < -math.pi, d + _TWO_PI, d)


def _osr_phase_view(x: torch.Tensor, n: int, osr: int) -> torch.Tensor:
    """[..., S*step] -> [..., S, osr, N] where [..., s, t, i] = x[s*step + t + i*osr].
    JAX twin: ``lora_phy_tpu/models/modem.py:_osr_phase_view``."""
    s = x.shape[-1] // (n * osr)
    return x[..., : s * n * osr].reshape(*x.shape[:-1], s, n, osr).swapaxes(-1, -2)


def _tie_power_db(xr: torch.Tensor, xi: torch.Tensor, index: torch.Tensor,
                  n: int) -> torch.Tensor:
    """The detector's peak power in dB (float32), recomputed for the
    estimator's osr-phase pick: the DFT value at the float32 argmax bin
    ``index`` taken in float64 from the float32 windows ``[..., N]``,
    then rounded where the float32 detector rounds (``20*log10`` of the
    fundamental, then minus ``20*log10(N)``).

    The pick compares the osr phases' powers by exact equality
    (src/phy/LoRaDemod.cpp:85-135). A clean tone has the same true power
    at several phases; the JAX twin's float32 sums then tie, and another
    summation order (torch's matmul) can break the tie by one ulp of
    ``20*log10`` (3.8e-6 dB at N = 128) and pick another phase. In float64
    the equal true powers round to the same float32, while powers that
    differ by more than the float32 sums' error keep their order. The JAX
    twin ``lora_phy_tpu/models/modem.py:_estimate`` compares the
    detector's powers as they are."""
    j = torch.arange(n, dtype=torch.int64, device=xr.device)
    m = torch.remainder(index.to(torch.int64)[..., None] * j, n)
    ang = m.to(torch.float64) * (_TWO_PI / n)
    c, s = torch.cos(ang), -torch.sin(ang)
    ar, ai = xr.to(torch.float64), xi.to(torch.float64)
    yr = torch.sum(ar * c - ai * s, dim=-1)
    yi = torch.sum(ar * s + ai * c, dim=-1)
    v = (20.0 * torch.log10(torch.sqrt(yr * yr + yi * yi))).to(torch.float32)
    return v - 20.0 * torch.log10(torch.tensor(float(n), device=xr.device))


def _pick_osr_phase(p: torch.Tensor, idx: torch.Tensor,
                    tie_break_idx: bool) -> torch.Tensor:
    """The winning osr phase per symbol from powers ``p`` and bins ``idx``
    ``[..., S, osr]``: the greatest power, first phase on a tie, and with
    ``tie_break_idx`` the lowest bin among the tied phases first
    (src/phy/LoRaDemod.cpp:85-135). JAX twin: the pick inside
    ``lora_phy_tpu/models/modem.py:_estimate``."""
    maxp = p.amax(dim=-1, keepdim=True)
    cand = p == maxp
    if tie_break_idx:
        idx_masked = torch.where(cand, idx, torch.iinfo(torch.int32).max)
        min_idx = idx_masked.amin(dim=-1, keepdim=True)
        cand = cand & (idx_masked == min_idx)
    return torch.argmax(cand.to(torch.int32), dim=-1)   # first winning phase


def _sync_from_symbols(idx0: torch.Tensor, idx1: torch.Tensor, sf: int) -> torch.Tensor:
    """Recover the two-nibble sync byte (src/phy/LoRaDemod.cpp:177-192).
    JAX twin: ``lora_phy_tpu/models/modem.py:_sync_from_symbols``."""
    shift = (sf - 4) if sf > 4 else 0
    hi = (idx0 >> shift) & 0x0F
    lo = (idx1 >> shift) & 0x0F
    return ((hi << 4) | lo).to(torch.uint8)


def argmax_bins_planar(xr: torch.Tensor, xi: torch.Tensor, n: int,
                       mxu_dtype=None, with_peak: bool = False):
    """DFT + |.|² + first-max argmax only (int32 bins; ``with_peak`` also
    returns the peak |.|²). At N > 128 ties go to the lowest natural bin,
    as the reference's first-max scan (tests/equal_power_bin_test.cpp).

    ``mxu_dtype=torch.bfloat16`` goes through :mod:`.bf16_decide`: the
    kernel on a CUDA tensor, its plain version (torch ops) on the CPU."""
    if mxu_dtype == torch.bfloat16:
        lead = xr.shape[:-1]
        out = bf16_decide_rows(xr.reshape(-1, n).contiguous(),
                               xi.reshape(-1, n).contiguous(), n, with_peak=with_peak)
        if with_peak:
            return out[0].reshape(lead), out[1].reshape(lead)
        return out.reshape(lead)
    return _argmax_bins_ops(xr, xi, n, mxu_dtype, with_peak)


def _n_device(n: int, device) -> torch.Tensor:
    """``N`` as a float32 scalar on ``device``, for :func:`detect_planar`'s
    dB scale: a copy from pageable host memory, so on a CUDA device the
    host waits there for the queue to drain (a counted host sync)."""
    with host_sync():
        return torch.tensor(n, dtype=torch.float32, device=device)


def detect_planar(xr: torch.Tensor, xi: torch.Tensor, n: int,
                  mxu_dtype=None, n_dev=None) -> PlanarDetection:
    """Planar twin of ops.detect.detect (same argmax/tie-break/fIndex
    semantics, LoRaDetector.hpp:39-74).

    ``n_dev``: ``N`` as a float32 scalar on the planes' device
    (:func:`_n_device`), or None to copy it here: one host sync a call on
    a CUDA device (a copy from pageable host memory waits for the queue
    to drain)."""
    sr, si = dft_planar(xr, xi, n, mxu_dtype)
    mag2 = sr * sr + si * si
    index = torch.argmax(mag2, dim=-1)
    max_value = mag2.amax(dim=-1)
    fundamental = torch.sqrt(max_value)
    if n_dev is None:
        n_dev = _n_device(n, xr.device)
    scale_db = 20.0 * torch.log10(n_dev)
    power = 20.0 * torch.log10(fundamental) - scale_db
    total = mag2.sum(dim=-1)
    noise = torch.sqrt(torch.clamp(total - max_value, min=0.0))
    power_avg = 20.0 * torch.log10(noise) - scale_db

    left_ix = torch.where(index > 0, index - 1, n - 1)[..., None]
    right_ix = torch.where(index < n - 1, index + 1, 0)[..., None]
    left = torch.sqrt(torch.gather(mag2, -1, left_ix)[..., 0])
    right = torch.sqrt(torch.gather(mag2, -1, right_ix)[..., 0])
    denom = 2.0 * fundamental - right - left
    findex = torch.where(denom == 0.0, torch.zeros_like(denom),
                         0.5 * (right - left) / denom)
    peak_re = torch.gather(sr, -1, index[..., None])[..., 0]
    peak_im = torch.gather(si, -1, index[..., None])[..., 0]
    return PlanarDetection(index.to(torch.int32), power, power_avg, findex,
                           peak_re, peak_im)


def _estimate_planar(xr: torch.Tensor, xi: torch.Tensor, n: int, osr: int,
                     window, tie_break_idx: bool = True, n_dev=None):
    """The 2-symbol CFO / timing estimate on (re, im) planes.
    ``tie_break_idx=True`` applies ``lora_demodulate``'s lowest-index
    tie-break across osr phases (src/phy/LoRaDemod.cpp:85-135), False
    ``estimate_offsets``'s plain scan (src/phy/phy.cpp:113). At osr > 1
    the phases' powers are compared as :func:`_tie_power_db`
    recomputes them, so a true tie stays a tie. ``n_dev`` as
    :func:`detect_planar` takes it."""
    vr, vi = _osr_phase_view(xr, n, osr), _osr_phase_view(xi, n, osr)
    s = vr.shape[-3]
    if window is not None:
        vr, vi = vr * window, vi * window
    det = detect_planar(vr, vi, n, n_dev=n_dev)
    p, idx = det.power, det.index
    if osr > 1:
        p = _tie_power_db(vr, vi, idx, n)
    best_t = _pick_osr_phase(p, idx, tie_break_idx)

    def pick(f):
        return torch.gather(f, -1, best_t[..., None])[..., 0]

    best_idx, best_fi = pick(idx), pick(det.findex)
    pr, pi = pick(det.peak_re), pick(det.peak_im)

    sum_index = torch.sum(best_idx.to(torch.float32) + best_fi, dim=-1)
    avg_index = sum_index / float(s)
    cfo_coarse = avg_index / float(n)

    phase = torch.atan2(pi, pr)
    if s > 1:
        d = _wrap_pi(phase[..., 1:] - phase[..., :-1])
        cfo_fine = (torch.sum(d, dim=-1) / float(s - 1)) / float(
            np.float32(_TWO_PI) * np.float32(n))
    else:
        cfo_fine = torch.zeros_like(cfo_coarse)
    cfo = cfo_coarse + cfo_fine

    frac = avg_index - torch.floor(avg_index + 0.5)
    avg_t = torch.sum(best_t, dim=-1).to(torch.float32) / float(s)
    time_offset = avg_t - frac * float(n) * float(osr)
    return cfo, time_offset


def _decimation_phase(params: LoraParams) -> int:
    """The osr phase where modulated tones are exact: 0 for
    ``continuous_chirp`` TX or osr 1, ``osr-1`` under the reference's
    one-sample-early TX fold (docs/SEMANTICS.md §TX fold)."""
    return 0 if (params.continuous_chirp or params.osr == 1) else params.osr - 1


@functools.lru_cache(maxsize=32)
def _preamble_phase_step(sf: int, osr: int, scale: float) -> float:
    """Deterministic inter-symbol phase delta of dechirped base upchirps
    (pi at osr=1/scale=1, pi/2 at osr=2, 0 at scale=2, ...), measured once
    per configuration from the float64 host oracle — a copy of the JAX
    module's NumPy builder."""
    n = 1 << sf
    step = n * osr
    up, _ = gen_chirp_np(n, osr, 2 * step, 0.0, down=False, ampl=1.0,
                         bw_scale=scale)
    down, _ = gen_chirp_np(n, osr, step, 0.0, down=True, ampl=1.0,
                           bw_scale=scale)
    dech = up.reshape(2, step) * down
    spec = np.fft.fft(dech.reshape(2, n, osr)[:, :, 0], axis=-1)
    pk = spec[np.arange(2), np.abs(spec).argmax(-1)]
    return float(np.angle(pk[1] * np.conj(pk[0])))


def estimate_preamble_planar(pr: torch.Tensor, pi: torch.Tensor, n: int,
                             osr: int, phase_step: float = 0.0,
                             bin_offset=None) -> torch.Tensor:
    """Unbiased residual-CFO estimate (in bins, [...]) from dechirped
    PREAMBLE windows ``[..., S*n*osr]``: coarse = mean(signed argmax +
    fractional interpolation), fine = peak-phase slope across windows
    less ``phase_step`` (the modulator's own inter-symbol delta,
    :func:`_preamble_phase_step`), combined by integer disambiguation.

    ``bin_offset`` ([...] int): expected integer bin of the preamble
    tones for spectra that arrive rotated by a known shift (the block
    receiver's circular extraction). The signed wrap re-centers on it and
    the estimate comes back relative to it."""
    lead = pr.shape[:-1]
    s = pr.shape[-1] // (n * osr)
    vr = pr[..., : s * n * osr].reshape(*lead, s, n, osr)[..., 0]
    vi = pi[..., : s * n * osr].reshape(*lead, s, n, osr)[..., 0]
    det = detect_planar(vr, vi, n)
    if bin_offset is None:
        sb = torch.where(det.index > n // 2, det.index - n, det.index)
    else:
        b0 = torch.as_tensor(bin_offset, dtype=torch.int32,
                             device=pr.device)[..., None]
        sb = torch.remainder(det.index - b0 + n // 2, n) - n // 2
    coarse = torch.mean(sb.to(torch.float32) + det.findex, dim=-1)
    if s < 2:
        # one window has no phase slope: the coarse term alone
        return coarse
    phase = torch.atan2(det.peak_im, det.peak_re)
    d = phase[..., 1:] - phase[..., :-1] - float(np.float32(phase_step))
    d = torch.remainder(d + math.pi, _TWO_PI) - math.pi
    fine = torch.mean(d, dim=-1) / _TWO_PI_F32          # = cfo mod 1 bin
    return fine + torch.round(coarse - fine)


def estimate_preamble_robust_planar(pr: torch.Tensor, pi: torch.Tensor,
                                    n: int, osr: int, phase_step: float = 0.0,
                                    return_acc: bool = False):
    """Multipath-robust variant of :func:`estimate_preamble_planar`: one
    COMMON bin from the accumulated preamble spectrum instead of
    per-window argmaxes (under a near-equal-power two-ray channel those
    alternate between the paths' bins and the coarse mean lands between
    them). Sum the windows' |DFT|², take one argmax, read the fractional
    term from the summed spectrum's neighbours (magnitudes, the detector's
    convention), and the fine term from the phase slope of each window's
    DFT value at that bin. Returns CFO in bins, [...]; ``return_acc=True``
    also returns the accumulated |DFT|² ``[..., n]`` (the multipath
    signature, reused by the block receiver's path combining)."""
    lead = pr.shape[:-1]
    s = pr.shape[-1] // (n * osr)
    vr = pr[..., : s * n * osr].reshape(*lead, s, n, osr)[..., 0]
    vi = pi[..., : s * n * osr].reshape(*lead, s, n, osr)[..., 0]
    fr, fi = dft_planar(vr, vi, n)                      # [..., S, n]
    acc = torch.sum(fr * fr + fi * fi, dim=-2)          # [..., n]
    b = torch.argmax(acc, dim=-1, keepdim=True)         # [..., 1]

    def at(off):
        return torch.sqrt(torch.gather(acc, -1, torch.remainder(b + off, n))[..., 0])

    peak, left, right = at(0), at(-1), at(1)
    frac = 0.5 * (right - left) / torch.clamp(2.0 * peak - right - left,
                                              min=1e-30)
    b = b[..., 0]
    sb = torch.where(b > n // 2, b - n, b).to(torch.float32)
    coarse = sb + frac
    if s < 2:
        return (coarse, acc) if return_acc else coarse
    bb = b[..., None, None].expand(*lead, s, 1)
    re_b = torch.gather(fr, -1, bb)[..., 0]             # [..., S]
    im_b = torch.gather(fi, -1, bb)[..., 0]
    phase = torch.atan2(im_b, re_b)
    d = phase[..., 1:] - phase[..., :-1] - float(np.float32(phase_step))
    d = torch.remainder(d + math.pi, _TWO_PI) - math.pi
    fine = torch.mean(d, dim=-1) / _TWO_PI_F32
    cfo = fine + torch.round(coarse - fine)
    return (cfo, acc) if return_acc else cfo


def estimate_sro_planar(xr: torch.Tensor, xi: torch.Tensor,
                        params: LoraParams) -> torch.Tensor:
    """Sample-rate-offset (TX/RX clock drift) estimate in ppm, [...], from
    dechirped symbol windows ``[..., S*step]``: each window's fractional
    bin by the sinc-ratio form ``right/(peak+right)``, first differences
    wrapped to [-1/2, 1/2), averaged, scaled by ``1e6 / (N*scale)``.
    Windows are decimated where the tone is exact: phase 0 for
    ``continuous_chirp`` TX or osr 1, ``osr-1`` under the reference fold.
    Fewer than two windows report zero drift."""
    n, osr = params.n, params.osr
    lead = xr.shape[:-1]
    s = xr.shape[-1] // (n * osr)
    if s < 2:
        return torch.zeros(lead, dtype=torch.float32, device=xr.device)
    _, left, peak, right = sro_peak_powers(xr, xi, params)
    return sro_from_powers(left, peak, right, params)


def sro_peak_powers(xr: torch.Tensor, xi: torch.Tensor, params: LoraParams):
    """The DFT side of :func:`estimate_sro_planar`: of each of the
    ``[..., S*step]`` planes' S decimated windows, the first-max bin and
    the powers at that bin minus one, the bin and the bin plus one
    (circular): ``(index, left, peak, right)``, [..., S] each."""
    n, osr = params.n, params.osr
    phase = _decimation_phase(params)
    lead = xr.shape[:-1]
    s = xr.shape[-1] // (n * osr)

    def view(a):
        return a[..., : s * n * osr].reshape(*lead, s, n, osr)[..., phase]

    sr, si = dft_planar(view(xr), view(xi), n)
    mag2 = sr * sr + si * si                                  # [..., S, N]
    index = torch.argmax(mag2, dim=-1)
    peak = mag2.amax(dim=-1)
    left_ix = torch.where(index > 0, index - 1, n - 1)[..., None]
    right_ix = torch.where(index < n - 1, index + 1, 0)[..., None]
    left = torch.gather(mag2, -1, left_ix)[..., 0]
    right = torch.gather(mag2, -1, right_ix)[..., 0]
    return index, left, peak, right


def sro_from_powers(left: torch.Tensor, peak: torch.Tensor, right: torch.Tensor,
                    params: LoraParams) -> torch.Tensor:
    """The fractional-bin side of :func:`estimate_sro_planar`, from each
    window's powers around its first max ([..., S], as
    :func:`sro_peak_powers` gives them): ppm, [...]; zero under two
    windows."""
    if peak.shape[-1] < 2:
        return torch.zeros(peak.shape[:-1], dtype=torch.float32, device=peak.device)
    n = params.n
    peak = torch.sqrt(peak)
    left = torch.sqrt(left)
    right = torch.sqrt(right)
    den_r, den_l = peak + right, peak + left
    one = torch.ones_like(den_r)
    fi = torch.where(
        right >= left,
        torch.where(den_r > 0.0, right / torch.where(den_r > 0.0, den_r, one),
                    torch.zeros_like(den_r)),
        -left / torch.where(den_l > 0.0, den_l, one),
    )                                                         # [..., S]
    dd = fi[..., 1:] - fi[..., :-1]
    dd = torch.remainder(dd + 0.5, 1.0) - 0.5
    slope = torch.mean(dd, dim=-1)                            # bins/symbol
    return 1e6 * slope / float(np.float32(n * params.scale))


# ---------------------------------------------------------------------------
# Demodulation
# ---------------------------------------------------------------------------

def demodulate_planar(xr: torch.Tensor, xi: torch.Tensor, params: LoraParams,
                      fused: bool = False, assume_normalized: bool = False,
                      precision: str = "f32",
                      known_offsets=None) -> PlanarDemodResult:
    """Planar twin of models.modem.demodulate (the working dechirped-input
    contract). ``xr, xi``: [..., S_total*step] float32.

    ``fused=True`` routes the per-symbol stage (N <= 128) through
    :func:`.fused_demod.fused_demod` — the CUDA kernel on a CUDA tensor,
    its plain twin on a CPU tensor. Otherwise, at ``precision='f32'``, the
    stage is :func:`.decide.decide_rows`: on a CUDA tensor at N = 256..4096
    the kernel ``csrc/decide.cu``, else its twin (the derotated planes and
    the planar DFT's argmax). ``assume_normalized=True`` skips the
    [-1, 1] rescale scan. ``known_offsets=(cfo, time_offset)`` bypasses
    the 2-symbol estimator. ``precision='bf16'`` rounds the DFT operands
    to bf16 (f32 sums); the derotation and the decision go through
    :mod:`.bf16_decide` (on a CUDA tensor one kernel, which never writes
    the derotated planes out). The front (scan, estimate, windows) stays
    float32, so ``cfo`` and ``time_offset`` are float32's.

    While a profiler runs, the stages are ``record_function`` ranges that
    do not nest: the front's ``planar.scale``, ``planar.estimate`` and
    ``planar.windows`` (:func:`_demod_stage_planar`), then
    ``planar.decide`` around the per-symbol stage (a kernel or torch ops;
    the sync word is outside it). On a CUDA device
    the call makes two host syncs
    (:func:`..utils.profiling.host_sync`): one before the scale scan (the
    copy of ``N`` for the estimate's :func:`detect_planar`, outside every
    stage range), one in the window gather, which reads
    ``t_off == 0`` once for both planes (:func:`.windows.shifted_windows`);
    ``known_offsets`` leaves out the first."""
    mxu_dtype = _mxu_dtype(precision)
    if fused and mxu_dtype is not None:
        raise ValueError("the fused kernel runs f32 only; "
                         "precision='bf16' requires fused=False")
    yr, yi, rate, t_off, scale, cfo, time_offset = _demod_stage_planar(
        xr, xi, params, assume_normalized, known_offsets
    )

    with stage_range("planar.decide"):
        if fused:
            # the kernel multiplies by ``scale`` at load: the same floats as
            # the JAX path's ``yr * scale``, without materialising it
            syms = fused_demod(yr, yi, rate, t_off, params, scale)
        elif mxu_dtype is not None:
            n = params.n
            cr, si = _rotation_planes(rate, scale, params)
            rows = yr.shape[:-1]
            syms = bf16_decide_rows(yr.reshape(-1, n).contiguous(),
                                    yi.reshape(-1, n).contiguous(), n,
                                    cr.reshape(-1, n).contiguous(),
                                    si.reshape(-1, n).contiguous(),
                                    rows_per_rot=rows[-1]).reshape(rows)
        else:
            syms = decide_rows(yr, yi, rate, scale, params)

    sync = _sync_from_symbols(syms[..., 0], syms[..., 1], params.sf)
    return PlanarDemodResult(syms[..., 2:], sync, cfo, time_offset)


def _mxu_dtype(precision: str):
    """The matmul operand dtype of a demodulator's ``precision``."""
    if precision == "f32":
        return None
    if precision == "bf16":
        return torch.bfloat16
    raise ValueError(f"unknown precision {precision!r} (f32 or bf16)")


def demodulate_spectrum_planar(xr: torch.Tensor, xi: torch.Tensor,
                               params: LoraParams,
                               assume_normalized: bool = False,
                               precision: str = "f32", known_offsets=None,
                               dec_phase: int = 0):
    """Same pipeline as :func:`demodulate_planar` but returns the full
    |DFT|² spectra of the DATA symbols (sync pair stripped):
    ``(mag2 [..., S-2, N], sync, cfo, time_offset)``.

    ``dec_phase`` picks the decimation phase of the symbol windows: pass
    ``osr-1`` when receiving the reference's default TX fold with an
    injected time offset of 0 (see :func:`.windows.shifted_windows`). On a
    CUDA device the host syncs are :func:`demodulate_planar`'s two:
    the copy of ``N`` for the estimate, before the scale scan (none with
    ``known_offsets``) and the window gather's one ``t_off == 0`` read for
    both planes. ``precision='bf16'`` rounds the DFT operands to bf16 (torch
    ops on every device: the spectra are floats, not decisions)."""
    mxu_dtype = _mxu_dtype(precision)
    yr, yi, rate, t_off, scale, cfo, time_offset = _demod_stage_planar(
        xr, xi, params, assume_normalized, known_offsets, dec_phase
    )
    fr, fi = _rotated_windows_planar(yr, yi, rate, t_off, scale, params)
    mag2 = dft_mag2_planar(fr, fi, params.n, mxu_dtype)
    syms = torch.argmax(mag2[..., :2, :], dim=-1).to(torch.int32)
    sync = _sync_from_symbols(syms[..., 0], syms[..., 1], params.sf)
    return mag2[..., 2:, :], sync, cfo, time_offset


def _max_abs(x: torch.Tensor) -> torch.Tensor:
    """max |x| over the last axis in one pass, with no |x| temporary."""
    lo, hi = torch.aminmax(x, dim=-1)
    return torch.maximum(hi, -lo)


def _demod_stage_planar(xr: torch.Tensor, xi: torch.Tensor, params: LoraParams,
                        assume_normalized: bool, known_offsets,
                        dec_phase: int = 0):
    """Common front of the planar demod: normalisation scan, offset
    estimate (or injection), shifted symbol windows.

    Returns ``(yr, yi, rate, t_off, scale, cfo, time_offset)`` with
    ``yr/yi`` the [..., S, N] pre-rotation symbol windows. Its stages run
    in the ranges ``planar.scale``, ``planar.estimate`` and
    ``planar.windows`` (:func:`..utils.profiling.stage_range`)."""
    n, osr, step = params.n, params.osr, params.step
    total_symbols = xr.shape[-1] // step
    if total_symbols < 2:
        raise ValueError("need at least the 2 sync symbols")   # phy.hpp:186
    xr = xr[..., : total_symbols * step]
    xi = xi[..., : total_symbols * step]
    # The estimate's host sync, taken before the scale scan is queued: the
    # host waits only for the work queued ahead (the dechirp), then queues
    # the scan and the estimate's ~100 small ops while the device runs
    # them, so the device does not idle while the host queues them.
    n_dev = _n_device(n, xr.device) if known_offsets is None else None

    # Amplitude normalisation into [-1, 1] (src/phy/LoRaDemod.cpp:59-77),
    # folded into the derotation factors downstream (the argmax is
    # scale-invariant), so only the max scan touches the full input.
    if not assume_normalized:
        with stage_range("planar.scale"):
            max_amp = torch.maximum(_max_abs(xr), _max_abs(xi))
            scale = torch.where(max_amp > 1.0, 1.0 / max_amp,
                                torch.ones_like(max_amp))
    else:
        scale = None

    with stage_range("planar.estimate"):
        window = _window_tensor(params, xr.device)
        if known_offsets is None:
            er = xr[..., : 2 * step]
            ei = xi[..., : 2 * step]
            if scale is not None:
                er = er * scale[..., None]
                ei = ei * scale[..., None]
            cfo, time_offset = _estimate_planar(er, ei, n, osr, window, n_dev=n_dev)
        else:
            batch = xr.shape[:-1]
            cfo = torch.broadcast_to(torch.as_tensor(
                known_offsets[0], dtype=torch.float32, device=xr.device), batch)
            time_offset = torch.broadcast_to(torch.as_tensor(
                known_offsets[1], dtype=torch.float32, device=xr.device), batch)
        rate = -_TWO_PI_F32 * cfo / float(n)

    with stage_range("planar.windows"):
        t_off = _round_half_away(time_offset).to(torch.int32)
        yr, yi = shifted_windows(xr, xi, total_symbols, n, osr, t_off, dec_phase)
    return yr, yi, rate, t_off, scale, cfo, time_offset


# ---------------------------------------------------------------------------
# Planar estimate / compensate (public API parity with phy.cpp)
# ---------------------------------------------------------------------------

def estimate_offsets_planar(xr: torch.Tensor, xi: torch.Tensor,
                            params: LoraParams):
    """Planar twin of models.modem.estimate_offsets (src/phy/phy.cpp:78-145;
    no argmax-index tie-break across osr phases): ``(cfo, time_offset)``."""
    return _estimate_planar(xr, xi, params.n, params.osr,
                            _window_tensor(params, xr.device), tie_break_idx=False)


def compensate_offsets_planar(xr: torch.Tensor, xi: torch.Tensor,
                              params: LoraParams, cfo, time_offset):
    """Planar twin of models.modem.compensate_offsets
    (src/phy/phy.cpp:147-176): derotate by the estimated CFO, then shift by
    the rounded integer timing offset with zero fill,
    ``out[..., j] = y[..., j - offset]``, as one gather. The reference
    skips the shift where ``|offset| >= count``. ``cfo`` and
    ``time_offset`` broadcast against the leading dims dimension by
    dimension (an offset batch smaller than the planes' pairs per row)."""
    n, osr = params.n, params.osr
    count = xr.shape[-1]
    dev = xr.device
    cfo = torch.as_tensor(cfo, dtype=torch.float32, device=dev)
    rate = -_TWO_PI_F32 * cfo / float(np.float32(n) * np.float32(osr))
    ph = rate[..., None] * torch.arange(count, dtype=torch.float32, device=dev)
    c, s = torch.cos(ph), torch.sin(ph)
    yr = xr * c - xi * s
    yi = xr * s + xi * c

    offset = _round_half_away(torch.as_tensor(
        time_offset, dtype=torch.float32, device=dev)).to(torch.int64)
    offset = torch.broadcast_to(offset, yr.shape[:-1])[..., None]
    src = torch.arange(count, device=dev) - offset          # [..., count]
    keep = (src >= 0) & (src < count)
    do_shift = offset.abs() < count
    idx = torch.where(do_shift, src.clamp(0, count - 1),
                      torch.arange(count, device=dev))
    keep = keep | ~do_shift
    zero = torch.zeros((), dtype=yr.dtype, device=dev)
    return (torch.where(keep, torch.gather(yr, -1, idx), zero),
            torch.where(keep, torch.gather(yi, -1, idx), zero))


def split_complex(x: torch.Tensor):
    """complex64 [..., L] -> (re, im) contiguous float32 planes."""
    return x.real.to(torch.float32).contiguous(), x.imag.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# Planar TX + dechirp
# ---------------------------------------------------------------------------

def modulate_planar(symbols: torch.Tensor, params: LoraParams,
                    amplitude: float = 1.0):
    """Symbols -> phase-continuous chirped (re, im) float32 planes with the
    2-symbol sync preamble (src/phy/LoRaMod.cpp:8-43).
    [..., S] -> ((re, im) [..., (S+2)*step])."""
    return modulate_symbols_planar(
        symbols, params.sf, params.osr, params.scale, amplitude,
        params.sync_word, params.continuous_chirp,
    )


def dechirp_planar(xr: torch.Tensor, xi: torch.Tensor, params: LoraParams):
    """Planar external dechirp — multiply every symbol period by the base
    downchirp (the working-path contract, tests/e2e_chain_test.cpp:80-93):
    on a CUDA tensor one pass of the hand kernel ``csrc/dechirp.cu``, on a
    CPU tensor its eager twin (:mod:`.dechirp`), bit-equal. Runs in the
    range ``planar.dechirp`` while a profiler runs."""
    with stage_range("planar.dechirp"):
        dr, di = device_table(base_downchirp_planar, params.sf, params.scale,
                              params.osr, device=xr.device)
        return dechirp(xr, xi, dr, di)
