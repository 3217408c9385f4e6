"""The per-lane spectra of the gateway's circular block receiver
(:func:`..models.sync._receive_block_circular`, its ``demod`` and ``sro``
stages): every lane's sync and payload rows derotated by the lane's
residual CFO at the true sample index ``(j - q) mod n`` of their section,
the N-point DFT, |.|² and the first-max bin; of the payload rows also the
peak power and the power sum (the SNR estimate), and of the payload rows
as they are, before the derotation, the first-max bin and the powers at
it and its two circular neighbours (the clock-drift estimate,
:func:`.planar.sro_from_powers`).

On a CUDA tensor at N = 256..4096 :func:`lane_spectra` launches the
hand-written CUDA C++ kernel ``csrc/lanes.cu`` (built for sm_90a at first
use, see :mod:`.._build`), one pass that reads every row once and writes a
few values a row, both stages' transforms in one launch. On a CPU tensor,
at N <= 128 on any device, and when the caller wants the payload spectra
themselves (``with_spectra``), it runs the plain PyTorch twin
:func:`lane_spectra_reference`: the rotation planes, the derotated rows,
their cat and the planar DFT's |.|² plane (the torch four-step above
N = 128), its argmax, maxima and sums; the twin leaves the clock-drift
DFT to the ``sro`` stage (:func:`.planar.estimate_sro_planar`). The
kernel's derotated samples are the twin's floats; its FFT rounds
otherwise than the twin's four-step, so the two give the same bins except
where a row's two largest powers lie within float32 rounding of each
other, and the powers and sums within rounding. Both give a tie to the
lowest natural bin.

The kernel reads the rows through their strides and never writes them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import LoraParams, _build, device_table
from .._build import I32, I64, PTR
from .fft import dft_mag2_planar
from .fused_demod import _twiddles
from .planar import sro_peak_powers

# the C entry point of csrc/lanes.cu
ENTRY = ("lora_lanes", (PTR, I64, I64, I64) * 4 + (PTR,) * 9 + (I64, I32, I32, I32, PTR))
# Launches of the CUDA kernel in this process: one per call of
# lane_spectra on CUDA tensors at N = 256..4096 without the spectra.
LAUNCHES = 0


class LaneSpectra(NamedTuple):
    """What the receiver reads of each lane's rows (``[..., K]`` lanes,
    ``R`` sync rows, ``S`` payload rows)."""
    raw: torch.Tensor            # [..., K, R + S] int32 first-max bin of each derotated row
    peak: torch.Tensor           # [..., K, S] float32 the derotated payload rows' peak power
    total: torch.Tensor          # [..., K, S] float32 their power sums
    sro: tuple | None            # (index, left, peak, right) [..., K, S] of the raw payload
    #                              rows (planar.sro_peak_powers); None where the sro stage
    #                              takes its own DFT (the twin's route)
    spectra: torch.Tensor | None  # [..., K, S, n] the derotated payload rows' |DFT|² (twin)


def derotated_rows(sync_r: torch.Tensor, sync_i: torch.Tensor, pay_r: torch.Tensor,
                   pay_i: torch.Tensor, rate: torch.Tensor, q: torch.Tensor, q_p: torch.Tensor,
                   n: int):
    """The twin's derotated rows, the sync rows first: the ``[..., K, n]``
    rotation planes at the true index of each section, the products, the
    cat; ``(fr, fi)`` [..., K, R + S, n]. The kernel's samples up to its
    FFT are these floats."""
    jj = torch.arange(n, dtype=torch.int32, device=sync_r.device)

    def rot_factor(qs):
        qs = qs[..., None]
        idx_true = (jj - qs + torch.where(jj < qs, n, 0)).to(torch.float32)
        ph = rate[..., None] * idx_true
        return torch.cos(ph), torch.sin(ph)            # [..., K, n]

    def rot(a_r, a_i, c_, s_):
        c_, s_ = c_[..., None, :], s_[..., None, :]
        return a_r * c_ - a_i * s_, a_r * s_ + a_i * c_

    ca, sa = rot_factor(q)
    cb, sb_ = rot_factor(q_p)
    sy_r, sy_i = rot(sync_r, sync_i, ca, sa)
    pl_r, pl_i = rot(pay_r, pay_i, cb, sb_)
    return torch.cat([sy_r, pl_r], dim=-2), torch.cat([sy_i, pl_i], dim=-2)


def lane_spectra_reference(sync_r: torch.Tensor, sync_i: torch.Tensor, pay_r: torch.Tensor,
                           pay_i: torch.Tensor, rate: torch.Tensor, q: torch.Tensor,
                           q_p: torch.Tensor, params: LoraParams, with_sro: bool = True,
                           with_spectra: bool = False) -> LaneSpectra:
    """Plain PyTorch twin of the kernel, the stages' ops before it:
    :func:`derotated_rows`, the planar DFT's |.|², its argmax, and the
    payload rows' maxima and sums; with ``with_sro`` the raw payload
    rows' DFT side of the clock-drift estimate
    (:func:`.planar.sro_peak_powers`); with ``with_spectra`` the payload
    |.|² plane too."""
    n = params.n
    fr, fi = derotated_rows(sync_r, sync_i, pay_r, pay_i, rate, q, q_p, n)
    mag2 = dft_mag2_planar(fr, fi, n)                  # [..., K, R+S, n]
    raw = torch.argmax(mag2, dim=-1).to(torch.int32)
    mag2_pay = mag2[..., sync_r.shape[-2]:, :]
    sro = None
    if with_sro:
        lead = pay_r.shape[:-2]
        sro = sro_peak_powers(pay_r.reshape(*lead, -1), pay_i.reshape(*lead, -1), params)
    return LaneSpectra(raw, mag2_pay.amax(dim=-1), torch.sum(mag2_pay, dim=-1), sro,
                       mag2_pay if with_spectra else None)


def _check(sync_r, sync_i, pay_r, pay_i, rate, q, q_p, n):
    for name, t, dtype in (("sync_r", sync_r, torch.float32), ("sync_i", sync_i, torch.float32),
                           ("pay_r", pay_r, torch.float32), ("pay_i", pay_i, torch.float32),
                           ("rate", rate, torch.float32), ("q", q, torch.int32),
                           ("q_p", q_p, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {str(dtype).removeprefix('torch.')}, got {t.dtype}")
        if t.device != sync_r.device:
            raise ValueError(f"{name} is on {t.device}, sync_r on {sync_r.device}")
    if n < 256 or n > 4096 or n & (n - 1):
        raise ValueError(f"no lanes kernel for n={n} (a power of two in 256..4096)")
    if (sync_r.dim() < 2 or sync_i.shape != sync_r.shape or pay_i.shape != pay_r.shape
            or sync_r.shape[-1] != n or pay_r.shape[-1] != n
            or sync_r.shape[:-2] != pay_r.shape[:-2]):
        raise ValueError(f"sync_r, sync_i must be [..., K, R, {n}] and pay_r, pay_i "
                         f"[..., K, S, {n}] planes of the same lanes, got "
                         f"{tuple(sync_r.shape)}, {tuple(sync_i.shape)}, "
                         f"{tuple(pay_r.shape)} and {tuple(pay_i.shape)}")
    lead = sync_r.shape[:-2]
    for name, t in (("rate", rate), ("q", q), ("q_p", q_p)):
        if t.shape != lead:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, not the lanes' "
                             f"{tuple(lead)}")


def lane_spectra(sync_r: torch.Tensor, sync_i: torch.Tensor, pay_r: torch.Tensor,
                 pay_i: torch.Tensor, rate: torch.Tensor, q: torch.Tensor, q_p: torch.Tensor,
                 params: LoraParams, with_spectra: bool = False) -> LaneSpectra:
    """Every lane's rows as the receiver's ``demod`` and ``sro`` stages
    read them: ``sync_r, sync_i`` [..., K, R, n] and ``pay_r, pay_i``
    [..., K, S, n] dechirped rows, ``rate`` [..., K] the derotation's
    radians a sample, ``q`` and ``q_p`` [..., K] the sync and payload
    rows' offsets into their grid windows (0 <= q < n). On CUDA at
    N = 256..4096 without ``with_spectra`` the kernel (float32 rows,
    ``rate`` float32, ``q`` and ``q_p`` int32), whose result holds the
    clock-drift side too; else the twin, without it."""
    global LAUNCHES
    n = params.n
    if sync_r.device.type == "cpu" or n <= 128 or with_spectra:
        return lane_spectra_reference(sync_r, sync_i, pay_r, pay_i, rate, q, q_p, params,
                                      with_sro=False, with_spectra=with_spectra)
    _check(sync_r, sync_i, pay_r, pay_i, rate, q, q_p, n)
    lead, rs, s = sync_r.shape[:-2], sync_r.shape[-2], pay_r.shape[-2]
    frames = math.prod(lead)
    # [frames, rows, n] views: a lead that no single lane stride spans is copied
    sr, si = sync_r.reshape(frames, rs, n), sync_i.reshape(frames, rs, n)
    pr, pi = pay_r.reshape(frames, s, n), pay_i.reshape(frames, s, n)
    rate_f = rate.reshape(frames).contiguous()
    q_f, qp_f = q.reshape(frames).contiguous(), q_p.reshape(frames).contiguous()
    twiddle = device_table(_twiddles, n, device=sync_r.device)
    dev = sync_r.device
    bins = torch.empty((frames, rs + s), dtype=torch.int32, device=dev)
    peak = torch.empty((frames, s), dtype=torch.float32, device=dev)
    total = torch.empty_like(peak)
    sro_bin = torch.empty((frames, s), dtype=torch.int32, device=dev)
    sro_pow = torch.empty((frames, s, 3), dtype=torch.float32, device=dev)
    _build.launch(ENTRY, dev, "lanes.launch",
                  *(v for a in (sr, si, pr, pi)
                    for v in (a.data_ptr(), a.stride(0), a.stride(1), a.stride(2))),
                  rate_f.data_ptr(), q_f.data_ptr(), qp_f.data_ptr(), twiddle.data_ptr(),
                  bins.data_ptr(), peak.data_ptr(), total.data_ptr(), sro_bin.data_ptr(),
                  sro_pow.data_ptr(), frames, rs, s, n)
    LAUNCHES += 1
    pay = (*lead, s)
    sro = (sro_bin.reshape(pay), *(sro_pow[..., i].reshape(pay) for i in range(3)))
    return LaneSpectra(bins.reshape(*lead, rs + s), peak.reshape(pay), total.reshape(pay),
                       sro, None)
