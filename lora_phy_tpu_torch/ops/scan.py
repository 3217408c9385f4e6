"""The per-window part of the gateway's two-sided dechirp scan
(:func:`..models.sync.frame_sync_scan_planar`): every symbol window of
the (re, im) planes up-dechirped (times the base downchirp) and
down-dechirped (times its conjugate), decimated, DFT'd, and the first-max
bin and peak power of each direction.

On a CUDA tensor :func:`scan_peaks` launches the hand-written CUDA C++
kernel ``csrc/scan.cu`` (built for sm_90a at first use, see
:mod:`.._build`), one pass that reads both planes once and writes four
values a window; on a CPU tensor it runs the plain PyTorch twin
:func:`scan_peaks_reference`: four dechirp planes, two stacks and the
planar DFT's argmax (:func:`.fft._argmax_bins_ops`). There is no other
route: a CUDA call either launches the kernel or raises. The kernel's
dechirped samples are the twin's floats bit for bit; its FFT rounds
otherwise than the twin's dense sums, so the two give the same bins
except where a window's two largest powers lie within float32 rounding
of each other. Both give a tie to the lowest natural bin.

:func:`scan_spectra` returns both directions' whole |DFT|², which the
accumulated-spectrum scan (``pre_acc`` > 1) sums over windows; it runs
in torch ops on every device.

The kernel reads the planes through their strides and never writes them;
the tail of a row past its last whole window is not read.
"""

from __future__ import annotations

import math

import torch

from .. import _build, device_table
from .._build import I32, I64, PTR
from .fft import _argmax_bins_ops, dft_mag2_planar
from .fused_demod import _twiddles

# the C entry point of csrc/scan.cu
ENTRY = ("lora_scan", (PTR, I64, I64) * 2 + (PTR,) * 7 + (I64, I64, I32, I32, I32, PTR))
# Launches of the CUDA kernel in this process: one per call of scan_peaks
# on CUDA tensors.
LAUNCHES = 0
# Calls of scan_spectra (any device): the scans that need whole spectra
# (pre_acc > 1) and so keep the torch ops.
SPECTRA = 0


def dechirped_windows(xr: torch.Tensor, xi: torch.Tensor, dr: torch.Tensor,
                      di: torch.Tensor, n: int, osr: int, dph: int):
    """[..., W, N] decimated windows of the [..., T] planes, up-dechirped
    (``x * down``) and down-dechirped (``x * conj(down)``) by the [step]
    downchirp ``(dr, di)``, as eager ops: ``(ur, ui, vr, vi)``. ``dph``
    picks the decimation phase of the ``osr``."""
    step = n * osr
    nwin = xr.shape[-1] // step
    lead = xr.shape[:-1]
    ar = xr[..., : nwin * step].reshape(*lead, nwin, step)
    ai = xi[..., : nwin * step].reshape(*lead, nwin, step)

    def windows(pr, pi):
        return (pr.reshape(*lead, nwin, n, osr)[..., dph],
                pi.reshape(*lead, nwin, n, osr)[..., dph])

    ur, ui = windows(ar * dr - ai * di, ar * di + ai * dr)
    vr, vi = windows(ar * dr + ai * di, ai * dr - ar * di)
    return ur, ui, vr, vi


def scan_peaks_reference(xr: torch.Tensor, xi: torch.Tensor, dr: torch.Tensor,
                         di: torch.Tensor, n: int, osr: int, dph: int):
    """Plain PyTorch twin of the kernel: both directions' windows through
    ONE stacked DFT and first-max argmax. Returns ``(ub, db, up_peak,
    dn_peak)``, [..., W] int32 bins and float32 peak powers."""
    ur, ui, vr, vi = dechirped_windows(xr, xi, dr, di, n, osr, dph)
    bins, peaks = _argmax_bins_ops(torch.stack([ur, vr]), torch.stack([ui, vi]), n,
                                   with_peak=True)
    return bins[0], bins[1], peaks[0], peaks[1]


def scan_spectra(xr: torch.Tensor, xi: torch.Tensor, dr: torch.Tensor, di: torch.Tensor,
                 n: int, osr: int, dph: int):
    """Both directions' [..., W, N] |DFT|² in natural bin order, in torch
    ops on any device: ``(m_up, m_dn)``. Counted in ``SPECTRA``."""
    global SPECTRA
    ur, ui, vr, vi = dechirped_windows(xr, xi, dr, di, n, osr, dph)
    m = dft_mag2_planar(torch.stack([ur, vr]), torch.stack([ui, vi]), n)
    SPECTRA += 1
    return m[0], m[1]


def _check(xr, xi, dr, di, n, osr, dph):
    for name, t in (("xr", xr), ("xi", xi), ("dr", dr), ("di", di)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != xr.device:
            raise ValueError(f"{name} is on {t.device}, xr on {xr.device}")
    if xi.shape != xr.shape or xr.dim() < 1:
        raise ValueError(f"xi has shape {tuple(xi.shape)}, xr {tuple(xr.shape)}")
    if n < 4 or n > 4096 or n & (n - 1) or osr < 1 or not 0 <= dph < osr:
        raise ValueError(f"no scan kernel for n={n}, osr={osr}, dph={dph} "
                         "(n a power of two in 4..4096, 0 <= dph < osr)")
    step = n * osr
    if dr.shape != (step,) or di.shape != (step,) or not (dr.is_contiguous()
                                                           and di.is_contiguous()):
        raise ValueError(f"dr and di must be contiguous [{step}] planes")


def scan_peaks(xr: torch.Tensor, xi: torch.Tensor, dr: torch.Tensor, di: torch.Tensor,
               n: int, osr: int, dph: int):
    """The first-max bin and peak power of both directions' DFT in every
    window of the [..., T] planes (windows of ``step = n * osr`` samples,
    decimated at phase ``dph``), against the [step] downchirp ``(dr,
    di)``: ``(ub, db, up_peak, dn_peak)``, [..., W] each, ``W = T //
    step``. On CUDA the planes must be float32 and of one shape."""
    global LAUNCHES
    if xr.device.type == "cpu":
        return scan_peaks_reference(xr, xi, dr, di, n, osr, dph)
    _check(xr, xi, dr, di, n, osr, dph)
    lead, length = xr.shape[:-1], xr.shape[-1]
    nwin = length // (n * osr)
    rows = math.prod(lead)
    # [rows, T] views: a lead that no single row stride spans is copied
    ar, ai = xr.reshape(rows, length), xi.reshape(rows, length)
    twiddle = device_table(_twiddles, n, device=xr.device)
    ub = torch.empty((rows, nwin), dtype=torch.int32, device=xr.device)
    db = torch.empty_like(ub)
    up = torch.empty((rows, nwin), dtype=torch.float32, device=xr.device)
    dn = torch.empty_like(up)
    _build.launch(ENTRY, xr.device, "scan.launch",
                  ar.data_ptr(), ar.stride(0), ar.stride(1),
                  ai.data_ptr(), ai.stride(0), ai.stride(1),
                  dr.data_ptr(), di.data_ptr(), twiddle.data_ptr(),
                  ub.data_ptr(), db.data_ptr(), up.data_ptr(), dn.data_ptr(),
                  rows, nwin, n, osr, dph)
    LAUNCHES += 1
    shape = (*lead, nwin)
    return ub.reshape(shape), db.reshape(shape), up.reshape(shape), dn.reshape(shape)
