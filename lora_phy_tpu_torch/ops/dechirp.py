"""Planar dechirp: every symbol period of the (re, im) planes times the
base downchirp, ``yr = xr*dr - xi*di``, ``yi = xr*di + xi*dr``.

On a CUDA tensor :func:`dechirp` launches the hand-written CUDA C++
kernel ``csrc/dechirp.cu`` (built for sm_90a at first use, see
:mod:`.._build`), one pass that reads both planes once and writes both
once; on a CPU tensor it runs the plain PyTorch twin
:func:`dechirp_reference`, the four products and two sums as eager ops.
There is no other route: a CUDA call either launches the kernel or
raises. The kernel rounds each product and each sum on its own, as the
eager ops do, so the two give the same planes bit for bit.

The kernel reads the inputs through their strides (a slice of longer
rows, a complex tensor's ``.real`` / ``.imag`` view, an offset view) and
writes new contiguous planes; the inputs are never written.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .._build import I64, PTR

# the C entry point of csrc/dechirp.cu
ENTRY = ("lora_dechirp", (PTR, I64, I64) * 2 + (PTR,) * 4 + (I64,) * 3 + (PTR,))
# Launches of the CUDA kernel in this process: one per call of dechirp on
# CUDA tensors, so a run can show that its path went through the kernel.
LAUNCHES = 0


def dechirp_reference(xr: torch.Tensor, xi: torch.Tensor, dr: torch.Tensor,
                      di: torch.Tensor):
    """Plain PyTorch twin of the kernel: [..., L] planes times the [step]
    downchirp ``(dr, di)`` over each whole symbol period, as eager ops.
    Returns [..., nsym*step] planes (the tail past the last whole period
    is dropped)."""
    step = dr.shape[-1]
    nsym = xr.shape[-1] // step
    lead = xr.shape[:-1]
    ar = xr[..., : nsym * step].reshape(*lead, nsym, step)
    ai = xi[..., : nsym * step].reshape(*lead, nsym, step)
    yr = ar * dr - ai * di
    yi = ar * di + ai * dr
    return (yr.reshape(*lead, nsym * step), yi.reshape(*lead, nsym * step))


def dechirp(xr: torch.Tensor, xi: torch.Tensor, dr: torch.Tensor, di: torch.Tensor):
    """Dechirp [..., L] planes by the [step] downchirp ``(dr, di)``; returns
    contiguous [..., nsym*step] planes, ``nsym = L // step``. On CUDA the
    planes must be float32 and of one shape."""
    global LAUNCHES
    if xr.device.type == "cpu":
        return dechirp_reference(xr, xi, dr, di)
    for name, t in (("xr", xr), ("xi", xi), ("dr", dr), ("di", di)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != xr.device:
            raise ValueError(f"{name} is on {t.device}, xr on {xr.device}")
    if xi.shape != xr.shape:
        raise ValueError(f"xi has shape {tuple(xi.shape)}, xr {tuple(xr.shape)}")
    step = dr.shape[-1]
    if dr.shape != (step,) or di.shape != (step,) or not (dr.is_contiguous()
                                                           and di.is_contiguous()):
        raise ValueError("dr and di must be contiguous [step] planes")
    lead, length = xr.shape[:-1], (xr.shape[-1] // step) * step
    rows = math.prod(lead)
    # [rows, length] views: a lead that no single row stride spans is copied
    ar = xr[..., :length].reshape(rows, length)
    ai = xi[..., :length].reshape(rows, length)
    yr = torch.empty(ar.shape, dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    _build.launch(ENTRY, xr.device, "dechirp.launch",
                  ar.data_ptr(), ar.stride(0), ar.stride(1),
                  ai.data_ptr(), ai.stride(0), ai.stride(1),
                  dr.data_ptr(), di.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                  rows, length, step)
    LAUNCHES += 1
    return yr.reshape(*lead, length), yi.reshape(*lead, length)
