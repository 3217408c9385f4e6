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

import ctypes
import math

import torch

from ..utils.profiling import launch_range

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
    if xr.device.type != "cuda":
        raise ValueError(f"no dechirp kernel for device {xr.device}")
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

    from .._build import load_library

    lib = load_library()
    lead, length = xr.shape[:-1], (xr.shape[-1] // step) * step
    rows = math.prod(lead)
    # [rows, length] views: a lead that no single row stride spans is copied
    ar = xr[..., :length].reshape(rows, length)
    ai = xi[..., :length].reshape(rows, length)
    yr = torch.empty(ar.shape, dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    i64 = ctypes.c_longlong
    with torch.cuda.device(xr.device), launch_range("dechirp.launch"):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        rc = lib.lora_dechirp(
            ar.data_ptr(), i64(ar.stride(0)), i64(ar.stride(1)),
            ai.data_ptr(), i64(ai.stride(0)), i64(ai.stride(1)),
            dr.data_ptr(), di.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            i64(rows), i64(length), i64(step), stream)
    if rc != 0:
        msg = lib.lora_cuda_error_string(rc).decode()
        raise RuntimeError(f"dechirp kernel launch failed: CUDA error {rc} ({msg})")
    LAUNCHES += 1
    return yr.reshape(*lead, length), yi.reshape(*lead, length)
