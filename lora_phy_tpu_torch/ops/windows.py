"""Shifted symbol windows: the demodulator's guarded per-symbol timing
shift (src/phy/LoRaDemod.cpp:141-149) of both (re, im) planes, as
[..., S, N] decimated windows.

:func:`shifted_windows` reads ``(t_off == 0).all()`` once for both planes
(one host sync, :func:`..utils.profiling.host_sync`). Where every offset
is zero it returns views of the planes and copies nothing. Otherwise, on
a CUDA tensor it launches the hand-written CUDA C++ kernel
``csrc/windows.cu`` (built for sm_90a at first use, see :mod:`.._build`),
one pass that reads both planes once and writes both once; on a CPU
tensor it runs the plain PyTorch twin :func:`shifted_windows_reference`,
a padded copy, an index gather and a select per plane. There is no other
route: a CUDA call either launches the kernel or raises. The kernel is a
pure copy with zero fill, so the two give the same planes bit for bit.

The kernel reads the inputs through their strides and writes new
contiguous planes; the inputs are never written.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .._build import I64, PTR
from ..utils.profiling import host_sync

# the C entry point of csrc/windows.cu
ENTRY = ("lora_windows", (PTR, I64, I64) * 2 + (PTR,) * 3 + (I64,) * 5 + (PTR,))
# Launches of the CUDA kernel in this process: one per call of
# shifted_windows on CUDA tensors with a nonzero offset.
LAUNCHES = 0
# Calls of shifted_windows (any device) that returned views because every
# offset was zero.
ALIGNED = 0


def _symview(x: torch.Tensor, total_symbols: int, n: int, osr: int, dec_phase: int):
    return x.reshape(*x.shape[:-1], total_symbols, n, osr)[..., dec_phase]


def _shifted_rows(x: torch.Tensor, t_off: torch.Tensor, step: int) -> torch.Tensor:
    """Whole-row timing shift ``y[..., j] = x[..., j + t_off]`` with zero
    fill: one index gather into a copy of ``x`` padded by ``step`` on both
    sides (``t_off`` is [...] int, broadcast over the rows).

    Offsets beyond one symbol (only reachable through ``known_offsets``)
    follow the JAX twin's ``dynamic_slice``: a negative start counts from
    the end of the padded row, then the start is clamped into it."""
    count = x.shape[-1]
    padded = torch.nn.functional.pad(x, (step, step))
    flat = padded.reshape(-1, padded.shape[-1])
    start = t_off.to(torch.int64) + step
    start = torch.where(start < 0, start + padded.shape[-1], start)
    start = torch.clamp(start, 0, 2 * step)
    start = torch.broadcast_to(start, x.shape[:-1]).reshape(-1, 1)
    idx = start + torch.arange(count, device=x.device)
    return torch.gather(flat, 1, idx).reshape(x.shape)


def shifted_plane_reference(x: torch.Tensor, total_symbols: int, n: int, osr: int,
                            t_off: torch.Tensor, dec_phase: int = 0) -> torch.Tensor:
    """The twin on one [..., L] plane: [..., S, N] decimated windows, a
    symbol shifted by its row's ``t_off`` only where the shift stays in
    range, otherwise unshifted. ``dec_phase`` picks which of the ``osr``
    decimation phases to keep."""
    step = n * osr
    sample_count = total_symbols * step
    x = x[..., :sample_count]
    shifted = _shifted_rows(x, t_off, step)
    base = torch.arange(total_symbols, dtype=torch.int32, device=x.device) * step
    t = t_off[..., None].to(torch.int32)                   # [..., 1]
    use_shift = ((t > 0) & (base + t + step <= sample_count)) | (
        (t < 0) & (-t <= base)
    )                                                      # [..., S]
    return torch.where(use_shift[..., None],
                       _symview(shifted, total_symbols, n, osr, dec_phase),
                       _symview(x, total_symbols, n, osr, dec_phase))


def shifted_windows_reference(xr: torch.Tensor, xi: torch.Tensor, total_symbols: int,
                              n: int, osr: int, t_off: torch.Tensor, dec_phase: int = 0):
    """Plain PyTorch twin of the kernel: :func:`shifted_plane_reference`
    on each plane, as eager ops. Returns ``(yr, yi)``."""
    return tuple(shifted_plane_reference(x, total_symbols, n, osr, t_off, dec_phase)
                 for x in (xr, xi))


def _check_planes(xr: torch.Tensor, xi: torch.Tensor):
    for name, t in (("xr", xr), ("xi", xi)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if xi.shape != xr.shape or xi.device != xr.device:
        raise ValueError(f"xi is {tuple(xi.shape)} on {xi.device}, "
                         f"xr {tuple(xr.shape)} on {xr.device}")


def shifted_windows(xr: torch.Tensor, xi: torch.Tensor, total_symbols: int, n: int,
                    osr: int, t_off: torch.Tensor, dec_phase: int = 0):
    """[..., S, N] decimated symbol windows of both [..., L] planes, each
    symbol shifted by its row's ``t_off`` ([...] int, broadcast over the
    rows) where the shift stays in range (see the module). The planes
    must be float32 and of one shape. Returns ``(yr, yi)``: views of the
    planes where every offset is zero, else new contiguous planes."""
    global ALIGNED
    _check_planes(xr, xi)
    step = n * osr
    length = total_symbols * step
    xr, xi = xr[..., :length], xi[..., :length]
    aligned = (t_off == 0).all()
    with host_sync():
        aligned = bool(aligned)
    if aligned:
        ALIGNED += 1
        return (_symview(xr, total_symbols, n, osr, dec_phase),
                _symview(xi, total_symbols, n, osr, dec_phase))
    if xr.device.type == "cpu":
        return shifted_windows_reference(xr, xi, total_symbols, n, osr, t_off, dec_phase)
    return shifted_windows_kernel(xr, xi, total_symbols, n, osr, t_off, dec_phase)


def shifted_windows_kernel(xr: torch.Tensor, xi: torch.Tensor, total_symbols: int, n: int,
                           osr: int, t_off: torch.Tensor, dec_phase: int = 0):
    """Launch the kernel on float32 CUDA planes of one shape, whatever the
    offsets (no host sync): new contiguous ``(yr, yi)``, as
    :func:`shifted_windows_reference` gives them."""
    global LAUNCHES
    _check_planes(xr, xi)
    step = n * osr
    length = total_symbols * step
    lead = xr.shape[:-1]
    rows = math.prod(lead)
    # [rows, length] views: a lead that no single row stride spans is copied
    ar, ai = xr[..., :length].reshape(rows, length), xi[..., :length].reshape(rows, length)
    toff = torch.broadcast_to(t_off.to(device=xr.device, dtype=torch.int32),
                              lead).reshape(rows).contiguous()
    yr = torch.empty((*lead, total_symbols, n), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    _build.launch(ENTRY, xr.device, "windows.launch",
                  ar.data_ptr(), ar.stride(0), ar.stride(1),
                  ai.data_ptr(), ai.stride(0), ai.stride(1),
                  toff.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                  rows, total_symbols, n, osr, dec_phase)
    LAUNCHES += 1
    return yr, yi
