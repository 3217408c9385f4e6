"""Fused dechirp-detection stage: per-row amplitude scale, CFO
derotation, N-point DFT, |.|² and first-max argmax in one kernel — the
counterpart of ``lora_phy_tpu/ops/pallas_demod.py`` (its Pallas
``_kernel``, with the caller's ``yr * scale`` folded in).

On a CUDA tensor :func:`fused_detect_rows` launches the hand-written
CUDA C++ kernel ``csrc/fused_demod.cu`` (built for sm_90a at first use,
see :mod:`.._build`); on a CPU tensor it runs the plain PyTorch twin
:func:`fused_detect_rows_reference`, which computes the same function
in torch ops. There is no other route: a CUDA call either launches the
kernel or raises. The kernel runs an FFT per row (twiddles from
:func:`_twiddles`); the twin keeps the JAX kernel's dense products, so
the two agree bin for bin except where two magnitudes lie within float32
rounding of each other.

Rows are symbol windows (batch x frames x symbols flattened), one bin
per row. Ties go to the lowest bin, as the Pallas kernel's
``min(where(mag == rowmax, col, N))`` and the reference's strict ``>``
scan (LoRaDetector.hpp:52-57).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import LoraParams, device_table
from ..models.modem import _window_table
from ..utils.profiling import launch_range

# Launches of the CUDA kernel in this process: one per call of
# fused_detect_rows on CUDA tensors, so a run can show that its main
# path went through the kernel.
LAUNCHES = 0

# N values the CUDA kernel is instantiated for (SF2-7: one thread per row
# at N <= 16, N / 16 threads per row above)
CUDA_N = (4, 8, 16, 32, 64, 128)


@functools.lru_cache(maxsize=16)
def _dft_tables(n: int, window_key):
    """[N, N] cos / -sin DFT tables with the window folded into the rows
    (a copy of the JAX module's builder)."""
    k = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, k) / n
    wr = np.cos(ang).astype(np.float32)
    wi = (-np.sin(ang)).astype(np.float32)
    if window_key is not None:
        w = np.asarray(window_key, dtype=np.float32)
        wr = wr * w[:, None]
        wi = wi * w[:, None]
    return wr, wi


@functools.lru_cache(maxsize=8)
def _twiddles(n: int) -> np.ndarray:
    """[N, 2] float32 twiddles ``(cos, -sin)(2*pi*m/N)`` of the kernel's
    FFT, computed in double, with exact 0 / +-1 at the quarter points
    (so the alternating-impulse tie between bins 0 and N/2 stays exact)."""
    ang = 2.0 * np.pi * np.arange(n) / n
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=-1)
    q = n // 4
    tw[0::q] = [(1.0, 0.0), (0.0, -1.0), (-1.0, 0.0), (0.0, 1.0)]
    return tw.astype(np.float32)


def _tables(params: LoraParams, device):
    window = _window_table(params)
    key = tuple(window) if window is not None else None
    return device_table(_dft_tables, params.n, key, device=device)


def reference_power(xr: torch.Tensor, xi: torch.Tensor, start: torch.Tensor,
                    rate_rows: torch.Tensor, params: LoraParams) -> torch.Tensor:
    """[B, N] |DFT(window * x * exp(j*(start + rate*col)))|², in torch ops."""
    wr, wi = _tables(params, xr.device)
    col = torch.arange(params.n, dtype=torch.float32, device=xr.device)
    ph = start[:, None] + rate_rows[:, None] * col
    c, s = torch.cos(ph), torch.sin(ph)
    fr = xr * c - xi * s
    fi = xr * s + xi * c
    zr = fr @ wr - fi @ wi
    zi = fr @ wi + fi @ wr
    return zr * zr + zi * zi


def fused_detect_rows_reference(xr: torch.Tensor, xi: torch.Tensor,
                                start: torch.Tensor, rate_rows: torch.Tensor,
                                params: LoraParams,
                                scale_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: [B, N] planar rows, times
    ``scale_rows`` ([B]) when given, -> [B] int32 first-max bins of
    :func:`reference_power` (``torch.argmax`` returns the first maximum)."""
    if scale_rows is not None:
        xr, xi = xr * scale_rows[:, None], xi * scale_rows[:, None]
    mag = reference_power(xr, xi, start, rate_rows, params)
    return torch.argmax(mag, dim=-1).to(torch.int32)


def _check_rows(operands, n):
    b = operands["xr"].shape[0]
    for name, t in operands.items():
        if t is None:
            continue
        shape = (b, n) if name in ("xr", "xi") else (b,)
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != operands["xr"].device:
            raise ValueError(f"{name} is on {t.device}, xr on {operands['xr'].device}")
        if t.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type == "cuda" and name in ("xr", "xi") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel "
                             f"reads rows as float4)")


def fused_detect_rows(xr: torch.Tensor, xi: torch.Tensor, start: torch.Tensor,
                      rate_rows: torch.Tensor, params: LoraParams,
                      scale_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Fused detection over [B, N] planar rows with per-row derotation
    phase ``start`` and per-sample ``rate_rows`` ([B] each), the rows
    multiplied first by ``scale_rows`` ([B]) when given. Returns [B]
    int32 argmax bins. N <= 128: the CUDA kernel takes every N of SF2-7."""
    global LAUNCHES
    n = params.n
    if n > 128:
        raise ValueError("fused kernel supports N <= 128; use the planar path")
    if xr.dim() != 2:
        raise ValueError(f"xr must be [B, N], got shape {tuple(xr.shape)}")
    _check_rows({"xr": xr, "xi": xi, "start": start, "rate_rows": rate_rows,
                 "scale_rows": scale_rows}, n)
    if xr.device.type == "cpu":
        return fused_detect_rows_reference(xr, xi, start, rate_rows, params, scale_rows)
    if xr.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {xr.device}")
    if n not in CUDA_N:
        raise ValueError(f"the CUDA kernel is built for N in {CUDA_N}, got {n}")

    from .._build import load_library

    lib = load_library()
    twiddle = device_table(_twiddles, n, device=xr.device)
    window = device_table(_window_table, params, device=xr.device)
    out = torch.empty(xr.shape[0], dtype=torch.int32, device=xr.device)
    with torch.cuda.device(xr.device), launch_range("fused_demod.launch"):
        stream = torch.cuda.current_stream(xr.device).cuda_stream
        rc = lib.lora_fused_demod(
            xr.data_ptr(), xi.data_ptr(), start.data_ptr(), rate_rows.data_ptr(),
            None if scale_rows is None else scale_rows.data_ptr(),
            None if window is None else window.data_ptr(),
            twiddle.data_ptr(), out.data_ptr(),
            ctypes.c_longlong(xr.shape[0]), ctypes.c_int(n), stream)
    if rc != 0:
        msg = lib.lora_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_demod kernel launch failed: CUDA error {rc} ({msg})")
    LAUNCHES += 1
    return out


def symbol_rows(yr: torch.Tensor, yi: torch.Tensor, rate: torch.Tensor,
                t_off: torch.Tensor, params: LoraParams,
                scale: torch.Tensor | None = None):
    """[..., S, N] symbol windows -> the kernel's contiguous operands:
    [B, N] rows, [B] ``start`` / ``rate_rows`` with the per-symbol phase
    ``start = rate*(s*N + t_off/osr)`` as in the JAX twin, and [B]
    ``scale_rows`` (the per-frame ``scale`` [...] broadcast, or None)."""
    n, osr = params.n, params.osr
    s_count = yr.shape[-2]
    s_idx = torch.arange(s_count, dtype=torch.float32, device=yr.device) * float(n)
    start = rate[..., None] * (
        s_idx + t_off.to(torch.float32)[..., None] / float(osr)
    )                                                      # [..., S]
    def per_row(v):
        return torch.broadcast_to(v[..., None], start.shape).reshape(-1).contiguous()

    return (yr.reshape(-1, n).contiguous(), yi.reshape(-1, n).contiguous(),
            start.reshape(-1).contiguous(), per_row(rate),
            None if scale is None else per_row(scale))


def fused_demod(yr: torch.Tensor, yi: torch.Tensor, rate: torch.Tensor,
                t_off: torch.Tensor, params: LoraParams,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """Fused per-symbol stage for demodulate_planar.

    ``yr, yi``: [..., S, N] gathered symbol windows; ``rate``: [...] f32;
    ``t_off``: [...] int; ``scale``: [...] f32 amplitude scale or None.
    Returns [..., S] int32 bins: those of the JAX ``fused_demod`` on
    ``yr * scale``, ``yi * scale``."""
    *rows, scale_rows = symbol_rows(yr, yi, rate, t_off, params, scale)
    bins = fused_detect_rows(*rows, params, scale_rows)
    return bins.reshape(yr.shape[:-1])
