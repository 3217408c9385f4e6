"""The demodulator's per-symbol stage on the exact float32 route
(:func:`.planar.demodulate_planar` with ``fused=False`` and
``precision="f32"``): every symbol window derotated by its frame's
``exp(j*rate*i)``, with the amplitude scale and the window folded into
the rotation factors, then the N-point DFT, |.|² and the first-max bin.

On a CUDA tensor at N = 256..4096 :func:`decide_rows` launches the
hand-written CUDA C++ kernel ``csrc/decide.cu`` (built for sm_90a at
first use, see :mod:`.._build`), one pass that reads both planes once and
writes one bin a row; on a CPU tensor, and at N <= 128 on any device, it
runs the plain PyTorch twin :func:`decide_reference`: the rotation
planes, the derotated planes and the planar DFT's argmax
(:func:`.fft._argmax_bins_ops`, the torch four-step above N = 128). The
kernel's derotated samples are the twin's floats; its FFT rounds
otherwise than the twin's four-step, so the two give the same bins except
where a row's two largest powers lie within float32 rounding of each
other. Both give a tie to the lowest natural bin.

The rotation helpers live here, below :mod:`.planar`, which uses them on
its other routes too (the bf16 kernel's rotation planes, the spectra).
The kernel reads the planes through their strides and never writes them.
"""

from __future__ import annotations

import math

import torch

from .. import LoraParams, _build, device_table
from .._build import I32, I64, PTR
from ..utils.params import _window_table
from .fft import _argmax_bins_ops
from .fused_demod import _twiddles

# the C entry point of csrc/decide.cu
ENTRY = ("lora_decide", (PTR, I64, I64, I64) * 2 + (PTR,) * 5 + (I64, I64, I32, PTR))
# Launches of the CUDA kernel in this process: one per call of
# decide_rows on CUDA tensors at N = 256..4096.
LAUNCHES = 0


def _derotation_vector(rate: torch.Tensor, n: int):
    """Per-sample CFO derotation ``exp(j*rate*i)`` over [..., N], broadcast
    over the symbol axis by the caller, as its (cos, sin) planes (the JAX
    twin ``lora_phy_tpu/models/modem.py:_derotation_vector`` returns the
    complex vector; the planar pipeline takes the planes and so makes no
    complex copy). The reference's per-symbol constant phase ``rate*(s*N +
    t_off/osr)`` (src/phy/LoRaDemod.cpp:151-152) leaves every magnitude
    unchanged and is dropped, as in the JAX twin."""
    phi = rate[..., None] * torch.arange(n, dtype=torch.float32, device=rate.device)
    return torch.cos(phi), torch.sin(phi)


def _rotated_windows_planar(yr: torch.Tensor, yi: torch.Tensor,
                            rate: torch.Tensor, t_off: torch.Tensor, scale,
                            params: LoraParams):
    """Derotation with the scale and the window folded into the rotation
    factors: the pre-DFT [..., S, N] planes. Only the per-sample
    ``exp(j*rate*i)`` factor is applied — the per-symbol constant phase
    ``rate*(s*N + t_off/osr)`` leaves every magnitude unchanged, so
    ``t_off`` is accepted for signature stability only (see the JAX twin)."""
    del t_off
    cr, si_ = _rotation_planes(rate, scale, params)
    cr = cr[..., None, :]
    si_ = si_[..., None, :]
    fr = yr * cr - yi * si_
    fi = yr * si_ + yi * cr
    return fr, fi


def _rotation_planes(rate: torch.Tensor, scale, params: LoraParams):
    """The [..., N] (cos, sin) rotation planes of one frame, times the
    amplitude ``scale`` ([...] or None) and the window."""
    cr, si_ = _derotation_vector(rate, params.n)              # [..., N]
    if scale is not None:
        cr = cr * scale[..., None]
        si_ = si_ * scale[..., None]
    window = device_table(_window_table, params, device=rate.device)
    if window is not None:
        cr, si_ = cr * window, si_ * window
    return cr, si_


def decide_reference(yr: torch.Tensor, yi: torch.Tensor, rate: torch.Tensor, scale,
                     params: LoraParams) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, the route's ops before it:
    :func:`_rotated_windows_planar`, then the planar DFT's first-max
    argmax. [..., S, N] planes in, [..., S] int32 bins out."""
    fr, fi = _rotated_windows_planar(yr, yi, rate, None, scale, params)
    return _argmax_bins_ops(fr, fi, params.n)


def _check(yr, yi, rate, scale, n):
    named = (("yr", yr), ("yi", yi), ("rate", rate)) + ((("scale", scale),) if scale is not None
                                                       else ())
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != yr.device:
            raise ValueError(f"{name} is on {t.device}, yr on {yr.device}")
    if yi.shape != yr.shape or yr.dim() < 2 or yr.shape[-1] != n:
        raise ValueError(f"yr and yi must be [..., S, {n}] planes of one shape, got "
                         f"{tuple(yr.shape)} and {tuple(yi.shape)}")
    if n < 256 or n > 4096 or n & (n - 1):
        raise ValueError(f"no decide kernel for n={n} (a power of two in 256..4096)")
    lead = yr.shape[:-2]
    for name, t in named[2:]:
        # broadcasts to the frames (torch.broadcast_shapes takes seconds on
        # its first call in a process)
        fits = t.dim() <= len(lead) and all(
            a in (1, b) for a, b in zip(reversed(t.shape), reversed(lead)))
        if not fits:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, which does not broadcast "
                             f"to the frames {tuple(lead)}")


def decide_rows(yr: torch.Tensor, yi: torch.Tensor, rate: torch.Tensor, scale,
                params: LoraParams) -> torch.Tensor:
    """The first-max bin of every derotated symbol window: ``yr, yi``
    [..., S, N] window planes, ``rate`` [...] radians a sample and
    ``scale`` [...] amplitude scales (or None), one a frame; returns
    [..., S] int32. On CUDA at N = 256..4096 the kernel (float32 planes
    of one shape, ``rate`` and ``scale`` float32), else the twin."""
    global LAUNCHES
    n = params.n
    if yr.device.type == "cpu" or n <= 128:
        return decide_reference(yr, yi, rate, scale, params)
    _check(yr, yi, rate, scale, n)
    lead, rows = yr.shape[:-2], yr.shape[-2]
    frames = math.prod(lead)
    # [frames, S, N] views: a lead that no single frame stride spans is copied
    ar, ai = yr.reshape(frames, rows, n), yi.reshape(frames, rows, n)

    def per_frame(t):
        return torch.broadcast_to(t, lead).reshape(frames).contiguous()

    rate_f = per_frame(rate)
    scale_f = None if scale is None else per_frame(scale)
    window = device_table(_window_table, params, device=yr.device)
    twiddle = device_table(_twiddles, n, device=yr.device)
    out = torch.empty((frames, rows), dtype=torch.int32, device=yr.device)
    _build.launch(ENTRY, yr.device, "decide.launch",
                  ar.data_ptr(), ar.stride(0), ar.stride(1), ar.stride(2),
                  ai.data_ptr(), ai.stride(0), ai.stride(1), ai.stride(2),
                  rate_f.data_ptr(), None if scale_f is None else scale_f.data_ptr(),
                  None if window is None else window.data_ptr(), twiddle.data_ptr(),
                  out.data_ptr(), frames, rows, n)
    LAUNCHES += 1
    return out.reshape(yr.shape[:-1])
