"""FFT-based symbol detection on complex64, batched — the PyTorch twin
of ``lora_phy_tpu/ops/detect.py`` (reference:
include/lora_phy/LoRaDetector.hpp:39-74).

Same semantics as the JAX twin: argmax over |X|^2 with the first maximum
winning (``torch.argmax`` returns the first occurrence, as the reference's
strict ``>`` scan); fundamental and noise power in dB with the
``20*log10(N)`` scale; the fractional bin
``0.5*(right-left)/(2*peak-right-left)`` with circular neighbours and a
divide-by-zero guard.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .fft import fft as _fft


class Detection(NamedTuple):
    """Per-symbol detector outputs (leading dims = batch/symbol axes)."""

    index: torch.Tensor       # argmax bin, int32
    power: torch.Tensor       # fundamental power, dB
    power_avg: torch.Tensor   # residual (noise) power, dB
    findex: torch.Tensor      # fractional-bin offset
    peak_bin: torch.Tensor    # complex DFT value at the peak
    spectrum: torch.Tensor    # full DFT output [..., N]


def detect(fft_in: torch.Tensor, backend: str = "xla") -> Detection:
    """Run the detector over the last axis of ``fft_in`` ([..., N] complex64)."""
    n = fft_in.shape[-1]
    return detect_from_spectrum(_fft(fft_in, backend=backend), n)


def detect_from_spectrum(spectrum: torch.Tensor, n: int) -> Detection:
    mag2 = spectrum.real * spectrum.real + spectrum.imag * spectrum.imag
    index = torch.argmax(mag2, dim=-1)
    max_value = torch.gather(mag2, -1, index[..., None])[..., 0]
    total = torch.sum(mag2, dim=-1)
    noise = torch.sqrt(torch.clamp(total - max_value, min=0.0))
    fundamental = torch.sqrt(max_value)
    power_scale = 20.0 * torch.log10(torch.tensor(float(n), device=spectrum.device))
    power_avg = 20.0 * torch.log10(noise) - power_scale
    power = 20.0 * torch.log10(fundamental) - power_scale

    left_ix = torch.where(index > 0, index - 1, n - 1)[..., None]
    right_ix = torch.where(index < n - 1, index + 1, 0)[..., None]
    left = torch.abs(torch.gather(spectrum, -1, left_ix)[..., 0])
    right = torch.abs(torch.gather(spectrum, -1, right_ix)[..., 0])
    denom = 2.0 * fundamental - right - left
    findex = torch.where(denom == 0.0, torch.zeros_like(denom),
                         0.5 * (right - left) / denom)
    peak_bin = torch.gather(spectrum, -1, index[..., None])[..., 0]
    return Detection(index.to(torch.int32), power, power_avg, findex,
                     peak_bin, spectrum)
