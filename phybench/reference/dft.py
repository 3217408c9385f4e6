"""The DFT of the plain reference, as a product with the dense DFT matrix,
in one of three precisions:

``f64``   float64 throughout: the reference itself;
``f32``   float32 throughout, the matrix products in exact float32;
``tf32``  float32, every matrix-product operand rounded to TF32 (10
          mantissa bits, to nearest even) and the products summed in
          float32: what a float32 product on the tensor cores computes
          with TF32 on. Emulated, so it is the same on the CPU and the
          card, whatever ``torch.backends.cuda.matmul.allow_tf32`` says.

``tf32`` is the control: the reference one precision step below the
float32 that the configurations state, in the program's place.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

PRECISIONS = ("f64", "f32", "tf32")


def real_dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}: {PRECISIONS}")
    return torch.float64 if precision == "f64" else torch.float32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@functools.lru_cache(maxsize=8)
def _tables(n: int):
    k = np.arange(n)
    ang = 2.0 * math.pi * np.outer(k, k) / n
    return np.cos(ang), -np.sin(ang)


def dft(xr: torch.Tensor, xi: torch.Tensor, precision: str):
    """(re, im) of the DFT over the last axis."""
    n = xr.shape[-1]
    dt = real_dtype(precision)
    wr, wi = (torch.as_tensor(t, device=xr.device).to(dt) for t in _tables(n))
    ar, ai = xr.to(dt).reshape(-1, n), xi.to(dt).reshape(-1, n)
    if precision == "tf32":
        ar, ai, wr, wi = (tf32_round(t) for t in (ar, ai, wr, wi))
    yr = ar @ wr - ai @ wi
    yi = ar @ wi + ai @ wr
    return yr.reshape(xr.shape), yi.reshape(xr.shape)


def mag2(xr: torch.Tensor, xi: torch.Tensor, precision: str) -> torch.Tensor:
    yr, yi = dft(xr, xi, precision)
    return yr * yr + yi * yi


def peak_detect(xr, xi, precision: str):
    """Per row: (spectrum |X|^2, first-max bin, the fractional bin
    ``0.5 (r - l) / (2 p - r - l)`` from the magnitudes at the peak and
    its circular neighbours (0 where the denominator is 0), the phase of
    the peak)."""
    yr, yi = dft(xr, xi, precision)
    m = yr * yr + yi * yi
    n = m.shape[-1]
    idx = torch.argmax(m, dim=-1)
    peak = torch.sqrt(m.amax(dim=-1))
    left = torch.sqrt(torch.gather(m, -1, ((idx - 1) % n)[..., None])[..., 0])
    right = torch.sqrt(torch.gather(m, -1, ((idx + 1) % n)[..., None])[..., 0])
    den = 2.0 * peak - right - left
    frac = torch.where(den == 0, torch.zeros_like(den),
                       0.5 * (right - left) / torch.where(den == 0, torch.ones_like(den), den))
    phase = torch.atan2(torch.gather(yi, -1, idx[..., None])[..., 0],
                        torch.gather(yr, -1, idx[..., None])[..., 0])
    return m, idx, frac, phase
