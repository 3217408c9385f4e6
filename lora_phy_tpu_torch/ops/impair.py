"""RF impairment injectors and the blind front-end corrector — the
PyTorch twin of ``lora_phy_tpu/ops/impair.py``.

The reference's channel fault-injection surface (SURVEY.md §5.3): CFO
rotation and sample-shift injection
(runners/lora_phy_vector_generate.cpp:88-124 ``apply_offsets``) and AWGN
(tests/awgn_sweep.py:262-268), plus what the reference does not model:
clock drift (SRO), multipath and the analog front end (DC offset, IQ
imbalance) with its blind estimator and compensator (``lora-rx-stream
--frontend-correct``). Every parameter broadcasts over leading batch dims.

The random draws (:func:`apply_awgn`, :func:`rayleigh_taps`) take a
``torch.Generator`` where the JAX twin takes a PRNG key: torch's
generator is not threefry, so the two packages draw different numbers
from the same seed and agree only in distribution.
"""

from __future__ import annotations

import math

import torch

_TWO_PI = 2.0 * math.pi


def _rotate(samples: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    return samples * torch.complex(torch.cos(ph), torch.sin(ph))


def apply_cfo(samples: torch.Tensor, cfo_bins, n: int, osr: int = 1) -> torch.Tensor:
    """Rotate by a CFO of ``cfo_bins`` FFT bins, the phase wrapping every
    symbol period like the reference's injector
    (lora_phy_vector_generate.cpp:101-107: ``ph = 2*pi*cfo*(n % N)/N``)."""
    step = n * osr
    idx = torch.remainder(torch.arange(samples.shape[-1], dtype=torch.float32,
                                       device=samples.device), step)
    cfo = torch.as_tensor(cfo_bins, dtype=torch.float32, device=samples.device)
    return _rotate(samples, (_TWO_PI / step) * cfo[..., None] * idx)


def apply_cfo_continuous(samples: torch.Tensor, cfo_bins, n: int,
                         osr: int = 1) -> torch.Tensor:
    """Physically continuous CFO rotation (no per-symbol phase reset):
    ``exp(j*2*pi*cfo_bins*t/(N*osr))`` over the global sample index."""
    step = n * osr
    idx = torch.arange(samples.shape[-1], dtype=torch.float32, device=samples.device)
    cfo = torch.as_tensor(cfo_bins, dtype=torch.float32, device=samples.device)
    return _rotate(samples, (_TWO_PI / step) * cfo[..., None] * idx)


def apply_time_shift(samples: torch.Tensor, shift: int) -> torch.Tensor:
    """Integer sample shift with zero fill, as the reference injector
    (lora_phy_vector_generate.cpp:109-119): a positive shift drops
    leading samples and zero-pads the tail, a negative one prepends
    zeros."""
    count = samples.shape[-1]
    idx = torch.arange(count, device=samples.device) + int(shift)
    valid = (idx >= 0) & (idx < count)
    out = samples[..., idx.clamp(0, count - 1)]
    return torch.where(valid, out, torch.zeros((), dtype=samples.dtype,
                                               device=samples.device))


def apply_awgn(generator: torch.Generator, samples: torch.Tensor, snr_db) -> torch.Tensor:
    """Complex AWGN at ``snr_db``, the reference model's convention
    ``sigma = 10**(-snr/20)``, ``sigma/sqrt(2)`` per component
    (tests/awgn_sweep.py:246, 262-268). ``snr_db`` may carry leading
    batch dims; the draws come from ``generator`` (on the samples'
    device)."""
    dev = samples.device
    shape = samples.shape
    nr = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
    ni = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
    return add_awgn_draws(samples, nr, ni, snr_db)


def add_awgn_draws(samples: torch.Tensor, nr, ni, snr_db) -> torch.Tensor:
    """:func:`apply_awgn` on given draws: ``samples`` plus the unit normal
    planes ``nr``, ``ni`` (the samples' shape; tensors or arrays) scaled
    by ``sigma/sqrt(2)`` at ``snr_db``. Fed the JAX twin's two normal
    draws it gives the JAX twin's noisy samples."""
    dev = samples.device
    sigma = 10.0 ** (-torch.as_tensor(snr_db, dtype=torch.float32, device=dev) / 20.0)
    scale = sigma[..., None] / math.sqrt(2.0)
    nr = torch.as_tensor(nr, dtype=torch.float32, device=dev)
    ni = torch.as_tensor(ni, dtype=torch.float32, device=dev)
    return samples + torch.complex(nr * scale, ni * scale)


def apply_sro(samples: torch.Tensor, ppm: float) -> torch.Tensor:
    """Sample-rate offset (clock drift): resample at ``1 + ppm*1e-6`` times
    the nominal rate by linear interpolation, ``y[k] = x(k*(1+delta))``
    (TX/RX crystal mismatch; positive ppm: the receiver clock is fast and
    the frame appears compressed). Same length as the input, the tail
    zero where the source position runs past the end. Real or complex."""
    count = samples.shape[-1]
    dev = samples.device
    k = torch.arange(count, device=dev)
    # pos = k*(1+d) as k + drift, only the small drift in floating point
    drift = k.to(torch.float32) * (float(ppm) * 1e-6)
    dwhole = torch.floor(drift)
    frac = drift - dwhole
    i0 = k + dwhole.to(torch.int64)
    # frac == 0 needs no right neighbour: identity resampling stays exact
    # at the last sample
    valid = (i0 >= 0) & ((i0 + 1 < count) | ((frac == 0) & (i0 < count)))
    a = samples[..., i0.clamp(0, count - 1)]
    b = samples[..., (i0 + 1).clamp(0, count - 1)]
    frac = frac.to(samples.dtype)
    out = a * (1 - frac) + b * frac
    return torch.where(valid, out, torch.zeros((), dtype=samples.dtype, device=dev))


def compensate_sro(samples: torch.Tensor, ppm: float) -> torch.Tensor:
    """Inverse of :func:`apply_sro`: resample at ``1/(1 + ppm*1e-6)``
    (the exact inverse delta ``-d/(1+d)``), undoing an estimated drift up
    to the linear interpolation's own error."""
    d = float(ppm) * 1e-6
    return apply_sro(samples, -d / (1.0 + d) * 1e6)


def apply_multipath(samples: torch.Tensor, taps) -> torch.Tensor:
    """Frequency-selective multipath, ``y[t] = sum_k h[k] x[t-k]``, with
    complex taps at integer sample delays (tap 0 = line of sight); causal,
    same length as the input (the leading edge sees zeros)."""
    taps = torch.as_tensor(taps, dtype=torch.complex64, device=samples.device)
    out = taps[0] * samples
    for k in range(1, int(taps.shape[0])):
        shifted = torch.nn.functional.pad(samples, (k, 0))[..., : samples.shape[-1]]
        out = out + taps[k] * shifted
    return out


def apply_multipath_planar(xr: torch.Tensor, xi: torch.Tensor, taps_re, taps_im):
    """Planar float32 twin of :func:`apply_multipath`. The taps are host
    values (a list or array): each enters as a scalar, as in the JAX
    twin's trace-time constants."""
    taps_re = [float(v) for v in torch.as_tensor(taps_re, dtype=torch.float32)]
    taps_im = [float(v) for v in torch.as_tensor(taps_im, dtype=torch.float32)]
    yr = taps_re[0] * xr - taps_im[0] * xi
    yi = taps_re[0] * xi + taps_im[0] * xr
    for k in range(1, len(taps_re)):
        sr = torch.nn.functional.pad(xr, (k, 0))[..., : xr.shape[-1]]
        si = torch.nn.functional.pad(xi, (k, 0))[..., : xi.shape[-1]]
        yr = yr + taps_re[k] * sr - taps_im[k] * si
        yi = yi + taps_re[k] * si + taps_im[k] * sr
    return yr, yi


def apply_frontend(samples: torch.Tensor, dc=0.0, gain_imbalance: float = 1.0,
                   phase_skew_deg: float = 0.0) -> torch.Tensor:
    """Analog front-end defects of a real SDR: a complex DC offset (LO
    leakage) and IQ imbalance (quadrature gain and phase mismatch),

        I' = I + re(dc)
        Q' = g * (Q * cos(phi) + I * sin(phi)) + im(dc)

    The receiver then sees ``a*x + b*conj(x)``: every chirp's image leaks
    in mirrored, and the DC spur sits at the carrier."""
    phi = math.radians(phase_skew_deg)
    i, q = samples.real, samples.imag
    q2 = gain_imbalance * (q * math.cos(phi) + i * math.sin(phi))
    dc = complex(dc)
    return torch.complex(i + dc.real, q2 + dc.imag)


def estimate_frontend_planar(xr: torch.Tensor, xi: torch.Tensor):
    """Blind front-end estimate from signal statistics: a proper complex
    baseband signal has ``E[I] = E[Q] = 0``, ``E[I²] = E[Q²]`` and
    ``E[IQ] = 0`` (chirps do over whole sweeps). Returns ``(dc_i, dc_q,
    gain, sin_phi)`` in :func:`apply_frontend`'s terms, each [...]-shaped:
    ``g² = E[Q'²]/E[I'²]`` and ``sin_phi = E[I'Q']/(E[I'²] g)``. A
    (near-)silent input (``E[I²] < 1e-9``) carries no statistics and
    returns the identity."""
    dc_i = torch.mean(xr, dim=-1, keepdim=True)
    dc_q = torch.mean(xi, dim=-1, keepdim=True)
    i = xr - dc_i
    q = xi - dc_q
    eii = torch.mean(i * i, dim=-1)
    eiq = torch.mean(i * q, dim=-1)
    eqq = torch.mean(q * q, dim=-1)
    g = torch.sqrt(torch.clamp(eqq / torch.clamp(eii, min=1e-30), min=1e-12))
    sin_phi = eiq / torch.clamp(eii * g, min=1e-30)
    quiet = eii < 1e-9
    zero = torch.zeros_like(g)
    g = torch.where(quiet, torch.ones_like(g), g)
    sin_phi = torch.where(quiet, zero, torch.clamp(sin_phi, -0.999, 0.999))
    return (torch.where(quiet, zero, dc_i[..., 0]),
            torch.where(quiet, zero, dc_q[..., 0]), g, sin_phi)


def compensate_frontend_planar(xr: torch.Tensor, xi: torch.Tensor, dc_i, dc_q,
                               g, sin_phi):
    """Invert :func:`apply_frontend` from :func:`estimate_frontend_planar`'s
    parameters: ``I = I' - dc_i``, ``Q = ((Q' - dc_q)/g - I sin)/cos``."""
    cos_phi = torch.sqrt(1.0 - sin_phi * sin_phi)
    i = xr - dc_i[..., None]
    q = ((xi - dc_q[..., None]) / g[..., None]
         - i * sin_phi[..., None]) / cos_phi[..., None]
    return i, q


def rayleigh_taps(generator: torch.Generator, delays, pdp_db) -> torch.Tensor:
    """Random Rayleigh multipath taps on integer sample ``delays`` with a
    power-delay profile ``pdp_db`` (dB, same length), normalised to unit
    total power: each tap CN(0, p_k), the wide-sense-stationary
    uncorrelated-scatter draw. Returns a dense complex64 tap vector of
    length ``max(delays)+1`` for :func:`apply_multipath`, on the
    generator's device."""
    dev = generator.device
    delays = [int(d) for d in delays]
    p = 10.0 ** (torch.as_tensor(pdp_db, dtype=torch.float32, device=dev) / 10.0)
    p = p / torch.sum(p)
    shape = (len(delays),)
    gr = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
    gi = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
    amp = torch.sqrt(p / 2.0)
    taps = torch.zeros(max(delays) + 1, dtype=torch.complex64, device=dev)
    return taps.index_add_(0, torch.tensor(delays, device=dev),
                           torch.complex(gr * amp, gi * amp))
