"""FFT backends of the complex detection path — the PyTorch twin of
``lora_phy_tpu/ops/fft.py``.

* ``xla`` — ``torch.fft.fft`` (cuFFT on the card, pocketfft / MKL on
  the CPU), the name kept from the JAX twin, whose ``xla`` backend is
  XLA's native FFT.
* ``dft`` — the four-step DFT with both small stages as dense complex
  matmuls (N = n1*n2, both <= 128), each written as four real matmuls.

``auto`` is ``xla`` on every device: the JAX twin picks ``dft`` off the
CPU only because its TPU backend has no FFT. All backends take
``[..., N]`` complex64 (N = 2**sf, 4..4096) and return the unnormalised
DFT. The NumPy factor tables (``_split``, ``_dft_mats``) are copies of
the JAX module's, so the constants are bit-equal.

The second half is the planar DFT that the demodulators run on split
(re, im) float32 planes, as real matmuls (four-step above N = 128):
:func:`dft_planar`, :func:`dft_mag2_planar` and the torch-ops argmax
:func:`_argmax_bins_ops`, with their NumPy tables. Their JAX twins are in
``lora_phy_tpu/ops/planar.py``; :func:`.planar.argmax_bins_planar`
dispatches to them and to the bf16 kernel of :mod:`.bf16_decide`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device_table
from ..utils.profiling import stage_range


def _cmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex matmul over the last two axes as four real matmuls."""
    ar, ai = a.real, a.imag
    br, bi = b.real, b.imag
    return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)


def fft(x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    if backend in ("auto", "xla"):
        return torch.fft.fft(x, dim=-1)
    if backend == "dft":
        return fft_dft_matmul(x)
    raise ValueError(f"unknown fft backend {backend!r}")


def _split(n: int) -> tuple[int, int]:
    """Factor N = n1*n2 with both factors <= 128 and as square as possible."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    while n2 > 128:
        n1 *= 2
        n2 //= 2
    return n1, n2


@functools.lru_cache(maxsize=16)
def _dft_mats(n: int):
    """(W1 [n1,n1], W2 [n2,n2], twiddle [n1,n2]) complex64 NumPy constants."""
    n1, n2 = _split(n)
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    w1 = np.exp(-2j * np.pi * np.outer(k1, k1) / n1).astype(np.complex64)
    w2 = np.exp(-2j * np.pi * np.outer(k2, k2) / n2).astype(np.complex64)
    tw = np.exp(-2j * np.pi * np.outer(k1, k2) / n).astype(np.complex64)
    return w1, w2, tw, n1, n2


@functools.lru_cache(maxsize=16)
def _dense_dft_t(n: int) -> np.ndarray:
    """The transposed dense [n, n] complex64 DFT matrix (N <= 128)."""
    k = np.arange(n)
    return np.ascontiguousarray(
        np.exp(-2j * np.pi * np.outer(k, k) / n).astype(np.complex64).T)


def _fourstep_t(n: int):
    """Transposed four-step factors W1.T, W2.T and the twiddle [n1, n2]."""
    w1, w2, tw, _, _ = _dft_mats(n)
    return (np.ascontiguousarray(w1.T), np.ascontiguousarray(w2.T), tw)


def fft_dft_matmul(x: torch.Tensor) -> torch.Tensor:
    """Four-step DFT: reshape [.., n2, n1] -> DFT columns (n1) -> twiddle
    -> DFT rows (n2) -> transpose-flatten, as two dense complex matmuls
    (one below N = 128). With n = n1*n2, input index i = i2*n1 + i1 and
    output index k = k1*n2 + k2:
      X[k1*n2+k2] = sum_{i1} W1[k1,i1] * (tw[i1,k2] * sum_{i2} x[i2*n1+i1] * W2[k2,i2])
    """
    n = x.shape[-1]
    if n <= 128:
        return _cmatmul(x, device_table(_dense_dft_t, n, device=x.device))
    w1t, w2t, tw = device_table(_fourstep_t, n, device=x.device)
    n1, n2 = _split(n)
    lead = x.shape[:-1]
    xm = x.reshape(*lead, n2, n1)                    # x[i2, i1]
    inner = _cmatmul(xm.swapaxes(-1, -2), w2t)       # [.., i1, k2]
    inner = inner * tw                               # twiddle [i1, k2]
    outer = _cmatmul(inner.swapaxes(-1, -2), w1t)    # [.., k2, k1]
    return outer.swapaxes(-1, -2).reshape(*lead, n)  # [.., k1, k2] -> k


# ---------------------------------------------------------------------------
# The planar DFT: (re, im) float32 planes, real matmuls
# ---------------------------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor, mxu_dtype=None) -> torch.Tensor:
    """``a @ b`` in float32; with ``mxu_dtype`` (``torch.bfloat16``) both
    operands are rounded to it first (round to nearest even) and the
    products summed in float32 — JAX's ``preferred_element_type=f32``
    dot. Products of two bf16 values are exact in float32, and TF32 is
    off (package import), so only the order of the sums differs. JAX
    twin: ``lora_phy_tpu/ops/planar.py:_mm``."""
    if mxu_dtype is not None:
        a = a.to(mxu_dtype).to(torch.float32)
        b = b.to(mxu_dtype).to(torch.float32)
    return a @ b


@functools.lru_cache(maxsize=16)
def _small_dft_tables(n: int):
    """[N, N] float32 cos / -sin DFT tables. JAX twin:
    ``lora_phy_tpu/ops/planar.py:_small_dft_tables``."""
    k = np.arange(n)
    ang = 2 * np.pi * np.outer(k, k) / n
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=16)
def _combined_dft_mat(n: int):
    """[2n, 2n] float32 ``M`` with ``[xr | xi] @ M = [yr | yi]`` for the
    Wr=cos / Wi=-sin DFT: ``M = [[Wr, Wi], [-Wi, Wr]]``. JAX twin:
    ``lora_phy_tpu/ops/planar.py:_combined_dft_mat``."""
    k = np.arange(n)
    ang = 2 * np.pi * np.outer(k, k) / n
    wr = np.cos(ang).astype(np.float32)
    wi = (-np.sin(ang)).astype(np.float32)
    return np.block([[wr, wi], [-wi, wr]])


@functools.lru_cache(maxsize=16)
def _combined_fourstep_mats(n: int):
    """Combined-form four-step constants: ``M1R`` [2n1, 2n1] right-multiplies
    concatenated [br | bi] columns; twiddles in the [k2, i1] layout. JAX
    twin: ``lora_phy_tpu/ops/planar.py:_combined_fourstep_mats``."""
    w1, w2, tw, n1, n2 = _dft_mats(n)
    m1r = np.block([[w1.real.T, w1.imag.T],
                    [-w1.imag.T, w1.real.T]]).astype(np.float32)
    twr = np.ascontiguousarray(tw.T.real).astype(np.float32)
    twi = np.ascontiguousarray(tw.T.imag).astype(np.float32)
    return m1r, n1, n2, twr, twi


def _fourstep_planar_mats(n: int):
    """Split-form four-step planes for :func:`dft_planar` (the JAX twin
    builds them inside ``lora_phy_tpu/ops/planar.py:dft_planar``)."""
    w1, w2, tw, n1, n2 = _dft_mats(n)
    return (w1.real.copy(), w1.imag.copy(), w2.real.copy(), w2.imag.copy(),
            np.ascontiguousarray(tw.T.real), np.ascontiguousarray(tw.T.imag))


def _scrambled_mats(n: int):
    """Device-ready constants of :func:`_dft_mag2_scrambled` (the JAX twin
    builds them inside ``lora_phy_tpu/ops/planar.py:_dft_mag2_scrambled``)."""
    m1r, n1, n2, twr_t, twi_t = _combined_fourstep_mats(n)
    return (_combined_dft_mat(n2), m1r, twr_t.T.copy(), twi_t.T.copy(), n1, n2)


def dft_planar(xr: torch.Tensor, xi: torch.Tensor, n: int, mxu_dtype=None):
    """Planar DFT over the last axis: four real matmuls (N <= 128) or the
    four-step factorisation (N up to 4096). ``mxu_dtype=torch.bfloat16``
    rounds every matmul operand to bf16 (f32 sums, :func:`_mm`). JAX twin:
    ``lora_phy_tpu/ops/planar.py:dft_planar``."""
    if n <= 128:
        wr, wi = device_table(_small_dft_tables, n, device=xr.device)
        # one [rows, n] GEMM: a strided batch (the estimator's osr-phase
        # view) would otherwise run as batched GEMVs on the GPU
        shape = xr.shape
        xr, xi = xr.reshape(-1, n), xi.reshape(-1, n)
        return ((_mm(xr, wr, mxu_dtype) - _mm(xi, wi, mxu_dtype)).reshape(shape),
                (_mm(xr, wi, mxu_dtype) + _mm(xi, wr, mxu_dtype)).reshape(shape))
    with stage_range("planar.fourstep"):
        w1r, w1i, w2r, w2i, twr, twi = device_table(_fourstep_planar_mats, n,
                                                    device=xr.device)
        n1, n2 = _dft_mats(n)[3:]
        lead = xr.shape[:-1]
        xr_m = xr.reshape(*lead, n2, n1)                    # [.., i2, i1]
        xi_m = xi.reshape(*lead, n2, n1)
        ar = _mm(w2r, xr_m, mxu_dtype) - _mm(w2i, xi_m, mxu_dtype)  # inner DFT: [.., k2, i1]
        ai = _mm(w2r, xi_m, mxu_dtype) + _mm(w2i, xr_m, mxu_dtype)
        br = ar * twr - ai * twi                            # twiddle
        bi = ar * twi + ai * twr
        cr = _mm(br, w1r.T, mxu_dtype) - _mm(bi, w1i.T, mxu_dtype)  # outer DFT: [.., k2, k1]
        ci = _mm(br, w1i.T, mxu_dtype) + _mm(bi, w1r.T, mxu_dtype)
        return (cr.swapaxes(-1, -2).reshape(*lead, n),
                ci.swapaxes(-1, -2).reshape(*lead, n))


def _dft_mag2_scrambled(xr: torch.Tensor, xi: torch.Tensor, n: int,
                        mxu_dtype=None) -> torch.Tensor:
    """|DFT|² in the four-step's native [.., k2, k1] layout (bin
    ``k = k1*n2 + k2``), via two combined matmuls and no output reorder.
    JAX twin: ``lora_phy_tpu/ops/planar.py:_dft_mag2_scrambled``."""
    m2, m1r, twr, twi, n1, n2 = device_table(_scrambled_mats, n, device=xr.device)
    lead = xr.shape[:-1]
    xst = torch.cat(
        [xr.reshape(*lead, n2, n1).swapaxes(-1, -2),
         xi.reshape(*lead, n2, n1).swapaxes(-1, -2)], dim=-1
    )                                                   # [.., n1, 2n2]
    a = _mm(xst, m2, mxu_dtype)
    ar, ai = a[..., :n2], a[..., n2:]                   # [.., n1, n2]
    bs = torch.cat(
        [(ar * twr - ai * twi).swapaxes(-1, -2),
         (ar * twi + ai * twr).swapaxes(-1, -2)], dim=-1
    )                                                   # [.., n2, 2n1]
    c = _mm(bs, m1r, mxu_dtype)                         # [cr | ci]
    return c[..., :n1] * c[..., :n1] + c[..., n1:] * c[..., n1:]


def dft_mag2_planar(xr: torch.Tensor, xi: torch.Tensor, n: int,
                    mxu_dtype=None) -> torch.Tensor:
    """|DFT|² over the last axis in natural bin order. JAX twin:
    ``lora_phy_tpu/ops/planar.py:dft_mag2_planar``."""
    if n <= 128:
        m = device_table(_combined_dft_mat, n, device=xr.device)
        y = _mm(torch.cat([xr, xi], dim=-1), m, mxu_dtype)
        return y[..., :n] * y[..., :n] + y[..., n:] * y[..., n:]
    with stage_range("planar.fourstep"):
        m = _dft_mag2_scrambled(xr, xi, n, mxu_dtype)
        lead = m.shape[:-2]
        return m.swapaxes(-1, -2).reshape(*lead, n)


def _argmax_bins_ops(xr: torch.Tensor, xi: torch.Tensor, n: int, mxu_dtype=None,
                     with_peak: bool = False):
    """:func:`.planar.argmax_bins_planar` in torch ops, on any device. JAX
    twin: ``lora_phy_tpu/ops/planar.py:argmax_bins_planar``."""
    if n <= 128:
        mag2 = dft_mag2_planar(xr, xi, n, mxu_dtype)
        bins = torch.argmax(mag2, dim=-1).to(torch.int32)
        if with_peak:
            return bins, mag2.amax(dim=-1)
        return bins
    with stage_range("planar.fourstep"):
        m = _dft_mag2_scrambled(xr, xi, n, mxu_dtype)
        lead = m.shape[:-2]
        n2, n1 = m.shape[-2], m.shape[-1]
        bins, peak = _argmax_natural(m.reshape(*lead, n2 * n1), n1, n2)
    if with_peak:
        return bins, peak
    return bins


def _argmax_natural(flat: torch.Tensor, n1: int, n2: int):
    """First-max argmax over a flattened scrambled [k2, k1] spectrum,
    returning (lowest natural tied bin, peak value). The JAX twin carries
    the natural index through a variadic reduce; here the spectrum is
    reordered to natural order (bin ``k1*n2 + k2``) and ``torch.argmax``,
    which returns the first maximum, picks the same bin. JAX twin:
    ``lora_phy_tpu/ops/planar.py:_argmax_natural``."""
    lead = flat.shape[:-1]
    nat = flat.reshape(*lead, n2, n1).swapaxes(-1, -2).reshape(*lead, n1 * n2)
    peak, bins = torch.max(nat, dim=-1)
    return bins.to(torch.int32), peak
