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
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device_table


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
