"""Four-step DFT factor tables — the NumPy part of ``lora_phy_tpu/ops/fft.py``
that the planar N > 128 path needs (``_split``, ``_dft_mats``), copied so
the constants are bit-equal to the JAX package's."""

from __future__ import annotations

import functools

import numpy as np


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
