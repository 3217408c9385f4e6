"""LoRa chirps at one sample per chip (osr 1, 125 kHz), in float64 NumPy,
from the reference library's chirp generator (ChirpGenerator.hpp): the
phase is the running sum of the per-sample angular frequency

    f_k = -pi + (2 pi / N) * (((w + k) mod N) + 1),   k = 0 .. N-1,

for a symbol ``w`` (an up-chirp starting at bin ``w``), and its negative
for the down-chirp (``w`` = 0). A symbol's sum over ``N`` samples is pi,
so the ``i``-th chirp of a phase-continuous run starts at ``i * pi``.
"""

from __future__ import annotations

import functools
import math

import numpy as np


def _freq(n: int, w: int, count: int) -> np.ndarray:
    k = np.arange(count, dtype=np.float64)
    return -math.pi + (2.0 * math.pi / n) * (np.mod(w + k, n) + 1.0)


@functools.lru_cache(maxsize=8)
def up_phase_table(n: int) -> np.ndarray:
    """[N symbols, N samples] float64 phases of the up-chirps, each
    starting from phase 0."""
    return np.stack([np.cumsum(_freq(n, w, n)) for w in range(n)])


@functools.lru_cache(maxsize=8)
def down_phase(n: int, count: int) -> np.ndarray:
    """[count] float64 phase of the phase-continuous down-chirp run."""
    return -np.cumsum(_freq(n, 0, count))


@functools.lru_cache(maxsize=8)
def base_downchirp(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) float64 of one base down-chirp: the dechirp reference."""
    ph = down_phase(n, n)
    return np.cos(ph), np.sin(ph)


@functools.lru_cache(maxsize=8)
def preamble_phase_step(n: int) -> float:
    """Phase advance, in radians, of the DFT peak from one dechirped
    preamble up-chirp to the next (pi at one sample per chip)."""
    table = up_phase_table(n)[0]
    up = np.exp(1j * np.concatenate([table, table + math.pi]))
    dr, di = base_downchirp(n)
    dech = up.reshape(2, n) * (dr + 1j * di)
    spec = np.fft.fft(dech, axis=-1)
    pk = spec[np.arange(2), np.abs(spec).argmax(-1)]
    return float(np.angle(pk[1] * np.conj(pk[0])))
