"""The benchmark's frozen copy of the hand kernel's operation and byte
count (``chip_smoke.py`` phase 4 / 20 (c), ``fused_bound``), and the
published peaks of one NVIDIA H100 SXM it is held to.

One ``fused_detect_rows`` call over ``rows`` rows of ``N`` samples: per
row the N-point DFT as an FFT (``5 N log2 N`` flops) plus the scale,
derotation, |.|^2 and compare (``14 N``; a window ``2 N`` more); every
input read once (the two planes, the per-row start, rate and scale, the
``N`` complex twiddles, the window) and one bin a row written, 4 bytes
each.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def fused_demod_count(rows: int, n: int, window: bool = False) -> tuple[float, float]:
    """(flops, bytes) of one kernel call."""
    log2n = n.bit_length() - 1
    flops = rows * (5 * n * log2n + (16 if window else 14) * n)
    nbytes = 4 * (2 * rows * n + 3 * rows + 2 * n + rows + (n if window else 0))
    return float(flops), float(nbytes)


def fused_demod_bound_s(rows: int, n: int, window: bool = False) -> tuple[float, str]:
    """(least seconds the card could take, which bound sets it)."""
    flops, nbytes = fused_demod_count(rows, n, window)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
