"""The benchmark's frozen count of the gateway scan's work (the ``front``
range of ``lora_phy_tpu_torch/models/sync.py``: the two-sided dechirp
scan over every symbol window of the block), the same whatever
implements it, and the least time one H100 could take for it at the
published peaks of :mod:`.kernel_bound`.

Per symbol window of ``N`` samples: the up- and the down-dechirp (two
complex products a sample, ``12 N`` flops), two N-point DFTs as FFTs
(``5 N log2 N`` each), |.|^2 of both spectra (``6 N``) and the first-max
compare over both (``2 N``). Bytes: both float32 planes read once, and
four 4-byte values a window written (the up and down peak bins and
powers).
"""

from __future__ import annotations

from .kernel_bound import PEAK_F32_FLOPS, PEAK_HBM_BYTES


def scan_count(samples: int, n: int) -> tuple[float, float]:
    """(flops, bytes) of the scan over ``samples`` samples a plane in
    windows of ``n``."""
    windows = samples // n
    log2n = n.bit_length() - 1
    flops = windows * (2 * 5 * n * log2n + (12 + 6 + 2) * n)
    nbytes = 4 * (2 * windows * n + 4 * windows)
    return float(flops), float(nbytes)


def scan_bound_s(samples: int, n: int) -> tuple[float, str]:
    """(least seconds the card could take, which bound sets it)."""
    flops, nbytes = scan_count(samples, n)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
