"""Small statistics helpers for the characterisation sweeps — the port's
own copy of ``lora_phy_tpu/utils/stats.py``.

The reference's committed-curve discipline (tests/awgn_sweep.py:322-341)
reports raw counts only; every curve this framework commits carries a
binomial interval so a reader can tell a real knee from sampling noise.
"""

from __future__ import annotations

import math


def wilson(k: int, n: int, z: float = 1.959964) -> tuple[float, float]:
    """95% Wilson score interval for a binomial rate ``k/n``.

    Preferred over the normal approximation because sweep tails sit at
    rates near 0 or 1, exactly where Wald intervals collapse or escape
    [0, 1]."""
    if n == 0:
        return 0.0, 1.0
    ph = k / n
    den = 1.0 + z * z / n
    c = (ph + z * z / (2 * n)) / den
    h = z * math.sqrt(ph * (1 - ph) / n + z * z / (4 * n * n)) / den
    return max(0.0, c - h), min(1.0, c + h)
