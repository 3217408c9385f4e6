"""How the judges' parts of many compared calls become the numbers held
against the cell's limits:

* a float (a widest gap) -> the largest over the calls;
* an int (a count of outputs that differ where the arithmetic is exact)
  -> the sum;
* a pair (count, total) -> the share over all calls;
* an array (one error per lane or frame) -> its 99.9th percentile over
  all calls' lanes or frames together. A lane whose decisions differ
  enters as ``DIFFER``, so a fault that moves more than one lane in a
  thousand reads ``DIFFER``, while a decision that float rounding alone
  moves (a peak within rounding of its neighbour, in any precision) does
  not decide the number.
"""

from __future__ import annotations

import numpy as np

DIFFER = 1e9
PERCENTILE = 99.9


def combine(parts: list[dict]) -> dict:
    out = {}
    for key in parts[0]:
        vals = [p[key] for p in parts]
        first = vals[0]
        if isinstance(first, tuple):
            out[key] = sum(v[0] for v in vals) / max(sum(v[1] for v in vals), 1)
        elif isinstance(first, np.ndarray):
            cat = np.concatenate(vals)
            out[key] = float(np.percentile(cat, PERCENTILE)) if cat.size else 0.0
        elif isinstance(first, (int, np.integer)):
            out[key] = int(sum(vals))
        else:
            out[key] = float(max(vals))
    return out
