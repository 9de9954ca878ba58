"""The quantile the tail metrics use."""
from __future__ import annotations

import math


def quantile(values, q: float) -> float:
    """The q-quantile of ``values`` by linear interpolation between order
    statistics (the default of numpy's ``quantile``): position q * (n - 1)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("quantile of no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

