"""Basic length statistics (N50/NXX), cf. lq_utils.py:33-53."""

import numpy as np


def get_N50(vals):
    a = np.sort(np.asarray(vals))[::-1]
    t = a.sum() / 2
    c = np.cumsum(a)
    idx = np.searchsorted(c, t)
    # reference returns the first length where cumulative sum >= half-total
    return a[min(idx, len(a) - 1)]


def get_NXX(vals, target=90):
    a = np.asarray(vals)
    if target < 0:
        return vals[0]
    if target > 100:
        return vals[-1]
    a = np.sort(a)[::-1]
    t = a.sum() * target / 100
    c = np.cumsum(a)
    idx = np.searchsorted(c, t)
    return a[min(idx, len(a) - 1)]
