"""Who is in a row's top n, by the reference's cosines.

string_grouper keeps, per row, the ``n`` best columns at or above the
threshold, ties to the smaller column (a stable sort by similarity
descending).  Names of one class have equal cosines to everything, so they
tie exactly and fall in column order.  Two *different* classes whose
cosines lie within ``eps`` of each other (or a cosine within ``eps`` of the
threshold) may come out in either order once each side rounds in its own
way: such a place is not decided here (``MAYBE``), and either answer is
accepted there.  ``eps`` is the comparison's limit on a similarity.
"""

from __future__ import annotations

import numpy as np

NO, MAYBE, YES = 0, 1, 2


def column_status(top_cls: np.ndarray, top_val: np.ndarray, mult: np.ndarray,
                  col_cls: int, v: float, own: np.ndarray, n: int,
                  thr: float, eps: float) -> np.ndarray:
    """Status of columns of class ``col_cls`` in a row's top ``n``.

    ``top_cls`` / ``top_val``: the row's best classes and cosines, best
    first (``k`` of them, more than ``n`` when the list has them);
    ``mult``: names per class in the list of columns; ``v``: the row's
    cosine to ``col_cls``; ``own``: for each column asked about, how many
    names of its class come before it in the list."""
    own = np.asarray(own, dtype=np.int64)
    if v < thr - eps:
        return np.full(own.shape, NO, dtype=np.int8)
    other = top_cls != col_cls
    above = int(mult[top_cls[other & (top_val > v + eps)]].sum())
    band = int(mult[top_cls[other & (np.abs(top_val - v) <= eps)]].sum())
    if col_cls not in top_cls and len(top_cls) > n and v < top_val[-1] - eps:
        return np.full(own.shape, NO, dtype=np.int8)  # more than n classes above
    lo = above + own
    hi = lo + band
    out = np.full(own.shape, MAYBE, dtype=np.int8)
    out[lo >= n] = NO
    if v >= thr + eps:
        out[(hi < n) & (lo < n)] = YES
    if col_cls not in top_cls:  # beyond the listed classes: never a sure YES
        out[out == YES] = MAYBE
    return out


def either(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A pair kept by the self-join's symmetric closure: in one row's top n
    or in the other's."""
    out = np.full(np.broadcast(a, b).shape, MAYBE, dtype=np.int8)
    out[(a == NO) & (b == NO)] = NO
    out[(a == YES) | (b == YES)] = YES
    return out
