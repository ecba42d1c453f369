"""Exact float64 scoring of candidate pairs (host).

Routes through the native C++/OpenMP merge-scorer
(native/exact_scorer.cpp) when a compiler is available; otherwise a
vectorized numpy fallback.  Both accumulate shared terms in ascending
vocabulary order -- the same order as the reference's CSR kernels
(sparse_dot_topn row accumulation and scipy ``multiply().sum(axis=1)``,
reference string_grouper.py:439) -- so threshold and tie decisions agree
with the reference to the last float64 bit.
"""

from __future__ import annotations

import numpy as np

from ..corpus.tfidf import EllMatrix
from ..native import get_scorer_lib


def rescore_pairs_fp64(
    left: EllMatrix,
    right: EllMatrix,
    rows: np.ndarray,
    cols: np.ndarray,
    chunk: int = 65536,
    acc_dtype=np.float64,
) -> np.ndarray:
    """Exact dot for explicit (row, col) pairs, accumulated in
    ``acc_dtype`` -- float64 normally; float32 when
    ``tfidf_matrix_dtype=float32``, because the reference's sp_matmul_topn
    accumulates in the MATRIX dtype (its dense column accumulator receives
    contributions in ascending shared-term order, the same order as this
    merge), so every add must round at float32 for last-ulp parity
    (reference string_grouper.py:306, :725-732).  Output is always float64
    (the exact promotion)."""
    out = np.empty(len(rows), dtype=np.float64)
    if len(rows) == 0:
        return out
    # The encoder may still be filling ids/vals64 on its worker thread
    # (deferred phase 2 overlapping the device scan); join here -- this is
    # the first host reader on the match path.
    left.wait_ready()
    right.wait_ready()
    f32 = np.dtype(acc_dtype) == np.float32
    lib = get_scorer_lib()
    if lib is not None:
        fn = lib.score_pairs_f32_acc if f32 else lib.score_pairs_f64
        fn(
            np.ascontiguousarray(left.ids),
            np.ascontiguousarray(left.vals64),
            left.width,
            np.ascontiguousarray(right.ids),
            np.ascontiguousarray(right.vals64),
            right.width,
            np.ascontiguousarray(rows, dtype=np.int64),
            np.ascontiguousarray(cols, dtype=np.int64),
            len(rows),
            out,
        )
        return out
    # numpy fallback: blocked all-slots comparison (ids unique per row, so
    # each left slot matches at most one right slot; summing ascending
    # reproduces the merge order exactly).  The f32 path mirrors the native
    # loop: f32 products, sequential f32 accumulation in ascending term
    # order (einsum over small fixed widths accumulates sequentially).
    vdt = np.float32 if f32 else np.float64
    for s in range(0, len(rows), chunk):
        r = rows[s : s + chunk]
        c = cols[s : s + chunk]
        a_ids = left.ids[r]  # (p, La)
        a_vals = left.vals64[r].astype(vdt)
        b_ids = right.ids[c]  # (p, Lb)
        b_vals = right.vals64[c].astype(vdt)
        eq = (a_ids[:, :, None] == b_ids[:, None, :]) & (a_ids[:, :, None] >= 0)
        if f32:
            # Per-slot f32 product (each left slot matches <= 1 right slot,
            # so the axis-2 'sum' selects a single product -- no rounding),
            # then sequential f32 accumulation over ascending left slots.
            prod = np.where(
                eq, a_vals[:, :, None] * b_vals[:, None, :], np.float32(0)
            ).sum(axis=2, dtype=np.float32)
            acc = np.zeros(len(r), dtype=np.float32)
            for k in range(prod.shape[1]):
                acc += prod[:, k]
            out[s : s + chunk] = acc.astype(np.float64)
        else:
            contrib = np.where(eq, b_vals[:, None, :], 0.0).sum(axis=2)
            out[s : s + chunk] = np.einsum("pk,pk->p", a_vals, contrib)
    return out


def row_dot_fp64(
    left: EllMatrix, right: EllMatrix, acc_dtype=np.float64
) -> np.ndarray:
    """Row-wise exact dot of two equal-length ELL matrices (reference
    ``dot()``, string_grouper.py:433-440), accumulated in ``acc_dtype``.

    float32 configurations reproduce the reference's chain exactly: scipy's
    ``multiply().sum(axis=1)`` reduces each row's nonzero products with
    numpy's ufunc machinery (PAIRWISE float32 summation, not sequential
    adds -- unlike sp_matmul_topn's sequential SPA on the match path), so
    this path extracts the shared-term products in ascending term order and
    hands the reduction to ``np.add.reduceat`` itself."""
    assert left.n_rows == right.n_rows
    left.wait_ready()
    right.wait_ready()
    if np.dtype(acc_dtype) == np.float32:
        n = left.n_rows
        out = np.zeros(n, dtype=np.float32)
        # Row blocks bound the (blk, La, Lb) comparison cube (a
        # corpus-sized cube would be tens of GB at 663k rows).
        blk = max(1, (1 << 24) // max(1, left.width * right.width))
        for lo in range(0, n, blk):
            hi = min(n, lo + blk)
            a_ids, b_ids = left.ids[lo:hi], right.ids[lo:hi]
            a_vals = left.vals64[lo:hi].astype(np.float32)
            b_vals = right.vals64[lo:hi].astype(np.float32)
            eq = (a_ids[:, :, None] == b_ids[:, None, :]) & (
                a_ids[:, :, None] >= 0
            )
            # Per left slot, its (unique) matching right value -- the
            # axis-2 'sum' selects a single element, no rounding.
            bm = np.where(eq, b_vals[:, None, :], np.float32(0)).sum(
                axis=2, dtype=np.float32
            )
            matched = eq.any(axis=2)
            prods = (a_vals * bm)[matched]  # row-major: ascending order
            counts = matched.sum(axis=1)
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            nz = counts > 0
            if prods.size:
                red = np.add.reduceat(prods, starts[nz])
                out[lo:hi][nz] = red
        return out.astype(np.float64)
    lib = get_scorer_lib()
    if lib is not None:
        out = np.empty(left.n_rows, dtype=np.float64)
        lib.row_dot_f64(
            np.ascontiguousarray(left.ids),
            np.ascontiguousarray(left.vals64),
            left.width,
            np.ascontiguousarray(right.ids),
            np.ascontiguousarray(right.vals64),
            right.width,
            left.n_rows,
            out,
        )
        return out
    return left.row_dot(right)

