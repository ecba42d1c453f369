"""The self-join's answers by the reference, for sampled rows, and the
comparison with the program's.

string_grouper's self-join keeps, per row, the ``max_n_matches`` best
columns at or above ``min_similarity`` (the row itself among them), sets
the diagonal to exactly 1, and closes the result symmetrically: the pair
(i, j) is listed, with one similarity, when j is in i's top n or i in j's.
For a sampled row i that needs i's own ranking and, for every j at the
threshold or above, j's ranking too.
"""

from __future__ import annotations

import numpy as np

from . import topn
from .tfidf import Corpus, Cosines


def _class_positions(cls_at_pos: np.ndarray, n_classes: int):
    """Positions grouped by class (ascending inside a class), the start of
    each class's run, and each position's rank inside its class."""
    by_cls = np.argsort(cls_at_pos, kind="stable")
    counts = np.bincount(cls_at_pos, minlength=n_classes)
    starts = np.cumsum(counts) - counts
    rank = np.empty(len(cls_at_pos), dtype=np.int64)
    rank[by_cls] = np.arange(len(cls_at_pos)) - starts[cls_at_pos[by_cls]]
    return by_cls, starts, counts, rank


def _value(top, c_row: int, c_col: int, v: float) -> float:
    """The row's own ranking value for a class, where it lists it."""
    cl, vals = top[c_row]
    hit = np.flatnonzero(cl == c_col)
    return float(vals[hit[0]]) if len(hit) else v


def judge(corpus: Corpus, calls: list, sem: dict, eps: float, device) -> dict:
    """``calls``: per call, ``order`` (position -> master index), ``sample``
    (positions) and ``rows`` (left, right, similarity of the program's
    pairs whose left is sampled)."""
    thr, n = float(sem["min_similarity"]), int(sem["max_n_matches"])
    cos = Cosines(corpus, "master", device)
    cls = corpus.cls["master"]
    mult = corpus.mult["master"]
    q1 = np.unique(np.concatenate([cls[c["order"][c["sample"]]] for c in calls]))
    top, cand = cos.scan(q1, thr - eps, n + 1)
    q2 = np.setdiff1d(np.unique(np.concatenate([v[0] for v in cand.values()])), q1)
    top.update(cos.scan(q2, None, n + 1)[0])
    del cos

    gap, wrong, checked, pairs = 0.0, 0, 0, 0
    for c in calls:
        cls_at_pos = cls[c["order"]]
        by_cls, starts, counts, rank = _class_positions(cls_at_pos, corpus.n_classes)
        left, right, sims = c["rows"]
        for p in c["sample"]:
            p = int(p)
            ci = int(cls_at_pos[p])
            mine = left == p
            r_p, s_p = right[mine], sims[mine]
            diag = r_p == p
            wrong += int(diag.sum() != 1 or not np.all(s_p[diag] == 1.0))
            r_p, s_p = r_p[~diag], s_p[~diag]
            exp_pos, exp_st, exp_v = [], [], []
            for cc, v in zip(*cand[ci]):
                cc = int(cc)
                pos = by_cls[starts[cc]:starts[cc] + counts[cc]]
                st_row = topn.column_status(*top[ci], mult, cc, _value(top, ci, cc, v),
                                            np.arange(len(pos)), n, thr, eps)
                st_col = topn.column_status(*top[cc], mult, ci, _value(top, cc, ci, v),
                                            rank[p:p + 1], n, thr, eps)
                keep = pos != p
                exp_pos.append(pos[keep])
                exp_st.append(topn.either(st_row, st_col)[keep])
                exp_v.append(np.full(int(keep.sum()), v))
            exp_pos = np.concatenate(exp_pos) if exp_pos else np.zeros(0, np.int64)
            exp_st = np.concatenate(exp_st) if exp_st else np.zeros(0, np.int8)
            exp_v = np.concatenate(exp_v) if exp_v else np.zeros(0)
            order = np.argsort(exp_pos)
            exp_pos, exp_st, exp_v = exp_pos[order], exp_st[order], exp_v[order]
            # the program's pairs: each a candidate that may be kept, once
            at = np.searchsorted(exp_pos, r_p)
            found = (at < len(exp_pos)) & (exp_pos[np.minimum(at, len(exp_pos) - 1)] == r_p) \
                if len(exp_pos) else np.zeros(len(r_p), bool)
            wrong += int((~found).sum())
            at_f = at[found]
            wrong += int((exp_st[at_f] == topn.NO).sum())
            wrong += len(r_p) - len(np.unique(r_p))
            if found.any():
                gap = max(gap, float(np.max(np.abs(s_p[found] - exp_v[at_f]))))
            # every sure pair listed
            listed = np.zeros(len(exp_pos), bool)
            listed[at_f] = True
            wrong += int(((exp_st == topn.YES) & ~listed).sum())
            checked += 1
            pairs += len(r_p)
    return {"sim_gap": gap, "wrong_pairs": wrong, "rows_checked": checked,
            "pairs_checked": pairs}


def frame_errors(frame, names: np.ndarray, sem: dict, eps: float) -> int:
    """Checks of one whole frame that need no reference: one diagonal pair
    of similarity 1 per row, every other pair at the threshold or above
    and no higher than 1, each pair once, the pair list symmetric with one
    similarity, and each side's string the name at its index."""
    n = len(names)
    cols = ("left_index", "left_side", "similarity", "right_side", "right_index")
    if tuple(frame.columns) != cols:
        return n
    l = frame["left_index"].to_numpy(dtype=np.int64)
    r = frame["right_index"].to_numpy(dtype=np.int64)
    s = frame["similarity"].to_numpy(dtype=np.float64)
    if len(l) and (l.min() < 0 or r.min() < 0 or l.max() >= n or r.max() >= n):
        return n
    err = 0
    d = l == r
    err += n - int(np.count_nonzero(np.bincount(l[d], minlength=n) == 1))
    err += int((s[d] != 1.0).sum())
    off = ~d
    err += int(((s[off] < float(sem["min_similarity"]) - eps) | (s[off] > 1.0 + eps)).sum())
    fwd, rev = l * n + r, r * n + l
    o_f, o_r = np.argsort(fwd, kind="stable"), np.argsort(rev, kind="stable")
    err += len(fwd) - len(np.unique(fwd))
    err += int(((fwd[o_f] != rev[o_r]) | (s[o_f] != s[o_r])).sum())
    err += int((frame["left_side"].to_numpy(dtype=object) != names[l]).sum())
    err += int((frame["right_side"].to_numpy(dtype=object) != names[r]).sum())
    return err
