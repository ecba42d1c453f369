"""``match_most_similar``'s answers by the reference, for sampled new
names, and the comparison with the program's.

string_grouper fits the vectorizer on master and new names together and
keeps, per *master* name, its one best new name at or above
``min_similarity`` (ties to the first).  Each new name then takes, of the
masters that kept it, the most similar (ties to the first master), or
itself when none did.  So for a sampled new name d every master at the
threshold or above is ranked against all new names.
"""

from __future__ import annotations

import numpy as np

from . import topn
from .selfjoin import _class_positions, _value
from .tfidf import Corpus, Cosines


def judge(corpus: Corpus, lists: dict, calls: list, sem: dict, eps: float,
          device) -> dict:
    """``lists``: the input lists in their generated order; ``calls``: per
    call, ``order`` ({"master": ..., "new": ...}: position -> list index),
    ``sample`` (new positions), ``pairs`` (master, new,
    similarity of the program's kept pairs whose new name is sampled) and
    ``answers`` (the program's nearest master position per sampled new
    name, -1 for itself, and the string it gave)."""
    thr = float(sem["min_similarity"])
    cls_m, cls_n = corpus.cls["master"], corpus.cls["new"]
    mult_n = corpus.mult["new"]
    q1 = np.unique(np.concatenate([cls_n[c["order"]["new"][c["sample"]]] for c in calls]))
    cand = Cosines(corpus, "master", device).scan(q1, thr - eps, 1)[1]
    q2 = np.unique(np.concatenate([v[0] for v in cand.values()]))
    top = Cosines(corpus, "new", device).scan(q2, None, 2)[0]

    gap, wrong, wrong_nearest, checked, matched = 0.0, 0, 0, 0, 0
    for c in calls:
        m_cls = cls_m[c["order"]["master"]]
        n_cls = cls_n[c["order"]["new"]]
        by_m, starts_m, counts_m, _ = _class_positions(m_cls, corpus.n_classes)
        _, _, _, rank_n = _class_positions(n_cls, corpus.n_classes)
        pm, pn, ps = c["pairs"]
        masters = lists["master"][c["order"]["master"]]
        news = lists["new"][c["order"]["new"]]
        for k, d in enumerate(c["sample"]):
            d = int(d)
            dc = int(n_cls[d])
            exp_pos, exp_st, exp_v, classes = [], [], [], []
            for mc, v in zip(*cand[dc]):
                mc = int(mc)
                st = topn.column_status(*top[mc], mult_n, dc, _value(top, mc, dc, v),
                                        rank_n[d:d + 1], 1, thr, eps)[0]
                pos = by_m[starts_m[mc]:starts_m[mc] + counts_m[mc]]
                exp_pos.append(pos)
                exp_st.append(np.full(len(pos), st, np.int8))
                exp_v.append(np.full(len(pos), v))
                classes.append((v, st, int(pos[0])))
            exp_pos = np.concatenate(exp_pos) if exp_pos else np.zeros(0, np.int64)
            exp_st = np.concatenate(exp_st) if exp_st else np.zeros(0, np.int8)
            exp_v = np.concatenate(exp_v) if exp_v else np.zeros(0)
            order = np.argsort(exp_pos)
            exp_pos, exp_st, exp_v = exp_pos[order], exp_st[order], exp_v[order]
            mine = pn == d
            r_m, s_m = pm[mine], ps[mine]
            at = np.searchsorted(exp_pos, r_m)
            found = (at < len(exp_pos)) & (exp_pos[np.minimum(at, len(exp_pos) - 1)] == r_m) \
                if len(exp_pos) else np.zeros(len(r_m), bool)
            wrong += int((~found).sum()) + len(r_m) - len(np.unique(r_m))
            at_f = at[found]
            wrong += int((exp_st[at_f] == topn.NO).sum())
            if found.any():
                gap = max(gap, float(np.max(np.abs(s_m[found] - exp_v[at_f]))))
            listed = np.zeros(len(exp_pos), bool)
            listed[at_f] = True
            wrong += int(((exp_st == topn.YES) & ~listed).sum())
            # the nearest master: the best class that kept d, ties to the
            # first master; itself when no class surely kept it
            sure = [v for v, st, _ in classes if st == topn.YES]
            best = max(sure) if sure else -np.inf
            allowed = {first for v, st, first in classes
                       if st != topn.NO and v >= best - eps}
            if not sure:
                allowed.add(-1)
            got, text = c["answers"][0][k], c["answers"][1][k]
            want_text = news[d] if got < 0 else masters[got]
            wrong_nearest += int(got not in allowed or text != want_text)
            checked += 1
            matched += int(got >= 0)
    return {"sim_gap": gap, "wrong_pairs": wrong, "wrong_nearest": wrong_nearest,
            "rows_checked": checked, "rows_matched": matched}


def frame_errors(nearest, pairs, masters: np.ndarray, new: np.ndarray,
                 sem: dict, eps: float) -> int:
    """Checks of one whole answer that need no reference: one answer per
    new name in its order, each the master string at its index (or the new
    name itself where none), each master kept for at most one new name, at
    the threshold or above and no higher than 1."""
    n = len(new)
    cols = ("most_similar_index", "most_similar_master")
    if tuple(nearest.columns) != cols or len(nearest) != n:
        return n
    err = int((nearest.index.to_numpy() != np.arange(n)).sum())
    idx = nearest["most_similar_index"].to_numpy(dtype=np.float64)
    text = nearest["most_similar_master"].to_numpy(dtype=object)
    own = np.isnan(idx)
    pos = np.where(own, 0, idx).astype(np.int64)
    if len(pos) and (pos.min() < 0 or pos.max() >= len(masters)):
        return n
    err += int((text[own] != new[own]).sum())
    err += int((text[~own] != masters[pos[~own]]).sum())
    l = pairs["left_index"].to_numpy(dtype=np.int64)
    s = pairs["similarity"].to_numpy(dtype=np.float64)
    err += len(l) - len(np.unique(l))
    err += int(((s < float(sem["min_similarity"]) - eps) | (s > 1.0 + eps)).sum())
    return err
