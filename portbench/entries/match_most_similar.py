"""``match_most_similar(master, new)``: the nearest master of each new name.

The timed call is the API function's own body through the public class, a
fresh grouper each call (``StringGrouper(master, duplicates=new,
max_n_matches=1).fit().get_groups()``).  The answer carries no
similarity, so after the call the same grouper's kept pairs are read with
``get_matches()`` (outside the timed wall): their similarities are what a
lower precision would change."""

from __future__ import annotations

import numpy as np

from portbench.reference import nearest

LISTS = ("master", "new")
SAMPLED = "new"


def call(sgt, series: dict, options: dict):
    sg = sgt.StringGrouper(series["master"], duplicates=series["new"],
                           **{**options, "max_n_matches": 1})
    return sg.fit().get_groups(), sg


def readout(answer, grouper):
    return answer, grouper.get_matches()


def take(out, sample: np.ndarray) -> dict:
    """The program's kept pairs whose new name is sampled, and its answer
    for each sampled new name (-1: the name itself)."""
    answer, pairs = out
    right = pairs["right_index"].to_numpy(dtype=np.int64)
    mask = np.isin(right, sample)
    idx = answer["most_similar_index"].to_numpy(dtype=np.float64)[sample]
    return {
        "pairs": (pairs["left_index"].to_numpy(dtype=np.int64)[mask], right[mask],
                  pairs["similarity"].to_numpy(dtype=np.float64)[mask]),
        "answers": (np.where(np.isnan(idx), -1, idx).astype(np.int64),
                    answer["most_similar_master"].to_numpy(dtype=object)[sample]),
    }


def frame_errors(out, lists_in_order: dict, sem: dict, eps: float) -> int:
    return nearest.frame_errors(out[0], out[1], lists_in_order["master"],
                                lists_in_order["new"], sem, eps)


def judge(corpus, lists: dict, calls: list, sem: dict, eps: float, device) -> dict:
    return nearest.judge(corpus, lists, calls, sem, eps, device)
