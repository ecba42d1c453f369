"""``match_strings(names)``: the self-join of one list.

The timed call is the API function's own body through the public class, a
fresh grouper each call (``StringGrouper(names).fit().get_matches()``), so
that the grouper's ``timings`` can be read after the call."""

from __future__ import annotations

import numpy as np

from portbench.reference import selfjoin

LISTS = ("master",)
SAMPLED = "master"


def call(sgt, series: dict, options: dict):
    sg = sgt.StringGrouper(series["master"], **options)
    return sg.fit().get_matches(), sg


def readout(answer, grouper):
    return answer


def take(frame, sample: np.ndarray) -> dict:
    """The program's pairs whose left side is a sampled position."""
    left = frame["left_index"].to_numpy(dtype=np.int64)
    mask = np.isin(left, sample)
    return {"rows": (left[mask], frame["right_index"].to_numpy(dtype=np.int64)[mask],
                     frame["similarity"].to_numpy(dtype=np.float64)[mask])}


def frame_errors(frame, lists_in_order: dict, sem: dict, eps: float) -> int:
    return selfjoin.frame_errors(frame, lists_in_order["master"], sem, eps)


def judge(corpus, lists: dict, calls: list, sem: dict, eps: float, device) -> dict:
    calls = [{**c, "order": c["order"]["master"]} for c in calls]
    return selfjoin.judge(corpus, calls, sem, eps, device)
