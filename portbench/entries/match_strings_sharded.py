"""``match_strings(names)`` on the sharded multi-process tier: the
self-join of one list by ``ranks`` ``torch.distributed`` ranks, one card
each, every rank holding a shard of the corpus.

The timed call is the API function's own body through the public class on
every rank: ``StringGrouper(names, multihost="sharded", device=<the rank's
card>, number_of_processes=<threads>).fit().get_matches()``, each rank
with the same full list, as ``parallel/multihost.py``'s contract says.
This process is rank 0, on ``cuda:0``; ranks 1 .. ranks - 1 are worker
processes on ``cuda:1 ..`` (``lib/ranks.py``), started in the first call
(the warm call, so inside set-up) and stopped at exit.  ``ranks`` is taken
out of the options; ``number_of_processes`` is ``max(1, (CPUs - 1) //
ranks)`` unless the options give it.

The wall of a call holds the hand-off of the list to every worker (one
pickled object a worker, its seconds in ``timings["entry.handoff_s"]``)
and rank 0's fit and frame; the workers' calls run beside it.  After the
wall each worker's answer is read back as a digest of its frame and held
against rank 0's: ``rank_mismatch`` counts the ranks whose answer differs
(or that raised).  The profiled call of a ``--trace 1`` run profiles this
process alone, so the per-layer metrics read rank 0's stages and device:
the workers' stages stay out of them."""

from __future__ import annotations

import atexit
import os
from typing import NamedTuple

import numpy as np

from portbench.entries import match_strings
from portbench.lib import ranks as ranks_lib
from portbench.reference import selfjoin

LISTS = match_strings.LISTS
SAMPLED = match_strings.SAMPLED
RANKS = 4

_pool = None


class Answer(NamedTuple):
    frame: object
    rank_mismatch: int


def _ranks(world: int, device_type: str) -> ranks_lib.Ranks:
    global _pool
    if _pool is None:
        _pool = ranks_lib.Ranks(world, device_type, target=ranks_lib.serve)
        atexit.register(_pool.close)
    return _pool


def call(sgt, series: dict, options: dict):
    opts = dict(options)
    world = int(opts.pop("ranks", RANKS))
    device_type = "cpu" if str(opts.pop("device", "cuda")) == "cpu" else "cuda"
    opts.setdefault("number_of_processes", max(1, ((os.cpu_count() or 2) - 1) // world))
    pool = _ranks(world, device_type)
    handoff_s = pool.handoff(series["master"], opts)
    try:
        sg = sgt.StringGrouper(series["master"], device=pool.device, **opts)
        frame = sg.fit().get_matches()
    except Exception:
        pool.replies()  # the workers leave the call before it is failed
        raise
    sg.timings.seconds["entry.handoff_s"] = handoff_s
    return frame, sg


def readout(answer, grouper) -> Answer:
    mine = ("ok", ranks_lib.digest(answer))
    return Answer(answer, sum(got != mine for got in _pool.replies()))


def take(out: Answer, sample: np.ndarray) -> dict:
    return {**match_strings.take(out.frame, sample), "rank_mismatch": out.rank_mismatch}


def frame_errors(out: Answer, lists_in_order: dict, sem: dict, eps: float) -> int:
    return selfjoin.frame_errors(out.frame, lists_in_order["master"], sem, eps)


def judge(corpus, lists: dict, calls: list, sem: dict, eps: float, device) -> dict:
    numbers = match_strings.judge(corpus, lists, calls, sem, eps, device)
    numbers["rank_mismatch"] = sum(int(c["rank_mismatch"]) for c in calls)
    return numbers
