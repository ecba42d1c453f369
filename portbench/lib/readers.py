"""Helpers of the metric readers (``metrics/<name>.py``).  A reader gets
the run (``calls``: each window call's ``wall`` and the grouper's
``timings``; ``trace``: the profiled call or None; ``distinct``: distinct
cleaned strings per input list, by the reference's cleaning; ``hash_dim``;
``peaks``: the card's row of ``lib/peaks.json`` or None) and returns a
number, or None when it finds nothing to read."""

from __future__ import annotations

from typing import Iterable, Optional


def mean_timing(run, keys: Iterable[str]) -> Optional[float]:
    """Mean over the window's calls of the sum of the given ``timings``
    keys (a key a call lacks adds 0); None when no call has any of them."""
    keys = tuple(keys)
    per_call = [sum(c["timings"].get(k, 0.0) for k in keys) for c in run.calls
                if any(k in c["timings"] for k in keys)]
    return sum(per_call) / len(per_call) if per_call else None


def mean_prefixed(run, prefix: str) -> Optional[float]:
    """Mean over the calls of the sum of every ``timings`` key that starts
    with ``prefix``; 0 for a call whose match stats have none, None when no
    call has match stats at all."""
    per_call = [sum(v for k, v in c["timings"].items() if k.startswith(prefix))
                for c in run.calls if any(k.startswith("match.") for k in c["timings"])]
    return sum(per_call) / len(per_call) if per_call else None
