"""One call under ``torch.profiler``, its events read back, and the
arithmetic read from them: the device's busy time (the union of kernel,
copy and set intervals, streams overlapping counted once, within the call)
and the idle share, the device operations that took most time, and the
longest idle gaps with what the host was doing in each.

The interval arithmetic is a copy of the port's ``utils/profiling``
(``device_intervals``, ``union_us``) as ``tools/trace_663k.py::analyse``
uses it; the yardstick keeps its own copy.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

#: event kinds during which the device is busy
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the range the harness opens around the profiled call
CALL_RANGE = "portbench.call"


@dataclass
class Trace:
    events: List[dict]                 # cat, name, ts and dur (microseconds), tid
    window: Tuple[float, float]        # the profiled call's range, microseconds
    wall_s: float                      # the call's wall on the host clock

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def device(self) -> List[dict]:
        return [e for e in self.events if e["cat"] in DEVICE_CATS]


def capture(fn: Callable[[], object], on_card: bool):
    """Run ``fn`` once under the profiler (CPU activity, and the card's when
    ``on_card``); returns ``(fn's result, Trace)``.  The trace passes
    through one Chrome-format file in a temporary directory under
    ``TMPDIR``, deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        with record_function(CALL_RANGE):
            t0 = time.perf_counter()
            out = fn()
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
    events = [{"cat": e.get("cat"), "name": e.get("name", ""), "ts": float(e["ts"]),
               "dur": float(e.get("dur", 0)), "tid": e.get("tid")}
              for e in raw if e.get("ph") == "X"]
    del raw
    call = [e for e in events if e["name"] == CALL_RANGE and e["cat"] == "user_annotation"]
    if len(call) != 1:
        raise RuntimeError(f"{len(call)} '{CALL_RANGE}' ranges in the trace")
    window = (call[0]["ts"], call[0]["ts"] + call[0]["dur"])
    return out, Trace(events=events, window=window, wall_s=wall)


def intervals(events: Iterable[dict]) -> List[Tuple[float, float]]:
    return [(e["ts"], e["ts"] + e["dur"]) for e in events]


def union_us(iv: Iterable[Tuple[float, float]],
             window: Optional[Tuple[float, float]] = None) -> float:
    """Length of the union of the intervals (clipped to ``window``), in
    microseconds: overlapping streams count once."""
    total, end = 0.0, None
    lo, hi = window if window is not None else (float("-inf"), float("inf"))
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in iv):
        if b <= a:
            continue
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def busy_s(tr: Trace) -> float:
    return union_us(intervals(tr.device()), tr.window) / 1e6


def idle_gaps(tr: Trace) -> List[Tuple[float, float]]:
    """The stretches of the call's window with nothing on the device."""
    lo, hi = tr.window
    gaps, end = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals(tr.device())):
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name), and the
    longest idle gaps, each named by the innermost host operation that
    covers most of it."""
    lo, hi = tr.window
    by_name = {}
    for e in tr.device():
        if e["ts"] < hi and e["ts"] + e["dur"] > lo:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = [e for e in tr.events if e["cat"] in ("cpu_op", "cuda_runtime", "cuda_driver")]
    h_ts = np.array([e["ts"] for e in host], dtype=np.float64)
    h_dur = np.array([e["dur"] for e in host], dtype=np.float64)
    gaps = sorted(idle_gaps(tr), key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        cover = np.minimum(b, h_ts + h_dur) - np.maximum(a, h_ts)
        hit = np.flatnonzero(cover > 0)
        name = "host code outside any profiled operation"
        if len(hit):  # most of the gap covered, then the innermost (shortest)
            best = hit[np.lexsort((h_dur[hit], -cover[hit]))[0]]
            name = host[best]["name"]
        named.append([name[:120], (b - a) / 1e6])
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": named}
