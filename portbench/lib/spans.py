"""The program's own ranges in the profiled call: the idle stretches of the
card split by the ``sg.*`` range that held the calling thread, and the
card's busy time inside given ranges' device extents.

The port opens a ``record_function`` range ``sg.<name>`` around each of
its phases while a profiler records (``utils/profiling.py::span``).  The
profiler writes each range twice: on the host thread that opened it
(``user_annotation``, the CPU clock), and, for the kernels and copies
launched inside it, as a ``gpu_user_annotation`` extent on each stream
that ran them (from the first such launch's start to the last one's end).
Both are on the clock of the device events, so an idle stretch of
``trace.idle_gaps`` can be put down to the range that was open on the
calling thread (the thread of ``portbench.call``) at each of its instants.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Tuple

from portbench.lib import trace as trace_lib

PREFIX = "sg."

#: the port's calling-thread ranges by the layer whose idle they read; the
#: rest (``sg.match`` alone, ranges not listed, no range) reads as other
IDLE_GROUPS = {
    "encode": ("sg.validate", "sg.encode"),
    "p1": ("sg.match.p1_setup", "sg.match.p1_wait"),
    "esc": ("sg.match.esc_dispatch", "sg.match.esc_finish", "sg.match.esc_download"),
    "rescore": ("sg.match.rescore_wait", "sg.match.rescore", "sg.match.select"),
    "tail": ("sg.match.collapse", "sg.match.expand", "sg.match.fixups",
             "sg.assemble", "sg.frame"),
}
OTHER = "other"
#: the ranges whose device extents hold the escalation's own device work
ESC_DEVICE = ("sg.match.esc_dispatch", "sg.match.esc_download")


def calling_tid(tr: trace_lib.Trace):
    """The host thread of the profiled call (its ``portbench.call`` range)."""
    for e in tr.events:
        if e["cat"] == "user_annotation" and e["name"] == trace_lib.CALL_RANGE:
            return e["tid"]
    return None


def innermost(ranges: Iterable[Tuple[float, float, str]],
              window: Tuple[float, float]) -> List[Tuple[float, float, Optional[str]]]:
    """The window cut into stretches, each with the innermost of the given
    (start, end, name) ranges open through it (None: no range).  The
    ranges of one thread nest; a child that ends past its parent (clock
    rounding) is cut at the parent's end."""
    lo, hi = window
    out: List[Tuple[float, float, Optional[str]]] = []
    stack: List[Tuple[float, str]] = []     # (end, name), innermost last
    cur = lo

    def emit(a, b, name):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b, name))

    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= a:
            end, top = stack.pop()
            emit(cur, end, top)
            cur = max(cur, end)
        emit(cur, a, stack[-1][1] if stack else None)
        cur = max(cur, a)
        stack.append((min(b, stack[-1][0]) if stack else b, name))
    while stack:
        end, top = stack.pop()
        emit(cur, end, top)
        cur = max(cur, end)
    emit(cur, hi, None)
    return out


def idle_by_range(tr: trace_lib.Trace) -> Dict[Optional[str], float]:
    """Seconds of the call's idle stretches under each innermost ``sg.*``
    range of the calling thread (None: under none)."""
    tid = calling_tid(tr)
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in tr.events
              if e["cat"] == "user_annotation" and e["tid"] == tid
              and e["name"].startswith(PREFIX)]
    stretches = innermost(ranges, tr.window)
    out: Dict[Optional[str], float] = {}
    i = 0
    for a, b in trace_lib.idle_gaps(tr):       # both lists sorted, disjoint
        while i < len(stretches) and stretches[i][1] <= a:
            i += 1
        j = i
        while j < len(stretches) and stretches[j][0] < b:
            s0, s1, name = stretches[j]
            cut = min(b, s1) - max(a, s0)
            if cut > 0:
                out[name] = out.get(name, 0.0) + cut / 1e6
            j += 1
    return out


def idle_s(run, group: str) -> Optional[float]:
    """A layer's share of the profiled call's idle seconds (``group`` a key
    of ``IDLE_GROUPS`` or ``OTHER``).  None without a trace or calls; 0.0
    where the trace holds no device event (the CPU) or no ``sg.*`` range of
    the calling thread (a program without spans), which splits nothing."""
    tr = run.trace
    if tr is None or not run.calls:
        return None
    if not tr.device():
        return 0.0
    by_range = idle_by_range(tr)
    if set(by_range) <= {None}:
        return 0.0
    if group == OTHER:
        named = {n for names in IDLE_GROUPS.values() for n in names}
        return sum(s for n, s in by_range.items() if n not in named)
    return sum(by_range.get(n, 0.0) for n in IDLE_GROUPS[group])


def busy_in_extents(tr: trace_lib.Trace, names: Iterable[str]) -> float:
    """Seconds of the union of the device intervals that lie inside the
    ``gpu_user_annotation`` extents of the named ranges, each extent taken
    on its own stream, within the call's window."""
    names = set(names)
    extents = [e for e in tr.events
               if e["cat"] == "gpu_user_annotation" and e["name"] in names]
    if not extents:
        return 0.0
    by_stream: Dict[object, Tuple[List[float], List[float]]] = {}
    for a, b, tid in sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in tr.device()):
        starts, ends = by_stream.setdefault(tid, ([], []))
        starts.append(a)
        ends.append(b)
    inside = []
    for x in extents:
        lo, hi = x["ts"], x["ts"] + x["dur"]
        starts, ends = by_stream.get(x["tid"], ([], []))
        k = bisect_left(starts, lo)
        k = max(0, k - 1)                  # an interval may start before lo
        while k < len(starts) and starts[k] < hi:
            a, b = max(starts[k], lo), min(ends[k], hi)
            if b > a:
                inside.append((a, b))
            k += 1
    return trace_lib.union_us(inside, tr.window) / 1e6
