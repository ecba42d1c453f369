"""Per-phase wall times of a fit (``StringGrouper.timings``) and the one
span helper behind every phase timer of the package (:func:`span`), and
:func:`trace`, which wraps a block in ``torch.profiler`` for device traces
that TensorBoard and Perfetto read, with readers of the trace it writes
(the counterpart of ``string_grouper_tpu.utils.profiling``)."""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def span(name: str, seconds: Optional[Dict[str, float]] = None,
         key: Optional[str] = None) -> Iterator[None]:
    """Time the enclosed block: its host seconds (``perf_counter``) add
    into ``seconds[key]`` (``key`` defaults to ``name``; without
    ``seconds`` the span only marks the trace).

    While a ``torch.profiler`` records, and only then, the block is also a
    ``record_function`` range ``sg.<name>`` on the calling thread, so the
    trace holds it on the clock of the card's kernels and copies.  The
    check is one read of ``torch.autograd.profiler._is_profiler_enabled``,
    a module flag the profiler sets for every thread (unlike the
    thread-local ``torch._C._autograd._profiler_enabled``); with no
    profiler recording no range object is made.  A worker thread's range
    shows in a trace only when the profiler records every thread
    (:func:`trace` does).  A span on a worker thread times into a dict of
    its own, which the thread that owns ``seconds`` folds in: no dict is
    written from two threads."""
    rf = None
    if _autograd_profiler._is_profiler_enabled:
        rf = _autograd_profiler.record_function(f"sg.{name}")
        rf.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if rf is not None:
            rf.__exit__(None, None, None)
        if seconds is not None:
            k = name if key is None else key
            seconds[k] = seconds.get(k, 0.0) + dt


@dataclass
class PhaseTimings:
    """Wall-clock seconds per pipeline phase of the most recent fit.

    ``seconds`` holds numbers only (float walls plus int counters such as
    ``match.rounds``); non-numeric per-fit facts (which multi-host tier
    ran) live in ``labels``, so numeric readers of ``seconds`` never
    break."""

    seconds: Dict[str, float] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)

    def phase(self, name: str):
        """:func:`span` ``sg.<name>``, adding into ``seconds[name]``."""
        return span(name, self.seconds)

    def reset(self) -> None:
        self.seconds.clear()
        self.labels.clear()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        body = ", ".join(
            f"{k}={v}" if isinstance(v, int) else f"{k}={v:.3f}s"
            for k, v in self.seconds.items()
        )
        return f"PhaseTimings({body})"


_TRACE_LOCK = threading.Lock()
_TRACING = False


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/string_grouper_tpu_trace") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block: CPU
    activity on every thread (the worker threads' :func:`span` ranges
    included), and CUDA activity (kernels, copies, sets) when a GPU is
    present.  On exit it writes ``<host>_<pid>.<ns>.pt.trace.json`` under
    ``log_dir`` (``tensorboard_trace_handler``: TensorBoard's profiler
    plugin, Perfetto and chrome://tracing read it; :func:`trace_files`
    lists them).  A trace inside a running trace raises ``RuntimeError``,
    as a nested ``jax.profiler.start_trace`` does."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    global _TRACING
    with _TRACE_LOCK:
        if _TRACING:
            raise RuntimeError("trace: a trace is already running (traces do not nest)")
        _TRACING = True
    try:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=activities,
                     experimental_config=_ExperimentalConfig(profile_all_threads=True),
                     on_trace_ready=tensorboard_trace_handler(log_dir)):
            yield
    finally:
        with _TRACE_LOCK:
            _TRACING = False


def trace_files(log_dir: str) -> List[Path]:
    """The trace files :func:`trace` wrote under ``log_dir``, oldest first."""
    found = [*Path(log_dir).glob("*.pt.trace.json"),
             *Path(log_dir).glob("*.pt.trace.json.gz")]
    return sorted(found, key=lambda f: f.stat().st_mtime_ns)


def read_trace(path) -> List[dict]:
    """The events of a trace file (Chrome trace format): timestamps
    ``ts`` and durations ``dur`` in microseconds, ``cat`` the kind
    (``cpu_op``, ``user_annotation``, ``cuda_runtime``, ``kernel``,
    ``gpu_memcpy``, ``gpu_memset``, ...)."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


#: event kinds during which the device is busy
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(events: Iterable[dict],
                     cats: Iterable[str] = DEVICE_CATS) -> List[Tuple[float, float]]:
    """(start, end) in microseconds of every device event of the kinds
    ``cats``: kernels, memory copies and memory sets by default."""
    cats = tuple(cats)
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in events if e.get("cat") in cats and e.get("ph") == "X"]


def union_us(intervals: Iterable[Tuple[float, float]],
             window: Optional[Tuple[float, float]] = None) -> float:
    """Length of the union of the intervals (clipped to ``window``), in
    microseconds: overlapping streams count once."""
    total, end = 0.0, None
    lo, hi = window if window is not None else (float("-inf"), float("inf"))
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def kernel_durations(events: Iterable[dict]) -> Dict[str, List[float]]:
    """Each kernel's durations in microseconds, by kernel name."""
    out: Dict[str, List[float]] = {}
    for e in events:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            out.setdefault(e["name"], []).append(float(e.get("dur", 0)))
    return out
