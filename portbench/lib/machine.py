"""What the run ran on: the card's name, power limit and clocks (from
``nvidia-smi`` where it answers), the host's CPUs, a fixed host task's
time, the host CPU a call used per second of its wall, and the peaks of
the card from ``peaks.json``."""

from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path
from typing import Optional

_QUERY = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"


def smi() -> str:
    """One CSV line per card, or why there is none."""
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={_QUERY}", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return (r.stdout.strip() or r.stderr.strip()).replace("\n", " | ")


def cpus() -> str:
    try:
        usable = len(os.sched_getaffinity(0))
    except AttributeError:
        usable = os.cpu_count()
    model = "unknown model"
    try:
        with open("/proc/cpuinfo") as f:
            model = next(ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith("model name"))
    except (OSError, StopIteration):
        pass
    return f"{os.cpu_count()} CPUs ({model}), {usable} usable by this process"


def cpu_per_wall(before, after, wall_s: float) -> float:
    """CPU seconds (user and system, all threads of the process) per second
    of wall over one call, from two ``getrusage`` readings: a call that is
    slower at the same CPU per wall ran on slower cores; one with less CPU
    per wall waited."""
    cpu = after.ru_utime + after.ru_stime - before.ru_utime - before.ru_stime
    return cpu / wall_s if wall_s > 0 else 0.0


def host_probe() -> float:
    """Seconds of a fixed host task (a sort and a pass over 4 M doubles,
    the median of three): read before and after the window, it tells a
    slower host apart from a slower program."""
    import time

    import numpy as np

    a = np.random.default_rng(0).random(4_000_000)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        np.sort(a)
        (a * 2.0 + 1.0).sum()
        times.append(time.perf_counter() - t0)
    return sorted(times)[1]


def peaks(card: str) -> Optional[dict]:
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    return table["cards"].get(card)
