#!/usr/bin/env python3
"""Where the 663k default self-join's time goes on one NVIDIA GPU, from a
``torch.profiler`` trace (``utils.profiling.trace``).

Run from the repository root:

    python tools/trace_663k.py

It runs the default self-join (``StringGrouper(names).fit()`` then
``get_matches()``) of synthetic_company_names(663_000) three times: two
untraced (the first warms the kernels' build and the host; the second is
the warm wall to compare against) and one under ``trace``, and prints:

* the device idle share of the traced call: 1 - (the union of the device's
  busy intervals -- kernels, copies, sets -- within the call's window) /
  the call's wall;
* the split of ``match.esc_wait``.  That phase is host time: the calls
  that dispatch escalation jobs (``run_rows``: gather, product, extraction,
  compaction, all enqueued) and the waits for their results (the deferred
  finish: download).  The program marks both with its own ranges
  (``sg.match.esc_dispatch``, ``sg.match.esc_finish``, which
  ``utils.profiling.span`` opens while a profiler records), and the
  script asks what the device was doing during them: the union of the
  device intervals of each kind inside the ranges -- ``matmul`` (cuBLAS
  products), ``extraction`` (the top-k extraction's other kernels: max,
  argmax, scatter, sort, where, gather, the f32 upcasts), ``fused_scan`` (the scan kernels: kt = 2 rungs, and
  phase-1 segments still queued), ``d2h`` / ``h2d`` / ``d2d`` (memory
  copies by direction), ``memset`` -- and ``host``, the part of the
  ranges with the device idle: launch overhead and Python.  The kinds may
  overlap (several streams); ``busy`` is their union.  The escalation's
  own device time per kind is printed too: the device events of the
  launches made inside the ranges on the ranges' thread, wherever they
  ran (matched by correlation id; the downloads, which a worker thread
  issues under its own ``sg.match.esc_download`` range, count in the
  split only);
* the traced call's phases beside the warm untraced call's (tracing costs
  time per launch).

The trace is written under build/trace_663k/.  The last line is one JSON
object.
"""

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pandas as pd
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import string_grouper_tpu_torch as sgt  # noqa: E402
from string_grouper_tpu_torch.ops import kernels as K  # noqa: E402
from string_grouper_tpu_torch.utils import profiling as P  # noqa: E402
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names  # noqa: E402

N_FULL = 663_000
ROWS_FULL = 4_558_752
TRACE_DIR = ROOT / "build" / "trace_663k"
ESC_RANGES = ("sg.match.esc_dispatch", "sg.match.esc_finish")
MATMUL = re.compile(r"gemm|xmma|cutlass|cublas", re.IGNORECASE)


def self_join(s):
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.record_function("call"):
        sg = sgt.StringGrouper(s).fit()
        frame = sg.get_matches()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert len(frame) == ROWS_FULL, f"{len(frame)} rows, expected {ROWS_FULL}"
    return wall, dict(sg.timings.seconds), dict(K.LAUNCHES)


KINDS = ("matmul", "extraction", "fused_scan", "d2h", "h2d", "d2d", "memset")


def kind(e):
    cat, name = e["cat"], e["name"]
    if cat == "kernel":
        if "scan_kernel" in name:
            return "fused_scan"
        return "matmul" if MATMUL.search(name) else "extraction"
    if cat == "gpu_memset":
        return "memset"
    return "d2h" if "DtoH" in name else "h2d" if "HtoD" in name else "d2d"


def analyse(events):
    spans = [e for e in events if e.get("ph") == "X"]
    call = [e for e in spans if e.get("cat") == "user_annotation" and e["name"] == "call"]
    assert len(call) == 1, f"{len(call)} 'call' ranges in the trace"
    w0 = float(call[0]["ts"])
    window = (w0, w0 + float(call[0]["dur"]))
    device = [e for e in spans if e.get("cat") in P.DEVICE_CATS]
    assert device, "no device event in the trace"
    busy_us = P.union_us(P.device_intervals(device), window)
    esc = [e for e in spans if e.get("cat") == "user_annotation" and e["name"] in ESC_RANGES]
    esc_iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in esc]
    esc_us = P.union_us(esc_iv)
    by_kind = {k: [] for k in KINDS}
    for e in device:
        by_kind[kind(e)].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def inside(iv):  # the parts of device intervals that fall in the esc ranges
        return [(max(a, lo), min(b, hi)) for a, b in iv for lo, hi in esc_iv
                if min(b, hi) > max(a, lo)]

    split = {k: P.union_us(inside(v)) / 1e6 for k, v in by_kind.items()}
    busy_esc = P.union_us(inside([iv for v in by_kind.values() for iv in v])) / 1e6
    split["busy"] = busy_esc
    split["host"] = esc_us / 1e6 - busy_esc
    # the escalation's own device work: launches (runtime calls) made inside
    # the ranges on the ranges' threads, matched to device events
    launches = [e for e in spans if e.get("cat") == "cuda_runtime"]
    own_corr = set()
    for e in launches:
        t = float(e["ts"])
        for r in esc:
            if r["tid"] == e["tid"] and r["ts"] <= t <= r["ts"] + r["dur"]:
                own_corr.add(e["args"].get("correlation"))
                break
    own = {k: 0.0 for k in KINDS}
    for e in device:
        if e.get("args", {}).get("correlation") in own_corr:
            own[kind(e)] += float(e["dur"]) / 1e6
    return dict(
        window_s=(window[1] - window[0]) / 1e6, device_busy_s=busy_us / 1e6,
        idle_share=1.0 - busy_us / (window[1] - window[0]),
        esc_ranges=len(esc), esc_ranges_s=esc_us / 1e6, esc_wait_split_s=split,
        esc_own_device_s=own,
        kernel_s={k[:120]: sum(v) / 1e6 for k, v in sorted(
            P.kernel_durations(device).items(), key=lambda kv: -sum(kv[1]))[:12]},
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_663k: no CUDA GPU visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    s = pd.Series(synthetic_company_names(N_FULL))
    cold = self_join(s)
    warm = self_join(s)
    print(f"untraced: cold {cold[0]:.3f} s, warm {warm[0]:.3f} s "
          f"(esc_wait {warm[1]['match.esc_wait']:.3f} s)", flush=True)
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with P.trace(log_dir=str(TRACE_DIR)):
        traced = self_join(s)
    t0 = time.perf_counter()
    path = P.trace_files(str(TRACE_DIR))[-1]
    res = analyse(P.read_trace(path))
    print(f"trace {path.name}: {path.stat().st_size} bytes, read in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    secs = traced[1]
    res.update(
        wall_traced_s=traced[0], wall_warm_s=warm[0], wall_cold_s=cold[0],
        esc_wait_traced_s=secs["match.esc_wait"], esc_wait_warm_s=warm[1]["match.esc_wait"],
        launches=traced[2],
        phases_traced={k: v for k, v in secs.items() if isinstance(v, float)},
        phases_warm={k: v for k, v in warm[1].items() if isinstance(v, float)},
    )
    print(f"traced call: wall {traced[0]:.3f} s, device busy {res['device_busy_s']:.3f} s "
          f"of the {res['window_s']:.3f} s window: idle share {res['idle_share']:.4f}",
          flush=True)
    print(f"match.esc_wait {secs['match.esc_wait']:.3f} s; its ranges {res['esc_ranges']} "
          f"covering {res['esc_ranges_s']:.3f} s; device during them: "
          + json.dumps(res["esc_wait_split_s"]), flush=True)
    print("escalation's own device time by kind (s): " + json.dumps(res["esc_own_device_s"]),
          flush=True)
    print(card)
    print(json.dumps(dict(card=card, **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
