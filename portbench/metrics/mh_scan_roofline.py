"""mh_scan_roofline: rank 0's phase-1 scan against one card's even share
of the self-join's roofline, in %.

The least time is ``scan_roofline``'s: the n (n + 1) / 2 pairs of distinct
cleaned strings a self-join needs, each hash_dim multiply-adds, at the
card's dense bf16 peak, here divided by the ranks
(``timings["match.mh_world"]``), so that each card's even share of the
work is its bound.  The time is the device time of the scan family
(``scan_kernel``, ``tri_fold_kernel``) in rank 0's profiled call: the
profiler sees this process alone.  A rank that scans every left row
against its whole block reads at most about half; a triangular or
collapsing sharded scan can read up to 100%."""

from portbench.lib.readers import mean_timing

KERNELS = ("scan_kernel", "tri_fold_kernel")


def read(run):
    world = mean_timing(run, ["match.mh_world"])
    if run.trace is None or run.peaks is None or not world:
        return None
    lo, hi = run.trace.window
    t = sum(e["dur"] for e in run.trace.device()
            if e["cat"] == "kernel" and any(k in e["name"] for k in KERNELS)
            and e["ts"] < hi and e["ts"] + e["dur"] > lo) / 1e6
    if t <= 0:
        return None
    (n,) = run.distinct.values()
    least = n * (n + 1) / 2 / world * run.hash_dim * 2 / run.peaks["bf16_dense_flop_per_s"]
    return 100.0 * least / t
