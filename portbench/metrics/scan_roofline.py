"""scan_roofline: the phase-1 product's share of its roofline, in %.

The least time is the product the inputs need, at the card's dense bf16
peak: a self-join scores each unordered pair of distinct cleaned strings
once, n (n + 1) / 2 pairs; a cross-join L x R; each pair is hash_dim
multiply-adds.  The distinct counts come from the benchmark's own
cleaning.  The time is the device time, in the profiled call, of every
kernel of the scan family (names below), escalation's kt = 2 relaunches
included.  A scan that computes the whole square reads at most about half
its kernel table share; a triangular scan can read up to 100%."""

KERNELS = ("scan_kernel", "tri_fold_kernel")


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    lo, hi = run.trace.window
    t = sum(e["dur"] for e in run.trace.device()
            if e["cat"] == "kernel" and any(k in e["name"] for k in KERNELS)
            and e["ts"] < hi and e["ts"] + e["dur"] > lo) / 1e6
    if t <= 0:
        return None
    if run.self_join:
        (n,) = run.distinct.values()
        pairs = n * (n + 1) / 2
    else:
        pairs = run.distinct["master"] * run.distinct["new"]
    least = pairs * run.hash_dim * 2 / run.peaks["bf16_dense_flop_per_s"]
    return 100.0 * least / t
