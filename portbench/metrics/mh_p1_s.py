"""mh_p1_s: the sharded tier's phase 1 on rank 0 (its right block hashed,
the left hash replicated, the first pass of ``p1_fused_closed2`` over every
left row against its block, the candidate exchange;
``timings["match.mh_p1_s"]``), mean over the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.mh_p1_s"])
