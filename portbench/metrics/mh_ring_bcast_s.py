"""mh_ring_bcast_s: rank 0's seconds in the rescore ring's full-shard
broadcasts, waits for the other ranks included (the range
``sg.match.mh_ring_bcast``, ``timings["match.mh_ring_bcast_s"]``), mean
over the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.mh_ring_bcast_s"])
