"""mh_ring_bytes: the bytes rank 0 sent or received through the rescore
ring's broadcasts in a call (``timings["match.mh_ring_bytes"]``), mean
over the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.mh_ring_bytes"])
