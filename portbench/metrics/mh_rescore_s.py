"""mh_rescore_s: the sharded tier's exact rescore of the first pass's
candidates on rank 0, its ring included (``timings["match.mh_rescore_s"]``),
mean over the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.mh_rescore_s"])
