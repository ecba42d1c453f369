"""mh_encode_s: the sharded tier's encode of a call on rank 0 (its shard's
encode and the global vocabulary, DF and width agreed over the ranks;
``timings["match.mh_encode_s"]``), mean over the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.mh_encode_s"])
