"""encode_s: the host TF-IDF encode of a call (``timings["encode"]``),
mean over the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["encode"])
