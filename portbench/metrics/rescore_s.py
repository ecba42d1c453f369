"""rescore_s: the exact host rescore and the top-n selection
(``match.rescore`` + ``match.select``), mean over the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.rescore", "match.select"])
