"""pairs_scored: candidate pairs rescored exactly on the host
(``match.pairs_scored``), mean over the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.pairs_scored"])
