"""p1_wait_s: the host's wait for the phase-1 scan (``match.p1_wait``),
mean over the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.p1_wait"])
