"""rescore_wait_s: the calling thread's wait for the scoring worker
(``match.rescore_wait``, range ``sg.match.rescore_wait``), mean over the
window's calls: how much of the worker's rescore lies on the critical
path."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.rescore_wait"])
