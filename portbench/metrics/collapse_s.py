"""collapse_s: the duplicate collapse, its expansion and the self-join
fix-ups (``match.collapse`` + ``match.expand`` + ``match.fixups``), mean
over the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.collapse", "match.expand", "match.fixups"])
