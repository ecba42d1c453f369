"""mh_esc_rows: the rows the sharded tier's first pass left unsafe, over
every rank (``timings["match.mh_esc_rows"]``), mean over the window's
calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.mh_esc_rows"])
