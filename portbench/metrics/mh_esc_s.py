"""mh_esc_s: the sharded tier's escalation ladder on rank 0, its rungs'
scans, exchanges and rescores (``timings["match.mh_esc_s"]``), mean over
the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.mh_esc_s"])
