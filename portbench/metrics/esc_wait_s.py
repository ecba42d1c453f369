"""esc_wait_s: the host's time in escalation, dispatch and waits
(``match.esc_wait``), mean over the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.esc_wait"])
