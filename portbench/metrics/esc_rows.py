"""esc_rows: rows re-matched by escalation, all rounds and widths (the sum
of ``match.esc_rows_r<round>_kt<k>``), mean over the window's calls."""

from portbench.lib.readers import mean_prefixed


def read(run):
    return mean_prefixed(run, "match.esc_rows_r")
