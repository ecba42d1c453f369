"""collapse_native_rows: rows whose duplicate grouping the native one-pass
``clean_group_positions`` made, both lists together
(``match.collapse_native_rows``), mean over the window's calls.  None where
the program has no such counter."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.collapse_native_rows"])
