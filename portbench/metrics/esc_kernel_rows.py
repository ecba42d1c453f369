"""esc_kernel_rows: rows of escalation jobs that ran on the top-kt kernel
``p1_fused_topk`` (``match.esc_kernel_rows``), mean over the window's calls.
None where the program has no such counter."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.esc_kernel_rows"])
