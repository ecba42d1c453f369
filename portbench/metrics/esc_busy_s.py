"""esc_busy_s: the escalation's device time in the profiled call: the union
of the kernels, copies and sets inside the ``gpu_user_annotation``
extents of ``sg.match.esc_dispatch`` and ``sg.match.esc_download`` (the
launches made inside those ranges, on the streams that ran them), in
seconds.  The download range runs on a worker thread, whose ranges a
profiler records only when told to record every thread."""

from portbench.lib.spans import ESC_DEVICE, busy_in_extents


def read(run):
    if run.trace is None or not run.calls:
        return None
    return busy_in_extents(run.trace, ESC_DEVICE)
