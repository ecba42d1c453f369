"""mh_device_idle: the share of rank 0's profiled call with nothing on its
card, in % (``device_idle``'s arithmetic: 1 - the union of the kernel,
copy and set intervals / the call's range).  The harness profiles its own
process, rank 0, alone: the other ranks' cards are not seen."""


def read(run):
    if run.trace is None or not run.trace.device():
        return None
    return 100.0 * (1.0 - run.trace_lib.busy_s(run.trace) / run.trace.window_s)
