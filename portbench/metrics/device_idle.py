"""device_idle: the share of the profiled call's wall with no kernel, copy
or set on the card, in % (1 - the union of the device intervals / the
call's range: ``tools/trace_663k.py``'s arithmetic, copied into
``lib/trace.py``)."""


def read(run):
    if run.trace is None or not run.trace.device():
        return None
    return 100.0 * (1.0 - run.trace_lib.busy_s(run.trace) / run.trace.window_s)
