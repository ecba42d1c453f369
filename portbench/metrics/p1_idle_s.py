"""p1_idle_s: seconds of the profiled call with the card idle while the
calling thread set up or waited on the phase-1 scan (innermost range
``sg.match.p1_setup`` or ``sg.match.p1_wait``)."""

from portbench.lib.spans import idle_s


def read(run):
    return idle_s(run, "p1")
