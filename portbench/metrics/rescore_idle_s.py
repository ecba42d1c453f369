"""rescore_idle_s: seconds of the profiled call with the card idle while the
calling thread waited for the scoring worker or rescored and selected
itself (innermost range ``sg.match.rescore_wait``, ``sg.match.rescore``
or ``sg.match.select`` on the calling thread; the worker's ranges do not
count)."""

from portbench.lib.spans import idle_s


def read(run):
    return idle_s(run, "rescore")
