"""other_idle_s: seconds of the profiled call with the card idle while the
calling thread was in ``sg.match`` alone, in an ``sg.*`` range no other
``*_idle_s`` metric reads, or in no ``sg.*`` range at all: the spans'
blind spot."""

from portbench.lib.spans import OTHER, idle_s


def read(run):
    return idle_s(run, OTHER)
