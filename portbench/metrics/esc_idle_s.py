"""esc_idle_s: seconds of the profiled call with the card idle while the
calling thread dispatched escalation jobs or waited for their results
(innermost range ``sg.match.esc_dispatch`` or ``sg.match.esc_finish``,
or ``sg.match.esc_download`` where the calling thread downloads itself):
the host side of ``match.esc_wait``."""

from portbench.lib.spans import idle_s


def read(run):
    return idle_s(run, "esc")
