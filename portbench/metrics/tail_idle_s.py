"""tail_idle_s: seconds of the profiled call with the card idle in the
duplicate collapse, its expansion, the self-join fix-ups, the matches list
and the output frame (innermost range ``sg.match.collapse``,
``sg.match.expand``, ``sg.match.fixups``, ``sg.assemble`` or
``sg.frame``)."""

from portbench.lib.spans import idle_s


def read(run):
    return idle_s(run, "tail")
