"""encode_idle_s: seconds of the profiled call with the card idle while the
calling thread checked the input lists or encoded them on the host
(innermost range ``sg.validate``: the constructor's check that every input
is a string; ``sg.encode``: the TF-IDF encode); the six ``*_idle_s``
metrics add up to the call's idle seconds."""

from portbench.lib.spans import idle_s


def read(run):
    return idle_s(run, "encode")
