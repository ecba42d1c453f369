"""mh_comm_s: rank 0's seconds in the sharded tier's device collectives,
the left hash's replication and every candidate exchange of the first pass
and the escalation rungs (``timings["match.mh_replicate_s"]`` +
``["match.mh_exchange_s"]``: the ranges ``sg.match.mh_replicate`` and
``sg.match.mh_exchange``, waits for the other ranks included), mean over
the window's calls."""

from portbench.lib.readers import mean_timing


def read(run):
    return mean_timing(run, ["match.mh_replicate_s", "match.mh_exchange_s"])
