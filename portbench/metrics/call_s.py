"""call_s: seconds per API call, the sum of the window's call walls over
their count (one caller, back to back; each wall from the entry's call to
its returned frame); host clock."""


def read(run):
    walls = [c["wall"] for c in run.calls]
    return sum(walls) / len(walls) if walls else None
