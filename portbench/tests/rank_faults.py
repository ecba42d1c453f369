"""Worker ranks with a planted fault, for test_portbench_sharded.py.  Each
takes :func:`portbench.lib.ranks.serve`'s arguments, plants its fault in
its own process, then serves."""

import os
import signal

from portbench.lib import ranks


def altered_frame(rank, *args):
    """Rank 3 answers with one similarity changed by 1e-6."""
    if rank == 3:
        from string_grouper_tpu_torch import engine

        real = engine.StringGrouper.get_matches

        def get_matches(self, *a, **k):
            frame = real(self, *a, **k)
            frame.loc[frame.index[0], "similarity"] -= 1e-6
            return frame
        engine.StringGrouper.get_matches = get_matches
    ranks.serve(rank, *args)


def killed_in_second_call(rank, *args):
    """Rank 2 is killed (SIGKILL) in its second call, as the call's
    replication of the left hash starts, while its peers enter that
    collective."""
    if rank == 2:
        from string_grouper_tpu_torch.parallel import multihost

        real = multihost._replicate_rows
        calls = []

        def replicate(*a, **k):
            calls.append(1)
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGKILL)
            return real(*a, **k)
        multihost._replicate_rows = replicate
    ranks.serve(rank, *args)
