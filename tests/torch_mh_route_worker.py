"""One rank of the sharded tiers' two routes for device tensors
(tests/test_torch_multihost_route.py).

Run as: python torch_mh_route_worker.py <rank> <world> <port> <out_dir>

Joins a gloo group at tcp://127.0.0.1:<port>, so CPU tensors take the
DIRECT route (one collective on the tensors' device).  For each seeded
case of ``CASES`` it runs ``_replicate_rows`` and ``_exchange_rows`` on
the direct route, then again with the HOST route forced (``_route``
patched in this process), and holds the two bitwise against each other
and against the numpy result every rank computes from the same seeds;
``ROUTE_CALLS`` must count the collectives each route ran.  Prints
'ROUTE_OK <rank>'.  Imports only the port.
"""

import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from string_grouper_tpu_torch.parallel import multihost as MH  # noqa: E402

REAL_ROUTE = MH._route
D, W = 6, 3
# per world: (rows per rank, padding rows past them); uneven counts and a
# rank with no rows at every world above 1
CASES = {
    1: [([4], 0), ([4], 3), ([0], 2)],
    2: [([5, 0], 2), ([2, 7], 0), ([3, 3], 1)],
    3: [([5, 0, 3], 2), ([1, 4, 2], 0), ([0, 0, 2], 1)],
}


def rank_block(seed: int, rank: int, n: int, extra: int) -> torch.Tensor:
    """Rank ``rank``'s bf16 rows of a case, ``extra`` nonzero rows after
    them (a padded block: they must not reach any peer)."""
    rng = np.random.default_rng((seed, rank))
    x = rng.standard_normal((n + extra, D)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def scan_out(seed: int, rank: int, m: int):
    """Rank ``rank``'s phase-1 output over all m left rows: cols (-1
    sentinels included), bound (-inf where nothing dropped), tmax."""
    rng = np.random.default_rng((seed, 100 + rank))
    cols = rng.integers(-1, 1000, (m, W)).astype(np.int32)
    bound = rng.random(m).astype(np.float32)
    bound[rng.random(m) < 0.4] = -np.inf
    tmax = rng.integers(0, 9, m).astype(np.int32)
    return torch.from_numpy(cols), torch.from_numpy(bound), torch.from_numpy(tmax)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def run_case(seed, rank, world, counts, pad):
    counts = np.array(counts, np.int64)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    n_rows = int(counts.sum()) + pad
    block = rank_block(seed, rank, int(counts[rank]), 2)
    want = torch.zeros((n_rows, D), dtype=torch.bfloat16)
    for p in range(world):
        want[starts[p]:starts[p] + counts[p]] = rank_block(
            seed, p, int(counts[p]), 2)[:counts[p]]
    outs = [scan_out(seed, p, n_rows) for p in range(world)]
    lo, hi = int(starts[rank]), int(starts[rank] + counts[rank])
    want_ex = (np.concatenate([o[0][lo:hi].numpy() for o in outs], 1),
               np.max([o[1][lo:hi].numpy() for o in outs], 0),
               np.max([o[2][lo:hi].numpy() for o in outs], 0))

    got = {}
    for route in ("direct", "host"):
        MH.reset_route_calls()
        got[route] = (
            MH._replicate_rows(block, counts, n_rows),
            MH._exchange_rows(*outs[rank], starts, counts),
            dict(MH.ROUTE_CALLS),
        )
        MH._route = (lambda device: "host")  # forced for the second pass
    MH._route = REAL_ROUTE

    # the host replication broadcasts each rank's rows that has any; both
    # exchanges are one all-to-all, even in a one-rank group
    senders = int((counts > 0).sum()) if world > 1 else 0
    assert got["direct"][2] == {("direct", "replicate"): 1,
                                ("direct", "exchange"): 1}, got["direct"][2]
    assert got["host"][2] == {**({("host", "replicate"): senders} if senders else {}),
                              ("host", "exchange"): 1}, got["host"][2]
    for route, (rep, ex, _calls) in got.items():
        tag = f"{route} {counts.tolist()} pad {pad}"
        assert rep.dtype == torch.bfloat16 and rep.shape == (n_rows, D), tag
        np.testing.assert_array_equal(bits(rep), bits(want), err_msg=tag)
        for g, w in zip(ex, want_ex):
            assert g.dtype == w.dtype and g.shape == w.shape, (tag, g.dtype, g.shape)
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=tag)


def main():
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=timedelta(seconds=60),
    )
    try:
        assert MH._route(torch.device("cpu")) == "direct"
        assert MH._route(torch.device("cuda")) == "host"
        for seed, (counts, pad) in enumerate(CASES[world]):
            run_case(seed, rank, world, counts, pad)
            print(f"ROUTE_CASE_OK {rank} {counts} pad {pad}", flush=True)
        print(f"ROUTE_OK {rank}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
