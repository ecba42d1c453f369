"""The sharded tiers' two routes for device tensors between ranks
(``string_grouper_tpu_torch.parallel.multihost``: ``_route``,
``_replicate_rows``, ``_exchange_rows``).

* The rule: the default group's backend and the tensors' device type
  decide (patched ``torch.distributed``; no GPU needed), and without a
  group both functions are the identity and run no collective.
* No fallback: a direct collective that fails raises, and under nccl a
  tensor off the rank's current CUDA device raises, naming both.
* The two routes against each other: 1, 2 and 3 gloo ranks
  (tests/torch_mh_route_worker.py) hold the direct route bitwise against
  the host route, forced in the worker, and against numpy, with
  ``ROUTE_CALLS`` counting each route's collectives.
* The engine's sharded frames on the host route: the engine worker with
  ``MH_ROUTE=host`` at 2 and 3 ranks, each frame equal to the JAX
  package's (tests/test_torch_multihost.py runs the same cases on the
  direct route).
"""

import numpy as np
import pandas as pd
import pytest
import torch
import torch.distributed as dist

import test_torch_multihost as TMH
import torch_mh_engine_worker as EW
from string_grouper_tpu_torch.parallel import multihost as MH


@pytest.mark.parametrize("backend,dev,want", [
    ("gloo", "cpu", "direct"),
    ("gloo", "cuda", "host"),
    ("nccl", "cuda", "direct"),
    ("nccl", "cpu", "host"),
    ("cpu:gloo,cuda:nccl", "cpu", "direct"),
    ("cpu:gloo,cuda:nccl", "cuda", "direct"),
    ("cuda:nccl", "cpu", "host"),
    ("cuda:gloo", "cuda", "host"),
    ("mpi", "cpu", "host"),
])
def test_route_rule(monkeypatch, backend, dev, want):
    """``_route``: direct where the default group's backend carries the
    device type, host otherwise."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    assert MH._route(torch.device(dev)) == want


def _scan_out(m=5, w=3):
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.integers(-1, 50, (m, w)).astype(np.int32)),
            torch.from_numpy(rng.random(m).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 9, m).astype(np.int32)))


def test_no_group_is_the_identity():
    """Without a group: the rank's own rows, zero rows after, and its own
    rows' scan output; no collective is counted."""
    assert not dist.is_initialized()
    assert MH._route(torch.device("cpu")) == "host"
    MH.reset_route_calls()
    block = torch.randn(6, 4).to(torch.bfloat16)
    rep = MH._replicate_rows(block, np.array([4]), 7)
    assert rep.shape == (7, 4)
    assert torch.equal(rep[:4], block[:4]) and not rep[4:].any()
    cols, bound, tmax = _scan_out()
    got = MH._exchange_rows(cols, bound, tmax, np.array([0]), np.array([4]))
    for g, t in zip(got, (cols, bound, tmax)):
        np.testing.assert_array_equal(g, t[:4].numpy())
    assert not MH.ROUTE_CALLS


@pytest.fixture
def two_rank_gloo(monkeypatch):
    """rank 0 of a simulated 2-rank gloo group whose host collectives
    must not be reached, and whose device collectives fail."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)

    tried = []

    def fails(name):
        def collective(*a, **k):
            tried.append(name)
            raise RuntimeError("collective failed")
        return collective

    def host_route(*a, **k):
        raise AssertionError("fell back to the host route")

    for name in ("all_gather_single", "all_gather_into_tensor",
                 "all_to_all_single"):
        monkeypatch.setattr(dist, name, fails(name), raising=False)
    for name in ("broadcast", "gather", "new_group"):
        monkeypatch.setattr(dist, name, host_route)
    MH.reset_route_calls()
    return tried


def test_failed_direct_collective_raises(two_rank_gloo):
    """No fallback: the direct collective's error reaches the caller and
    the host route is never tried."""
    with pytest.raises(RuntimeError, match="collective failed"):
        MH._replicate_rows(torch.zeros(4, 2, dtype=torch.bfloat16),
                           np.array([3, 2]), 6)
    with pytest.raises(RuntimeError, match="collective failed"):
        MH._exchange_rows(*_scan_out(), np.array([0, 2]), np.array([2, 3]))
    assert not MH.ROUTE_CALLS
    assert len(two_rank_gloo) == 2 and two_rank_gloo[1] == "all_to_all_single"


def test_exchange_rows_must_be_contiguous(two_rank_gloo):
    """The direct exchange sends each rank's rows as one slice: rows that
    are not contiguous in rank order raise before any collective."""
    with pytest.raises(ValueError, match="not contiguous"):
        MH._exchange_rows(*_scan_out(), np.array([0, 3]), np.array([2, 2]))


def test_nccl_tensor_off_the_current_device_raises(monkeypatch):
    """Under nccl the communicator is bound to the current CUDA device: a
    tensor elsewhere raises, naming both devices."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    MH._check_direct_device(torch.device("cuda", 1))
    MH._check_direct_device(torch.device("cpu"))
    with pytest.raises(ValueError, match=r"cuda:0.*cuda:1"):
        MH._check_direct_device(torch.device("cuda", 0))


@pytest.mark.parametrize("world", [1, 2, 3])
def test_direct_route_is_bitwise_the_host_route(tmp_path, world):
    """``_replicate_rows`` and ``_exchange_rows`` on the direct route
    (gloo, CPU tensors) bitwise equal to the host route and to numpy:
    uneven counts, a rank with no rows, bf16 rows, padding rows past the
    ranks' rows, and one rank in an initialized group (which still runs
    its collective)."""
    TMH.run_ranks("torch_mh_route_worker.py", world, tmp_path,
                  ("ROUTE_OK",))


@pytest.mark.parametrize("world,n", [(2, 240), (3, 150)])
def test_host_route_engine_frames_equal_jax(tmp_path, world, n):
    """The engine's sharded cases (self, cross, tiny, ladder, and each
    over 2 cpu slots per rank) with the host route forced: every rank's
    frame equals the port's single-process frame (in the worker) and
    JAX's, exactly."""
    TMH.run_ranks("torch_mh_engine_worker.py", world, tmp_path,
                  tuple(f"ENGINE_{c.upper()}_OK" for c in EW.SHARDED_CASES)
                  + ("ENGINE_OK",),
                  env={"MH_ENGINE_N": str(n), "MH_ROUTE": "host"})
    want = TMH._jax_frames(n)
    for case in EW.SHARDED_CASES:
        for r in range(world):
            got = pd.read_pickle(tmp_path / f"{case}_{r}.pkl")
            pd.testing.assert_frame_equal(got, want[case], check_exact=True)
