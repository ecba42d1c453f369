"""One rank of the port's production multi-process tiers through the engine
(tests/test_torch_multihost.py; the port's form of tests/mh_engine_worker.py).

Run as: python torch_mh_engine_worker.py <rank> <world> <port> <out_dir>

Joins a gloo group at tcp://127.0.0.1:<port>.  Every rank calls the SAME
API with the SAME full Series; the engine shards encode and matching across
the ranks (auto-selected from the group, or ``multihost="sharded"``) and
every rank gets the identical full output, which this worker holds against
the port's own single-process frame (``multihost=False``).  It writes each
frame to ``<out_dir>/<case>_<rank>.pkl`` for the test to hold against the
JAX package, and prints 'ENGINE_<CASE>_OK <rank>' per case, then
'ENGINE_OK <rank>'.  The sharded tier also runs with 2 cpu device slots
per rank (``mesh=``, the JAX worker's 2 devices per process), and with 1
slot on rank 0 beside 2 on the others, which must raise on every rank
('ENGINE_SLOTS_MISMATCH_OK <rank>').  Every rank runs on the CPU, so the
sharded cases' device tensors take the direct route (one collective on the
CPU tensors, ``multihost.ROUTE_CALLS``).  ``MH_ROUTE=host`` forces the host
route in this process (``multihost._route`` patched) and runs only the
sharded cases.  Imports only the port.
"""

import os
import sys
from datetime import timedelta

import numpy as np
import pandas as pd
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import string_grouper_tpu_torch as sgt  # noqa: E402
from string_grouper_tpu_torch import StringGrouper  # noqa: E402
from string_grouper_tpu_torch.parallel import make_mesh  # noqa: E402
from string_grouper_tpu_torch.parallel import multihost as MH  # noqa: E402


# the cases of the sharded tier, which move device tensors between ranks
SHARDED_CASES = ("sharded", "sharded_cross", "tiny", "ladder", "sharded_slots",
                 "sharded_cross_slots", "ladder_slots")


def names(n, seed):
    """tests/mh_engine_worker.py's corpus, element for element."""
    rng = np.random.default_rng(seed)
    stems = ["hyper", "mega", "quantum", "global", "acme", "stellar",
             "apex", "vertex", "summit", "cascade"]
    kinds = ["industries", "holdings", "systems", "partners"]
    out = []
    for _ in range(n):
        s = f"{rng.choice(stems)} {rng.choice(stems)} {rng.choice(kinds)}"
        if rng.random() < 0.4:
            p = int(rng.integers(0, len(s)))
            s = s[:p] + s[p + 1:]
        out.append(s)
    return pd.Series(out)


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=timedelta(seconds=60),
    )
    try:
        run(rank, world, out_dir)
    finally:
        dist.destroy_process_group()


def run(rank, world, out_dir):
    route = os.environ.get("MH_ROUTE", "direct")
    if route == "host":
        MH._route = lambda device: "host"
    n = int(os.environ.get("MH_ENGINE_N", "240"))
    series = names(n, seed=5)
    dup = names(n // 2, seed=6)
    ids = pd.Series([f"id{i}" for i in range(n)])
    dids = pd.Series([f"d{i}" for i in range(n // 2)])

    def case(label, got, oracle_fn, sg=None):
        """Hold ``got`` against the single-process frame, save it, report."""
        if label in SHARDED_CASES:
            # the fit's device tensors took the route, and only it
            assert set(MH.ROUTE_CALLS) == {(route, "replicate"),
                                           (route, "exchange")}, MH.ROUTE_CALLS
            MH.reset_route_calls()
        want = oracle_fn()
        if isinstance(want, pd.DataFrame):
            pd.testing.assert_frame_equal(got, want, check_exact=True)
        else:
            pd.testing.assert_series_equal(got, want, check_exact=True)
        got.to_pickle(os.path.join(out_dir, f"{label}_{rank}.pkl"))
        tier = "" if sg is None else f" tier {sg.timings.labels['multihost_tier']}"
        print(f"ENGINE_{label.upper()}_OK {rank}{tier}", flush=True)

    # one native thread per rank: the ranks share the host's cores
    kw = dict(device="cpu", number_of_processes=1)
    if route == "direct":
        # auto-selection: a plain engine call inside a group of several ranks
        # routes through the multi-process tier
        sg = StringGrouper(series, min_similarity=0.6, **kw).fit()
        assert "match.mh_match_s" in sg.timings.seconds, sg.timings.seconds
        assert sg.timings.labels["multihost_tier"] == "replicated"
        stages = {k: v for k, v in sg.timings.seconds.items() if "mh_" in k}
        print(f"STAGES {rank} {stages}", flush=True)
        case("self", sg.get_matches(), lambda: sgt.match_strings(
            series, min_similarity=0.6, multihost=False, **kw), sg)

        case("cross", sgt.match_strings(series, dup, ids, dids,
                                        min_similarity=0.5, **kw),
             lambda: sgt.match_strings(series, dup, ids, dids, min_similarity=0.5,
                                       multihost=False, **kw))
        case("groups", sgt.group_similar_strings(series, ids, min_similarity=0.6,
                                                 **kw),
             lambda: sgt.group_similar_strings(series, ids, min_similarity=0.6,
                                               multihost=False, **kw))
        case("top1", sgt.match_most_similar(series, dup, min_similarity=0.5, **kw),
             lambda: sgt.match_most_similar(series, dup, min_similarity=0.5,
                                            multihost=False, **kw))

        # float32 shards the encode too: the replicated tier's stage keys show
        # that no full-corpus local encode ran
        sg32 = StringGrouper(series, min_similarity=0.5,
                             tfidf_matrix_dtype=np.float32, **kw).fit()
        assert "match.mh_encode_s" in sg32.timings.seconds
        assert "match.mh_ell_allgather_s" in sg32.timings.seconds
        case("f32", sg32.get_matches(), lambda: sgt.match_strings(
            series, min_similarity=0.5, tfidf_matrix_dtype=np.float32,
            multihost=False, **kw), sg32)

    # the sharded tier: no full-corpus ELL on any rank -- per-rank exact
    # ELL bytes ~1/world of what the replicated tier holds, one remote
    # shard at a time in the ring
    sg_sh = StringGrouper(series, min_similarity=0.6, multihost="sharded",
                          **kw).fit()
    st = sg_sh.timings.seconds
    assert sg_sh.timings.labels["multihost_tier"] == "sharded", st
    assert "match.mh_ell_allgather_s" not in st, st
    local_b = st["match.mh_mem_local_ell_bytes"]
    full_b = st["match.mh_mem_replicated_ell_bytes"]
    visit_b = st["match.mh_mem_peak_visit_bytes"]
    assert local_b * world <= full_b * 1.5, (local_b, full_b, world)
    assert visit_b <= (full_b * 1.5) / world + 1, (visit_b, full_b, world)
    print(f"MEM {rank} local={local_b} visit={visit_b} replicated={full_b}",
          flush=True)
    case("sharded", sg_sh.get_matches(), lambda: sgt.match_strings(
        series, min_similarity=0.6, multihost=False, **kw), sg_sh)
    case("sharded_cross", sgt.match_strings(
        series, dup, ids, dids, min_similarity=0.5, multihost="sharded", **kw),
        lambda: sgt.match_strings(series, dup, ids, dids, min_similarity=0.5,
                                  multihost=False, **kw))

    # a corpus smaller than the world: trailing ranks get EMPTY shards
    tiny = pd.Series(["acme corp", "acme corp."])
    case("tiny", sgt.match_strings(tiny, min_similarity=0.5,
                                   multihost="sharded", **kw),
         lambda: sgt.match_strings(tiny, min_similarity=0.5, multihost=False,
                                   **kw))

    # the sharded ladder under real collectives: clusters of identical
    # strings overflow the kt=2 extraction, so unsafe rows climb the
    # ladder on every rank in lock-step
    dup_heavy = pd.Series([f"cluster {i % 7} holdings corp" for i in range(90)]
                          + list(names(30, seed=9)))
    sg_esc = StringGrouper(dup_heavy, min_similarity=0.5, multihost="sharded",
                           **kw).fit()
    assert sg_esc.timings.seconds.get("match.mh_esc_rows", 0) > 0, (
        sg_esc.timings.seconds)
    case("ladder", sg_esc.get_matches(), lambda: sgt.match_strings(
        dup_heavy, min_similarity=0.5, multihost=False, **kw), sg_esc)

    # the sharded tier over 2 device slots per rank: n_dev = 2 x world
    slots = dict(kw, multihost="sharded", mesh=make_mesh(2, device="cpu"))
    sg_sl = StringGrouper(series, min_similarity=0.6, **slots).fit()
    case("sharded_slots", sg_sl.get_matches(), lambda: sgt.match_strings(
        series, min_similarity=0.6, multihost=False, **kw), sg_sl)
    case("sharded_cross_slots", sgt.match_strings(
        series, dup, ids, dids, min_similarity=0.5, **slots),
        lambda: sgt.match_strings(series, dup, ids, dids, min_similarity=0.5,
                                  multihost=False, **kw))
    sg_esc2 = StringGrouper(dup_heavy, min_similarity=0.5, **slots).fit()
    assert sg_esc2.timings.seconds.get("match.mh_esc_rows", 0) > 0
    case("ladder_slots", sg_esc2.get_matches(), lambda: sgt.match_strings(
        dup_heavy, min_similarity=0.5, multihost=False, **kw), sg_esc2)

    if route == "direct":
        # slot counts that differ between ranks raise on every rank, no hang
        mixed = dict(slots, mesh=None if rank == 0 else slots["mesh"])
        try:
            sgt.match_strings(series, min_similarity=0.6, **mixed)
        except ValueError as e:
            assert "slot counts differ" in str(e), e
            print(f"ENGINE_SLOTS_MISMATCH_OK {rank} {e}", flush=True)
        else:
            raise AssertionError("differing slot counts did not raise")
    print(f"ENGINE_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
