"""The sharded multi-process tier against the benchmark's plain reference.

Four gloo ranks on the CPU (tests/torch_mh_reference_worker.py, OS
processes joined at tcp://127.0.0.1:<free port>) self-join 3,000 seeded
clustered names with ``multihost="sharded"``.  Every rank's frame must be
the same, and ``portbench/reference/selfjoin.py`` (NumPy and PyTorch,
nothing of the program) judges it in full: the similarities within 1e-10
of the exact cosines, every pair the reference's top n keeps and none it
leaves out, and the frame's own checks.  The tier's new counters are held
against arithmetic: the world, the replication's buffers, and ring bytes
only where a rank needed a shard it does not own.  Imports no JAX.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from portbench.lib.ranks import digest  # noqa: E402
from portbench.reference import selfjoin, tfidf  # noqa: E402

import torch_mh_reference_worker as W  # noqa: E402

WORLD = 4
HASH_DIM = 512
LIMIT_S = 240
SEM = json.loads((ROOT / "portbench/configs/edgar_dedup_sharded.json").read_text())["semantics"]
EPS = 1e-10


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _run_ranks(case: str, out_dir: Path) -> list:
    """The four ranks of ``case`` to their end (each within ``LIMIT_S``);
    returns each rank's (frame, record)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_mh_reference_worker.py"),
                               str(r), str(WORLD), port, str(out_dir), case],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LIMIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"REF_OK {r}" in out, f"rank {r}:\n{out[-3000:]}"
    return [(pd.read_pickle(out_dir / f"{case}_{r}.pkl"),
             json.loads((out_dir / f"{case}_{r}.json").read_text()))
            for r in range(WORLD)]


@pytest.mark.parametrize("case", ["clustered", "local"])
def test_sharded_tier_against_the_reference(tmp_path, case):
    ranks = _run_ranks(case, tmp_path)
    frame = ranks[0][0]
    assert len({digest(f) for f, _ in ranks}) == 1

    names = np.array(W.corpus(case, WORLD), dtype=object)
    n = len(names)
    corpus = tfidf.build({"master": names}, SEM)
    rows = (frame["left_index"].to_numpy(np.int64), frame["right_index"].to_numpy(np.int64),
            frame["similarity"].to_numpy(np.float64))
    got = selfjoin.judge(corpus, [{"order": np.arange(n), "sample": np.arange(n),
                                   "rows": rows}], SEM, EPS, "cpu")
    assert got["rows_checked"] == n and got["pairs_checked"] > n
    assert got["sim_gap"] <= EPS and got["wrong_pairs"] == 0
    assert selfjoin.frame_errors(frame, names, SEM, EPS) == 0

    per = -(-n // WORLD)
    crossing = int((rows[0] // per != rows[1] // per).sum())
    for _, rec in ranks:
        t = rec["timings"]
        assert t["match.mh_world"] == WORLD and t["match.mh_slots"] == 1
        # one all-gather of the left hash: each rank's send buffer (the
        # widest shard's rows) and the receive buffer of every rank's
        assert t["match.mh_replicate_bytes"] == (1 + WORLD) * per * HASH_DIM * 2
        assert t["match.mh_exchange_bytes"] > 0 and t["match.mh_exchange_bytes"] % 4 == 0
        assert set(rec["route_calls"]) == {"direct replicate", "direct exchange"}
        if case == "clustered":
            assert crossing > 0
            assert t["match.mh_ring_bytes"] > 0
        else:  # no rank needs a shard it does not own: no broadcast
            assert crossing == 0
            assert t["match.mh_ring_bytes"] == 0 and t["match.mh_ring_bcast_s"] == 0
