"""The sharded deployment's cell, ``edgar_dedup_sharded.clustered``, on the
CPU: four gloo ranks (``--rehearse-cpu 3000``) come out correct with the
tier's per-layer metrics read; a worker whose answer differs comes out not
correct through ``rank_mismatch``; a worker killed in a call ends the run
with an exception within its deadline.  The faulty workers
(``rank_faults.py``) replace ``lib/ranks.serve`` in a harness process of
their own."""

import json
import subprocess
import sys
import time

import pytest

from helpers import ROOT, last_json, run_subprocess

HERE = ROOT / "portbench" / "tests"
CELL = ["--workload", "edgar_dedup_sharded.clustered", "--seconds", "1",
        "--rehearse-cpu", "3000"]
HOST_METRICS = {"mh_encode_s", "mh_p1_s", "mh_comm_s", "mh_ring_bcast_s", "mh_ring_bytes",
                "mh_rescore_s", "mh_esc_s", "mh_esc_rows"}


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_rehearsed_on_four_gloo_ranks(trace):
    r = run_subprocess(CELL + ["--seed", str(2**31 + 11 + trace), "--trace", str(trace)])
    assert r.returncode == 0, r.stderr[-3000:]
    res = last_json(r.stdout)
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["rank_mismatch"] == {"value": 0, "limit": 0}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if trace:  # no card: the device's metrics find nothing to read
        want = {m["name"] for m in bench["per_layer"]
                if "edgar_dedup_sharded.clustered" in m["workloads"]}
        assert set(res["metrics"]) == want - {"mh_scan_roofline", "mh_device_idle"}
        assert set(res["metrics"]) == HOST_METRICS
        assert res["metrics"]["mh_comm_s"]["value"] > 0
        assert res["metrics"]["mh_ring_bytes"]["value"] > 0
    else:
        assert set(res["metrics"]) == {"setup_s", "call_s"}


def _with_fault(fault: str, seed: int, timeout: float):
    """The harness on the cell in a process of its own, its workers
    ``rank_faults.<fault>``, every wait of the ranks bounded by 30 s."""
    code = "\n".join([
        "import sys",
        f"sys.path[:0] = [{str(ROOT)!r}, {str(HERE)!r}, {str(ROOT / 'portbench')!r}]",
        "from portbench.lib import ranks",
        "import rank_faults",
        f"ranks.serve = rank_faults.{fault}",
        "ranks.TIMEOUT_S = 30.0",
        "import run",
        f"sys.exit(run.main({CELL + ['--seed', str(seed), '--trace', '0']!r}))",
    ])
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=timeout)
    return r, time.monotonic() - t0


def test_a_worker_answering_otherwise_is_not_correct():
    r, _ = _with_fault("altered_frame", 3000000011, 300)
    assert r.returncode == 0, r.stderr[-3000:]
    res = last_json(r.stdout)
    assert res["correct"] is False
    checks = res["checks"]
    assert checks["rank_mismatch"]["value"] >= 2  # the window's calls and the check call
    assert all(c["value"] <= c["limit"] for name, c in checks.items()
               if name != "rank_mismatch")


def test_a_worker_killed_in_a_call_ends_the_run():
    r, took = _with_fault("killed_in_second_call", 3000000013, 240)
    assert r.returncode != 0
    assert last_json(r.stdout) is None
    assert "RanksLost" in r.stderr and "rank 2" in r.stderr, r.stderr[-3000:]
    assert took < 120
