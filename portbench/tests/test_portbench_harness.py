"""The harness end to end on the CPU (``--rehearse-cpu``: the look for a
card skipped, the port's CPU path, lists cut short): the last line's keys,
the refusals, a cell added as files only, and what a run may import."""

import ast
import json
import shutil
import sys

import pytest
import torch

from helpers import ROOT, last_json, run_subprocess

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
FORBIDDEN = {"jax", "jaxlib", "flax", "string_grouper_tpu", "string_grouper",
             "string_grouper_utils"}


@pytest.mark.parametrize("workload,trace", [
    ("edgar_dedup.clustered", 0), ("edgar_dedup.clustered", 1),
    ("edgar_link.new100k", 0), ("edgar_link.new100k", 1)])
def test_last_line(workload, trace):
    r = run_subprocess(["--workload", workload, "--seed", str(2**31 + 3 * trace + 1),
                        "--seconds", "1", "--trace", str(trace), "--rehearse-cpu", "1200"])
    assert r.returncode == 0, r.stderr[-3000:]
    res = last_json(r.stdout)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer" if trace else "end_to_end"]}
    if trace:  # no card: the device's metrics find nothing to read
        want -= {"scan_roofline", "device_idle", "device_peak_gib"}
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    checks = [ln for ln in r.stderr.splitlines() if ln.strip()][-len(res["checks"]):]
    assert all(ln.startswith("portbench check ") for ln in checks)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    r = run_subprocess(["--workload", "edgar_dedup.clustered", "--seed", "1",
                        "--seconds", "1", "--trace", "0"])
    assert r.returncode != 0
    assert last_json(r.stdout) is None
    assert "needs 1 CUDA card" in r.stderr


@pytest.mark.parametrize("rehearse", [False, True])
def test_benchmark_files_alone_no_result(tmp_path, rehearse):
    """A directory with only BENCHMARK.json and portbench/: no program, no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    args = ["--workload", "edgar_dedup.clustered", "--seed", "1", "--seconds", "1",
            "--trace", "0"] + (["--rehearse-cpu", "500"] if rehearse else [])
    r = run_subprocess(args, root=tmp_path, cwd=tmp_path)
    assert r.returncode != 0
    assert last_json(r.stdout) is None


ZIPF_GENERATOR = """
import numpy as np

from portbench.lib import names


def generate(n, rng, *, base_share, two_stem_share, mutation_cuts, s):
    n_bases = max(1, int(n * base_share))
    base_names = names.bases(rng, n_bases, two_stem_share)
    w = np.arange(1, n_bases + 1, dtype=np.float64) ** -float(s)
    idx = rng.choice(n_bases, size=n, p=w / w.sum())
    return names.dress(rng, base_names, idx, mutation_cuts)
"""


def test_a_cell_added_as_files(tmp_path):
    """A configuration, a traffic mix of a new kind (its generator too) and
    a per-layer metric, each a new file, and entries in BENCHMARK.json: no
    file of portbench/ edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/edgar_dedup.json").read_text())
    cfg.update(name="edgar_dedup_small", sizes={"master": 900})
    (tmp_path / "portbench/configs/edgar_dedup_small.json").write_text(json.dumps(cfg))
    # a mix of a new kind: a generator file of its own (Zipf popularity of
    # the bases, from the lexicon's parts) and the data file naming it
    assert not (ROOT / "portbench/generators/zipf_names.py").exists()
    (tmp_path / "portbench/generators/zipf_names.py").write_text(ZIPF_GENERATOR)
    (tmp_path / "portbench/traffic/zipf.json").write_text(json.dumps({"lists": {"master": {
        "generator": "zipf_names", "corpus_seed": 42, "base_share": 0.55, "two_stem_share": 0.35,
        "mutation_cuts": [0.15, 0.25, 0.32], "s": 1.1}}}))
    (tmp_path / "portbench/metrics/calls_done.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    bench["configs"].append({"name": "edgar_dedup_small", "source": "test",
                             "file": "portbench/configs/edgar_dedup_small.json",
                             "reduced": ["sizes"], "why": "test"})
    bench["workloads"].append({"name": "edgar_dedup_small.zipf",
                               "config": "edgar_dedup_small", "traffic": "zipf",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "harness",
                               "moves": "call_s", "workloads": ["edgar_dedup_small.zipf"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_subprocess(["--workload", "edgar_dedup_small.zipf", "--seed", "77",
                        "--seconds", "1", "--trace", "1", "--rehearse-cpu", "100000"],
                       root=tmp_path, cwd=tmp_path, extra_path=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    res = last_json(r.stdout)
    assert res["correct"] is True
    assert res["metrics"]["calls_done"]["value"] >= 1
    # the new metric lists only the new cell: the old cells do not report it
    assert "calls_done" not in run_subprocess(
        ["--workload", "edgar_dedup.clustered", "--seed", "78", "--seconds", "1",
         "--trace", "1", "--rehearse-cpu", "600"],
        root=tmp_path, cwd=tmp_path, extra_path=ROOT).stdout.splitlines()[-1]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_forbidden_import_in_the_sources():
    files = [p for p in (ROOT / "portbench").rglob("*.py") if "tests" not in p.parts]
    assert (ROOT / "portbench/run.py") in files
    for p in files:
        for name in _imports(p):
            assert name.split(".")[0] not in FORBIDDEN, (p, name)
    for p in (ROOT / "portbench/reference").rglob("*.py"):
        for name in _imports(p):
            assert name.split(".")[0] != "string_grouper_tpu_torch", (p, name)


def test_forbidden_modules_are_found_by_whole_name(monkeypatch):
    sys.path.insert(0, str(ROOT / "portbench"))
    try:
        import run as harness
    finally:
        sys.path.remove(str(ROOT / "portbench"))
    clean = harness.forbidden_loaded()
    assert clean == [], clean  # string_grouper_tpu_torch is not string_grouper_tpu
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert harness.forbidden_loaded() == ["jaxlib"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["edgar_dedup.clustered", "edgar_link.new100k"])
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on one")
    r = run_subprocess(["--workload", workload, "--seed", "2718281829", "--seconds", "1",
                        "--trace", "0"], timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert last_json(r.stdout)["correct"] is True
