"""The port's multi-process tiers under real ``torch.distributed`` ranks.

Spawns 2 or 3 OS processes joined into one gloo group at
tcp://127.0.0.1:<free port> (the port's form of tests/test_multihost.py).
Each rank holds ONLY its shard of the corpus strings; every cross-rank byte
rides a gloo collective.  The workers (tests/torch_mh_worker.py,
tests/torch_mh_engine_worker.py) import only the port and assert equality
with the port's own single-process results; they write what they computed
to ``tmp_path``, and this test holds it against the JAX package's
single-process results on the same input:
  * the shard-local encode, bitwise (ids, values, IDF), at 3-grams and at
    ``ngram_size=9`` (byte keys);
  * the shard-local match of each rank's rows, wide and escalated, equal
    to JAX's matcher over the whole corpus;
  * every engine frame (self, cross with ids, groups, top-1, float32,
    sharded self and cross, a corpus smaller than the world, the sharded
    ladder, and the sharded self, cross and ladder over 2 cpu device slots
    per rank) equal to JAX's frame, exactly.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import string_grouper_tpu as sgj
from string_grouper_tpu.config import StringGrouperConfig as JConfig
from string_grouper_tpu.corpus import TfidfEncoder as JEncoder
from string_grouper_tpu.ops.matcher import _pad_width as j_pad_width
from string_grouper_tpu.ops.matcher import topn_cosine_matches as j_topn

import torch_mh_engine_worker as EW
import torch_mh_worker as SW

HERE = Path(__file__).resolve().parent
ENGINE_CASES = ("self", "cross", "groups", "top1", "f32", "sharded",
                "sharded_cross", "tiny", "ladder", "sharded_slots",
                "sharded_cross_slots", "ladder_slots")


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def run_ranks(worker: str, world: int, out_dir: Path, expect, env=None):
    """Run ``world`` ranks of ``worker`` to their end; each must exit 0 and
    print every marker of ``expect`` with its rank."""
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(HERE / worker), str(r), str(world), port,
             str(out_dir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        for marker in expect:
            assert f"{marker} {r}" in out, f"missing {marker}:\n{out[-3000:]}"
    return outs


# ------------------------------------------------------- shard-local pair
@pytest.mark.parametrize("ngram,n", [(3, 120), (9, 60)])
def test_two_rank_shard_pipeline_equals_jax(tmp_path, ngram, n):
    """Two ranks of ``multihost_encode_shard`` + ``multihost_match_shard``:
    each rank's encode block bitwise JAX's single-process fit rows, its
    pairs (wide, and escalated with cand_c0=2) JAX's matcher's for its
    rows.  9-grams over ASCII need 72 bits: the byte-key vocabulary path."""
    _shard_pipeline(tmp_path, ngram, n, 1)


def test_two_rank_shard_pipeline_two_slots_equals_jax(tmp_path):
    """The same with 2 cpu device slots per rank (``mesh=``): 4 devices,
    the JAX worker's 2 per process."""
    _shard_pipeline(tmp_path, 3, 120, 2)


def _shard_pipeline(tmp_path, ngram, n, slots):
    run_ranks("torch_mh_worker.py", 2, tmp_path,
              ("WORKER_ENCODE_OK", "WORKER_OK", "WORKER_ESC_OK"),
              env={"MH_NGRAM": str(ngram), "MH_N": str(n),
                   "MH_SLOTS": str(slots)})
    full = SW.corpus(n)
    cfg = JConfig(min_similarity=SW.MIN_SIM, ngram_size=ngram)
    enc = JEncoder(cfg)
    ell = enc.fit_transform(full).wait_ready()
    ref = j_topn(ell, None, SW.MIN_SIM, SW.MAX_N, force_symmetries=False,
                 hash_dim=128)
    for r in range(2):
        z = np.load(tmp_path / f"shard_{r}.npz")
        lo, hi = int(z["lo"]), int(z["hi"])
        np.testing.assert_array_equal(z["idf"], enc.idf_)
        w = max(z["ids"].shape[1], ell.width)
        jp = j_pad_width(ell, w)
        pad = w - z["ids"].shape[1]
        np.testing.assert_array_equal(
            np.pad(z["ids"], ((0, 0), (0, pad)), constant_values=-1),
            jp.ids[lo:hi])
        np.testing.assert_array_equal(
            np.pad(z["vals64"], ((0, 0), (0, pad))), jp.vals64[lo:hi])
        want = {(int(a), int(b)): s for a, b, s in
                zip(ref.rows, ref.cols, ref.sims) if lo <= a < hi}
        assert want
        for tag in ("", "_esc"):
            got = {(int(a), int(b)): s for a, b, s in
                   zip(z["rows" + tag], z["cols" + tag], z["sims" + tag])}
            assert got == want, tag


# ------------------------------------------------------------------ engine
def _jax_frames(n: int) -> dict:
    """JAX's single-process frames of the engine worker's cases."""
    series = EW.names(n, seed=5)
    dup = EW.names(n // 2, seed=6)
    ids = pd.Series([f"id{i}" for i in range(n)])
    dids = pd.Series([f"d{i}" for i in range(n // 2)])
    dup_heavy = pd.Series([f"cluster {i % 7} holdings corp" for i in range(90)]
                          + list(EW.names(30, seed=9)))
    self_df = sgj.match_strings(series, min_similarity=0.6)
    cross = sgj.match_strings(series, dup, ids, dids, min_similarity=0.5)
    frames = {
        "self": self_df,
        "cross": cross,
        "groups": sgj.group_similar_strings(series, ids, min_similarity=0.6),
        "top1": sgj.match_most_similar(series, dup, min_similarity=0.5),
        "f32": sgj.match_strings(series, min_similarity=0.5,
                                 tfidf_matrix_dtype=np.float32),
        "sharded": self_df,
        "sharded_cross": cross,
        "tiny": sgj.match_strings(pd.Series(["acme corp", "acme corp."]),
                                  min_similarity=0.5),
        "ladder": sgj.match_strings(dup_heavy, min_similarity=0.5),
    }
    frames.update(sharded_slots=frames["self"],
                  sharded_cross_slots=frames["cross"],
                  ladder_slots=frames["ladder"])
    return frames


@pytest.mark.parametrize("world,n", [(2, 240), (3, 150)])
def test_ranks_engine_frames_equal_jax(tmp_path, world, n):
    """The engine under 2 and 3 gloo ranks (auto-selected replicated tier,
    forced sharded tier, the sharded tier over 2 cpu slots per rank, and
    slot counts that differ between ranks, which must raise on every rank;
    150 rows over 3 ranks gives uneven shards): every
    rank's frame equals the port's single-process frame (asserted in the
    worker) and JAX's single-process frame, exactly."""
    run_ranks("torch_mh_engine_worker.py", world, tmp_path,
              tuple(f"ENGINE_{c.upper()}_OK" for c in ENGINE_CASES)
              + ("ENGINE_SLOTS_MISMATCH_OK", "ENGINE_OK"),
              env={"MH_ENGINE_N": str(n)})
    want = _jax_frames(n)
    for case in ENGINE_CASES:
        for r in range(world):
            got = pd.read_pickle(tmp_path / f"{case}_{r}.pkl")
            if isinstance(want[case], pd.DataFrame):
                pd.testing.assert_frame_equal(got, want[case],
                                              check_exact=True)
            else:
                pd.testing.assert_series_equal(got, want[case],
                                               check_exact=True)
