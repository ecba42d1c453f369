"""The port's matcher against the JAX package's, on the CPU.

* The torch-op tile body ``_ub_topk_scan`` at k_tile 4, 8, 32, 64 and the
  thresholdless shape: every output EQUAL to JAX's on dyadic inputs (exact
  sums, so the only freedom left is tie order, which both fix the same way).
* The download epilogue: compaction and 20-bit packing round-trip.
* ``topn_cosine_matches``: ``MatchPairs`` (rows, cols, sims) BITWISE equal
  to JAX's on one encoded corpus fed to both (``ell_from_numpy``), on the
  corpora of test_matcher.py and test_dedup_collapse.py and on a skewed
  corpus that forces escalation.
* ``match_strings(..., device="cpu")`` frame-equal to
  ``string_grouper_tpu.match_strings`` at defaults and at non-default
  settings.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import string_grouper_tpu as sgj
import string_grouper_tpu_torch as sgt
from string_grouper_tpu.config import StringGrouperConfig as JConfig
from string_grouper_tpu.corpus.tfidf import TfidfEncoder as JEncoder
from string_grouper_tpu.ops import matcher as JM
from string_grouper_tpu_torch.corpus.tfidf import ell_from_numpy
from string_grouper_tpu_torch.ops import matcher as TM

from test_dedup_collapse import _dup_corpus
from test_matcher import CORPORA as MATCHER_CORPORA
from test_matcher import random_names
from test_torch_kernels import dyadic_rows

CPU = torch.device("cpu")


# ------------------------------------------------------------ tile body
@pytest.mark.parametrize("k_tile,thr,cand_c", [
    (4, 0.6, 64),
    (8, 0.6, 16),  # 4 tiles x 8 > 16: top-C truncation
    (32, 0.5, 64),
    (64, 0.5, 64),
    (256, -np.inf, 1024),  # thresholdless: every column extracted
])
def test_ub_topk_scan_equals_jax(k_tile, thr, cand_c):
    a, b = dyadic_rows(128, 1024, 128, seed=7)
    tile = 256
    j_out = JM._ub_topk_scan(
        jnp.asarray(a, jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16).reshape(-1, tile, 128),
        jnp.float32(thr), cand_c, k_tile,
    )
    t_out = TM._ub_topk_scan(
        torch.from_numpy(a).to(torch.bfloat16),
        torch.from_numpy(b).to(torch.bfloat16).reshape(-1, tile, 128),
        np.float32(thr), cand_c, k_tile,
    )
    names = ("w_vals", "w_cols", "counts", "tmax", "bound")
    for name, j, t in zip(names, j_out, t_out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    if np.isfinite(thr):
        assert (np.asarray(j_out[3]) > 2).any()


def test_compact_and_pack20_round_trip():
    rng = np.random.default_rng(0)
    r, c, budget = 64, 16, 1024
    n_valid = rng.integers(0, c + 1, size=r)
    cols = np.full((r, c), -1, np.int32)
    for i, k in enumerate(n_valid):
        cols[i, :k] = rng.integers(0, 1 << 20, size=k)
    j_flat, j_n = JM._compact_cols(jnp.asarray(cols), budget)
    t_flat, t_n = TM._compact_cols(torch.from_numpy(cols), budget)
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    np.testing.assert_array_equal(t_flat.numpy(), np.asarray(j_flat))
    packed = TM._pack20(t_flat).numpy().view(np.uint32)
    np.testing.assert_array_equal(packed, np.asarray(JM._pack20(j_flat)))
    total = int(n_valid.sum())
    np.testing.assert_array_equal(
        TM._unpack20(packed, total), cols[cols >= 0].astype(np.int64)
    )
    # overflow: the counts survive, the stream is cut at the budget
    t_flat2, t_n2 = TM._compact_cols(torch.from_numpy(cols), 64)
    j_flat2, _ = JM._compact_cols(jnp.asarray(cols), 64)
    np.testing.assert_array_equal(t_n2.numpy(), n_valid)
    np.testing.assert_array_equal(t_flat2.numpy(), np.asarray(j_flat2))


# ------------------------------------------------------------ full matcher
def _carry(ell):
    src = ell.device_src
    return ell_from_numpy(
        ell.ids, ell.vals64, ell.n_terms,
        table_id=src.table_id, idf32=src.idf32, inv_norm=src.inv_norm,
        flat_codes=src.flat_codes, coff=src.coff, base=src.base,
        ngram=src.ngram, row_hash=src.row_hash,
    )


def _assert_pairs_equal(t, j):
    np.testing.assert_array_equal(t.rows, j.rows)
    np.testing.assert_array_equal(t.cols, j.cols)
    np.testing.assert_array_equal(t.sims, j.sims)  # bitwise: exact rescore
    assert t.true_max_n_matches == j.true_max_n_matches


def _skewed_names(n, seed=0):
    """Near-identical clusters of ~60 members: qualified counts far above
    the initial candidate width, so rows escalate."""
    rng = np.random.default_rng(seed)
    out = random_names(n, seed=seed)
    for k in range(3):
        for p in rng.choice(n, size=60, replace=False):
            out[p] = f"megacluster {k} holdings corp" + " " * int(rng.integers(0, 2))
    return out


MATCH_CORPORA = {
    "customers": MATCHER_CORPORA["customers"],
    "random": random_names(300, seed=1),
    "dups": _dup_corpus(np.random.default_rng(3)),
    "skewed": _skewed_names(600, seed=2),
}


@pytest.mark.parametrize("min_similarity,max_n", [(0.8, 20), (0.5, 3), (0.1, 50)])
@pytest.mark.parametrize("name", sorted(MATCH_CORPORA))
def test_topn_cosine_matches_bitwise_equal(name, min_similarity, max_n):
    ell = JEncoder(JConfig()).fit_transform(MATCH_CORPORA[name])
    j = JM.topn_cosine_matches(ell, None, min_similarity, max_n,
                               left_chunk=256, right_tile=256)
    t = TM.topn_cosine_matches(_carry(ell), None, min_similarity, max_n,
                               left_chunk=256, right_tile=256, device=CPU)
    _assert_pairs_equal(t, j)
    if name == "skewed" and min_similarity == 0.8:
        assert t.stats["rounds"] >= 1  # escalation ran


def test_topn_cosine_matches_cross_join_equal():
    master = random_names(200, seed=4)
    dupes = random_names(150, seed=5) + master[:20]
    jm, jd = JEncoder(JConfig()).fit_transform_pair(master, dupes)
    j = JM.topn_cosine_matches(jm, jd, 0.6, 5)
    t = TM.topn_cosine_matches(_carry(jm), _carry(jd), 0.6, 5, device=CPU)
    _assert_pairs_equal(t, j)


# ------------------------------------------------------------ frames
FRAME_CORPUS = pd.Series(
    _skewed_names(400, seed=9) + MATCHER_CORPORA["customers"]
)


@pytest.mark.parametrize("kwargs", [
    {},
    {"min_similarity": 0.6, "max_n_matches": 5},
    {"min_similarity": 0.9, "max_n_matches": 50, "ignore_index": True},
])
def test_match_strings_frame_equal(kwargs):
    want = sgj.match_strings(FRAME_CORPUS, **kwargs)
    got = sgt.match_strings(FRAME_CORPUS, device="cpu", **kwargs)
    pd.testing.assert_frame_equal(got, want)


def test_match_strings_cross_join_with_ids_frame_equal():
    master = pd.Series(random_names(120, seed=6), name="company")
    dupes = pd.Series(random_names(80, seed=8) + list(master[:10]))
    mid = pd.Series([f"m{i}" for i in range(len(master))])
    did = pd.Series([f"d{i}" for i in range(len(dupes))])
    want = sgj.match_strings(master, dupes, mid, did, min_similarity=0.7)
    got = sgt.match_strings(master, dupes, mid, did, min_similarity=0.7,
                            device="cpu")
    pd.testing.assert_frame_equal(got, want)
