"""The port's multi-process tiers under ONE process, against the JAX
package's (the port's form of tests/test_multihost_tier.py, case for case).

Without a ``torch.distributed`` group the rank is 0, the world 1 and every
collective is the identity, so ``multihost=True`` / ``"sharded"`` run the
tiers' whole code path (shard-local encode, gathers, per-rank matching or
the sharded scan + ring + ladder, result gather, global fix-ups).  Each
port frame (``device="cpu"``) must equal the JAX package's frame for the
same call exactly; the shard encode must equal JAX's bitwise (float64,
float32, byte keys), payload included.  The real multi-process form is
tests/test_torch_multihost.py.
"""

import numpy as np
import pandas as pd
import pytest

import string_grouper_tpu as sgj
import string_grouper_tpu_torch as sgt
from string_grouper_tpu import parallel as JP
from string_grouper_tpu.config import StringGrouperConfig as JConfig
from string_grouper_tpu.parallel import multihost as JM
from string_grouper_tpu_torch import StringGrouper
from string_grouper_tpu_torch import parallel as TP
from string_grouper_tpu_torch.config import StringGrouperConfig as TConfig
from string_grouper_tpu_torch.corpus.preprocess import clean_corpus
from string_grouper_tpu_torch.parallel import multihost as TM

from test_multihost_tier import _names
from test_torch_api import assert_same


def both(fn, *args, **kwargs):
    """(port, JAX) results of the API function ``fn`` on the same call."""
    want = getattr(sgj, fn)(*args, **kwargs)
    got = getattr(sgt, fn)(*args, device="cpu", **kwargs)
    return got, want


def same(fn, *args, **kwargs):
    got, want = both(fn, *args, **kwargs)
    assert_same(got, want)
    return got


def _fuzz(seed, name_seed, dupe_seed, multihost):
    """tests/test_multihost_tier.py's randomized trials, port vs JAX."""
    rng = np.random.default_rng(seed)
    for trial in range(5):
        n = int(rng.integers(30, 220))
        s = _names(n, seed=name_seed + trial)
        kw = dict(
            min_similarity=float(rng.choice([0.0, 0.3, 0.6, 0.85])),
            max_n_matches=int(rng.integers(1, 12)),
        )
        if rng.random() < 0.3:
            kw["tfidf_matrix_dtype"] = np.float32
        if rng.random() < 0.5:
            d = _names(int(rng.integers(20, 150)), seed=dupe_seed + trial)
            same("match_strings", s, d, **kw, multihost=multihost)
        else:
            same("match_strings", s, **kw, multihost=multihost)


def _edge_cases(multihost):
    for s in (pd.Series(["solo"]), pd.Series(["a b c", "a b c", "xyz"])):
        same("match_strings", s, min_similarity=0.1, multihost=multihost)
    s = _names(60, seed=13 if multihost is True else 29)
    same("match_strings", s, min_similarity=0.5, force_symmetries=False,
         multihost=multihost)
    same("match_strings", s, min_similarity=0.7, max_n_matches=None,
         multihost=multihost)


class TestMultihostTier:
    def test_self_join_equals_jax(self):
        got = same("match_strings", _names(250, seed=1), min_similarity=0.6,
                   multihost=True)
        assert_same(got, sgt.match_strings(_names(250, seed=1),
                                           min_similarity=0.6, device="cpu"))

    def test_cross_join_with_ids_equals_jax(self):
        s, d = _names(200, seed=2), _names(150, seed=3)
        ids = pd.Series([f"id{i}" for i in range(200)])
        dids = pd.Series([f"d{i}" for i in range(150)])
        same("match_strings", s, d, ids, dids, min_similarity=0.5,
             multihost=True)

    def test_groups_equal_jax(self):
        same("group_similar_strings", _names(220, seed=4),
             pd.Series(range(220)), min_similarity=0.6, multihost=True)

    def test_most_similar_equals_jax(self):
        s, d = _names(180, seed=5), _names(120, seed=6)
        same("match_most_similar", s, d, min_similarity=0.5, multihost=True)
        same("match_most_similar", s, d, min_similarity=0.5,
             ignore_index=True, multihost=True)

    def test_float32_equals_jax(self):
        same("match_strings", _names(160, seed=7), min_similarity=0.6,
             tfidf_matrix_dtype=np.float32, multihost=True)

    def test_include_zeroes_and_edits(self):
        s = _names(60, seed=8)
        same("match_strings", s, min_similarity=0, max_n_matches=60,
             include_zeroes=True, multihost=True)
        sg_t = StringGrouper(s, min_similarity=0.6, multihost=True,
                             device="cpu").fit()
        sg_j = sgj.StringGrouper(s, min_similarity=0.6, multihost=True).fit()
        sg_t.add_match(s.iloc[0], s.iloc[1])
        sg_j.add_match(s.iloc[0], s.iloc[1])
        assert_same(sg_t.get_matches(), sg_j.get_matches())

    def test_unicode_corpus(self):
        """Non-ASCII input takes the payload-less route on every rank."""
        s = _names(120, seed=9)
        table = str.maketrans({"a": "á", "e": "é"})
        s = pd.Series([x.translate(table) if i % 3 == 0 else x
                       for i, x in enumerate(s)])
        same("match_strings", s, min_similarity=0.5, multihost=True)

    def test_payload_attached_and_collapse_active(self):
        """The shard encode carries the byte payload with row hashes on the
        ASCII / float64 route, bitwise JAX's, and the gathered full ELL
        keeps it; equal strings collide on (hash, length)."""
        s = _names(80, seed=10)
        ell, idf, n_docs = TM.multihost_encode_shard(
            list(s), TConfig(min_similarity=0.6))
        j_ell, j_idf, _ = JM.multihost_encode_shard(
            list(s), JConfig(min_similarity=0.6))
        assert n_docs == 80
        np.testing.assert_array_equal(idf, j_idf)
        _assert_payload_equal(ell.device_src, j_ell.device_src)
        full = TM._allgather_full_ell(ell)
        np.testing.assert_array_equal(full.ids, ell.wait_ready().ids)
        _assert_payload_equal(full.device_src, ell.device_src)
        ell2, _, _ = TM.multihost_encode_shard(
            ["acme holdings", "acme holdings", "apex systems"],
            TConfig(min_similarity=0.6))
        h = ell2.device_src.row_hash
        assert h[0] == h[1] and h[0] != h[2]

    def test_mesh_composes_with_multihost(self):
        """multihost + a mesh: each rank's matcher runs sharded over its
        mesh (a (2, 2) cpu mesh here, JAX's over 4 virtual devices)."""
        s = _names(150, seed=12)
        got = sgt.match_strings(s, min_similarity=0.6, multihost=True,
                                mesh=TP.make_mesh(4, dp=2, device="cpu"),
                                device="cpu")
        want = sgj.match_strings(s, min_similarity=0.6, multihost=True,
                                 mesh=JP.make_mesh(4, dp=2))
        assert_same(got, want)

    def test_randomized_fuzz_equals_jax(self):
        _fuzz(99, 1000, 2000, True)

    def test_edge_cases(self):
        _edge_cases(True)

    def test_replicated_capacity_guard(self, monkeypatch):
        """The replicated tier refuses a corpus past the host budget and
        names the sharded tier, which stays available."""
        s = _names(200, seed=31)
        monkeypatch.setenv("SG_TPU_MH_HOST_BUDGET_GB", "0.0000001")
        with pytest.raises(MemoryError, match="sharded"):
            sgt.match_strings(s, min_similarity=0.6, multihost=True,
                              device="cpu")
        got = same("match_strings", s, min_similarity=0.6,
                   multihost="sharded")
        monkeypatch.delenv("SG_TPU_MH_HOST_BUDGET_GB")
        assert_same(got, sgj.match_strings(s, min_similarity=0.6))

    def test_pairwise_takes_multihost(self):
        """``compute_pairwise_similarities`` accepts the option (its dot
        never matches, in either package)."""
        s, d = _names(40, seed=44), _names(40, seed=45)
        got = same("compute_pairwise_similarities", s, d, multihost=True)
        assert_same(got, sgt.compute_pairwise_similarities(s, d, device="cpu"))

    def test_invalid_multihost_value(self):
        with pytest.raises(Exception, match="multihost"):
            sgt.match_strings(_names(10), multihost="bogus", device="cpu")

    def test_explicit_false_overrides(self):
        s = _names(50, seed=11)
        sg = StringGrouper(s, min_similarity=0.6, multihost=False,
                           device="cpu").fit()
        assert "match.mh_match_s" not in sg.timings.seconds
        sg2 = StringGrouper(s, min_similarity=0.6, multihost=True,
                            device="cpu").fit()
        assert "match.mh_match_s" in sg2.timings.seconds
        assert_same(sg.get_matches(), sg2.get_matches())
        assert_same(sg2.get_matches(), sgj.StringGrouper(
            s, min_similarity=0.6, multihost=True).fit().get_matches())


class TestShardedTier:
    """``multihost="sharded"`` under one process: no full-corpus ELL; the
    scan of every left row against the rank's right block, the exact ring
    rescore and the escalation ladder."""

    def test_self_join_equals_jax(self):
        same("match_strings", _names(250, seed=21), min_similarity=0.6,
             multihost="sharded")

    def test_cross_join_with_ids_equals_jax(self):
        s, d = _names(200, seed=22), _names(150, seed=23)
        ids = pd.Series([f"id{i}" for i in range(200)])
        dids = pd.Series([f"d{i}" for i in range(150)])
        same("match_strings", s, d, ids, dids, min_similarity=0.5,
             multihost="sharded")

    def test_groups_and_top1_equal_jax(self):
        s = _names(220, seed=24)
        same("group_similar_strings", s, min_similarity=0.6,
             multihost="sharded")
        same("match_most_similar", s, _names(120, seed=25),
             min_similarity=0.5, multihost="sharded")

    def test_float32_equals_jax(self):
        same("match_strings", _names(160, seed=26), min_similarity=0.6,
             tfidf_matrix_dtype=np.float32, multihost="sharded")

    def test_replicated_below_threshold_sharded_above(self, monkeypatch):
        """True/auto keeps the replicated tier for small corpora; the
        sharded tier engages at SG_TPU_MH_SHARDED_ROWS."""
        s = _names(60, seed=27)
        sg = StringGrouper(s, min_similarity=0.6, multihost=True,
                           device="cpu").fit()
        assert sg.timings.labels.get("multihost_tier") == "replicated"
        monkeypatch.setenv("SG_TPU_MH_SHARDED_ROWS", "10")
        sg2 = StringGrouper(s, min_similarity=0.6, multihost=True,
                            device="cpu").fit()
        assert sg2.timings.labels.get("multihost_tier") == "sharded"
        assert_same(sg.get_matches(), sg2.get_matches())

    def test_no_full_ell_stage_and_mem_accounting(self):
        s = _names(150, seed=28)
        sg = StringGrouper(s, min_similarity=0.6, multihost="sharded",
                           device="cpu").fit()
        keys = sg.timings.seconds
        assert "match.mh_ell_allgather_s" not in keys
        assert keys["match.mh_mem_local_ell_bytes"] > 0
        assert keys["match.mh_mem_replicated_ell_bytes"] >= keys[
            "match.mh_mem_local_ell_bytes"]
        assert keys["match.mh_mem_peak_visit_bytes"] == 0  # no remote shard
        assert_same(sg.get_matches(),
                    sgj.match_strings(s, min_similarity=0.6,
                                      multihost="sharded"))

    def test_randomized_fuzz_equals_jax(self):
        _fuzz(77, 3000, 4000, "sharded")

    def test_edge_cases(self):
        _edge_cases("sharded")


# -------------------------------------------------------------------- units
def _assert_payload_equal(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    for f in ("flat_codes", "coff", "inv_norm", "table_id", "idf32",
              "row_hash"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.base, got.ngram) == (want.base, want.ngram)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(tfidf_matrix_dtype=np.float32),
    dict(ngram_size=9),
], ids=["float64", "float32", "byte-keys"])
def test_encode_shard_bitwise_jax(kw):
    """ids, vals64, idf, n_docs and every payload field, bitwise."""
    strings = list(_names(140, seed=41)) + ["", "Café Müller", "a"]
    ell, idf, n = TM.multihost_encode_shard(strings, TConfig(**kw))
    j_ell, j_idf, j_n = JM.multihost_encode_shard(strings, JConfig(**kw))
    assert n == j_n == len(strings)
    np.testing.assert_array_equal(idf, j_idf)
    assert ell.n_terms == j_ell.n_terms
    np.testing.assert_array_equal(ell.ids, j_ell.wait_ready().ids)
    np.testing.assert_array_equal(ell.vals64, j_ell.vals64)
    _assert_payload_equal(ell.device_src, j_ell.device_src)
    assert (ell.device_src is None) == (kw != {})


def test_poly_row_hash_bitwise_jax():
    strings = list(_names(50, seed=42)) + ["", "x", "", "zz top"]
    corpus = clean_corpus(strings, TConfig())
    off = corpus.offsets.astype(np.int64)
    got = TM._poly_row_hash(corpus.buf, off)
    want = JM._poly_row_hash(corpus.buf, off)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 40


@pytest.mark.parametrize("n,nproc", [(0, 1), (1, 3), (2, 3), (10, 3),
                                     (240, 2), (150, 3), (7, 8)])
def test_shard_bounds_equal_jax(n, nproc):
    for pid in range(nproc):
        assert TM._shard_bounds(n, nproc, pid) == JM._shard_bounds(
            n, nproc, pid)
    counts = TM._shard_counts(n, nproc)
    assert counts.sum() == n and (counts >= 0).all()


def test_gather_pair_list_round_trip():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 1 << 30, 37)
    cols = rng.integers(0, 1 << 30, 37)
    sims = rng.random(37)
    r, c, s = TM._gather_pair_list(rows, cols, sims)
    assert r.dtype == c.dtype == np.int64 and s.dtype == np.float64
    np.testing.assert_array_equal(r, rows)
    np.testing.assert_array_equal(c, cols)
    np.testing.assert_array_equal(s, sims)
    r, c, s = TM._gather_pair_list(*(np.zeros(0),) * 3)
    assert len(r) == len(c) == len(s) == 0


def test_allgather_host_exact_bytes():
    keys = np.array([0, 1, (1 << 63) + 12345, (1 << 64) - 1], np.uint64)
    vals = np.array([np.pi, 1e-300, -0.0, 1.0000000000000002])
    for x in (keys, vals):
        g = TM._allgather_host(x)
        assert g.shape == (1,) + x.shape and g.dtype == x.dtype
        np.testing.assert_array_equal(g[0].view(np.uint8), x.view(np.uint8))
    assert TM._world() == (0, 1)
    np.testing.assert_array_equal(TM._broadcast_host_from(keys, 0), keys)
    parts = TM._allgather_ragged(vals[:3])
    assert len(parts) == 1
    np.testing.assert_array_equal(parts[0], vals[:3])


def test_timings_labels_name_the_tier():
    """``labels["multihost_tier"]`` after a multihost fit; empty (reset)
    after a plain one, on the same grouper."""
    s = _names(40, seed=43)
    sg = StringGrouper(s, min_similarity=0.6, device="cpu").fit()
    assert sg.timings.labels == {}
    for tier in ("replicated", "sharded"):
        sg.update_options(multihost=tier)
        sg.fit()
        assert sg.timings.labels == {"multihost_tier": tier}
    sg.update_options(multihost=False)
    sg.fit()
    assert sg.timings.labels == {}
