"""Several devices per rank in the port's sharded multi-process tiers,
against the JAX package.

In one process (world 1) the JAX tiers shard over conftest's 8 virtual CPU
devices.  The port takes ``mesh=`` beside ``multihost="sharded"`` as the
rank's device slots, so an 8-slot ``cpu`` mesh gives it JAX's geometry
(``n_dev = 8``): the frames must equal JAX's exactly, the escalation
counters (``match.mh_esc_rows``, ``match.mh_esc_s{i}_kt{k}_rows``) must
equal JAX's, and the shard-local pair's ``(rows, cols, sims)`` must be
bitwise JAX's.  At 1, 2 and 4 slots the geometry differs from JAX's and
only the frames are compared.  The scan itself (``_phase1_scan``) is held
against JAX's ``_make_phase1_scan`` on a k-device mesh.  Two gloo ranks
with 2 slots each are tests/test_torch_multihost.py's.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.sharding import Mesh as JMesh

import string_grouper_tpu as sgj
from string_grouper_tpu.config import StringGrouperConfig as JConfig
from string_grouper_tpu.ops.matcher import build_hash_matrix as j_hash
from string_grouper_tpu.parallel import multihost as JM
from string_grouper_tpu_torch import StringGrouper
from string_grouper_tpu_torch import parallel as TP
from string_grouper_tpu_torch.config import StringGrouperConfig as TConfig
from string_grouper_tpu_torch.parallel import Mesh
from string_grouper_tpu_torch.parallel import multihost as TM

from test_multihost_tier import _names
from test_torch_api import assert_same

N_DEV = 8  # conftest's virtual CPU devices: JAX's device count here
_COUNTER = re.compile(r"match\.mh_esc_(rows|s\d+_kt\d+_rows)")


def _slots(k, dp=1):
    return TP.make_mesh(k, dp=dp, device="cpu")


def _counters(sg):
    return {k: v for k, v in sg.timings.seconds.items() if _COUNTER.fullmatch(k)}


def _sharded(args, mesh, **kw):
    """(port, JAX) groupers of the same sharded fit; frames equal."""
    sg_t = StringGrouper(*args, multihost="sharded", mesh=mesh, device="cpu",
                         **kw).fit()
    sg_j = sgj.StringGrouper(*args, multihost="sharded", **kw).fit()
    assert sg_t.timings.labels["multihost_tier"] == "sharded"
    assert_same(sg_t.get_matches(), sg_j.get_matches())
    return sg_t, sg_j


def _ladder_corpus():
    """tests/mh_engine_worker.py's tie-heavy corpus: clusters of identical
    strings overflow the kt=2 extraction, so rows climb the ladder."""
    return pd.Series([f"cluster {i % 7} holdings corp" for i in range(90)]
                     + list(_names(30, seed=9)))


CASES = {
    "self": lambda: ((_names(250, seed=21),), dict(min_similarity=0.6)),
    "cross_ids": lambda: (
        (_names(200, seed=22), _names(150, seed=23),
         pd.Series([f"id{i}" for i in range(200)]),
         pd.Series([f"d{i}" for i in range(150)])),
        dict(min_similarity=0.5)),
    "float32": lambda: ((_names(160, seed=26),),
                        dict(min_similarity=0.6,
                             tfidf_matrix_dtype=np.float32)),
    "ladder": lambda: ((_ladder_corpus(),), dict(min_similarity=0.5)),
    "max_n_none": lambda: ((_names(120, seed=27),),
                           dict(min_similarity=0.7, max_n_matches=None)),
}


# -------------------------------------------- 8 slots: JAX's geometry
@pytest.mark.parametrize("shape", [(1, 8), (2, 4)], ids=["1x8", "2x4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_eight_slots_frames_and_counters_equal_jax(case, shape):
    """8 slots (a (1, 8) or (2, 4) mesh, flattened row-major): JAX's frame
    and JAX's escalation counters, stage by stage."""
    args, kw = CASES[case]()
    sg_t, sg_j = _sharded(args, _slots(N_DEV, dp=shape[0]), **kw)
    got, want = _counters(sg_t), _counters(sg_j)
    assert "match.mh_esc_rows" in want
    assert got == want


def test_eight_slots_counters_differ_from_one_slot():
    """The counters depend on the device count (what makes the 8-slot
    comparison a check): one slot escalates the ladder corpus over two
    rungs, 8 slots (and JAX) over one."""
    args, kw = CASES["ladder"]()
    one, _ = _sharded(args, None, **kw)
    eight, jax_sg = _sharded(args, _slots(N_DEV), **kw)
    assert _counters(one) != _counters(jax_sg)
    assert _counters(eight) == _counters(jax_sg)


@pytest.mark.parametrize("fn,kw", [
    ("group_similar_strings", dict(min_similarity=0.6)),
    ("match_most_similar", dict(min_similarity=0.5)),
])
def test_eight_slots_other_entry_points_equal_jax(fn, kw):
    import string_grouper_tpu_torch as sgt

    s = _names(220, seed=24)
    args = (s,) if fn == "group_similar_strings" else (s, _names(120, seed=25))
    got = getattr(sgt, fn)(*args, multihost="sharded", mesh=_slots(N_DEV),
                           device="cpu", **kw)
    assert_same(got, getattr(sgj, fn)(*args, multihost="sharded", **kw))


# ------------------------------------------------ 1, 2 and 4 slots
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("case", ["self", "cross_ids", "float32", "ladder"])
def test_fewer_slots_frames_equal_jax(case, k):
    args, kw = CASES[case]()
    _sharded(args, _slots(k), **kw)


def test_slots_may_repeat_and_mix_shapes():
    """A (2, 2) mesh is 4 slots: the (1, 4) mesh's frame and counters."""
    args, kw = CASES["ladder"]()
    a, _ = _sharded(args, _slots(4, dp=2), **kw)
    b, _ = _sharded(args, _slots(4), **kw)
    assert _counters(a) == _counters(b)


# ------------------------------------------------- the shard-local pair
@pytest.mark.parametrize("ngram,n,cand_c0", [
    (3, 120, None), (3, 120, 2), (9, 60, None),
], ids=["wide", "escalated", "byte-keys"])
def test_match_shard_eight_slots_bitwise_jax(monkeypatch, ngram, n, cand_c0):
    """``multihost_match_shard(mesh=8 slots)``: (rows, cols, sims) bitwise
    JAX's over its 8 devices; ``cand_c0=2`` forces the union re-match, and
    9-grams over ASCII take the byte-key vocabulary."""
    strings = list(_names(n, seed=5))
    ell, _, _ = TM.multihost_encode_shard(
        strings, TConfig(min_similarity=0.5, ngram_size=ngram))
    j_ell, _, _ = JM.multihost_encode_shard(
        strings, JConfig(min_similarity=0.5, ngram_size=ngram))
    scans = []
    real = TM._phase1_scan
    monkeypatch.setattr(TM, "_phase1_scan",
                        lambda *a, **k: scans.append(k) or real(*a, **k))
    got = TM.multihost_match_shard(
        ell, 0, n, 0.5, 5, hash_dim=128, tile=8, cand_c0=cand_c0,
        device="cpu", mesh=_slots(N_DEV))
    want = JM.multihost_match_shard(
        j_ell, 0, n, 0.5, 5, hash_dim=128, tile=8, cand_c0=cand_c0)
    assert len(got[0]) > n
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(scans) == (2 if cand_c0 else 1)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_match_shard_fewer_slots_equal_jax_pairs(k):
    strings = list(_names(120, seed=6))
    ell, _, _ = TM.multihost_encode_shard(strings, TConfig(min_similarity=0.5))
    j_ell, _, _ = JM.multihost_encode_shard(strings, JConfig(min_similarity=0.5))
    got = TM.multihost_match_shard(ell, 0, 120, 0.5, 5, hash_dim=128, tile=8,
                                   cand_c0=2, device="cpu", mesh=_slots(k))
    want = JM.multihost_match_shard(j_ell, 0, 120, 0.5, 5, hash_dim=128,
                                    tile=8, cand_c0=2)
    as_set = lambda p: {(int(r), int(c)): s for r, c, s in zip(*p)}
    assert as_set(got) == as_set(want)


# ----------------------------------------------------------- the scan
def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("k,k_tile", [(1, 2), (2, 2), (4, 8), (8, 2), (8, 16)])
def test_phase1_scan_equals_jax_scan(k, k_tile):
    """One rank's ``_phase1_scan`` over k slots: JAX's ``_make_phase1_scan``
    over a (1, k) mesh, bitwise (columns in device order, bound, tmax)."""
    strings = list(_names(300, seed=7))
    ell, _, _ = JM.multihost_encode_shard(strings, JConfig(min_similarity=0.5))
    tile, d, cand_c, chunk = 16, 128, 8, 8
    per_dev = -(-300 // (k * tile)) * tile
    h = np.asarray(j_hash(ell, per_dev * k, d)).view(np.uint16)
    thr = 0.4
    mesh = JMesh(np.array(jax.devices()[:k]).reshape(1, k), ("dp", "mp"))
    a_j = jax.lax.bitcast_convert_type(jnp.asarray(h[:304]), jnp.bfloat16)
    b_j = jax.lax.bitcast_convert_type(jnp.asarray(h), jnp.bfloat16)
    cols_w, bound_w, tmax_w = JM._make_phase1_scan(mesh, tile, d)(
        cand_c, k_tile)(a_j.reshape(-1, chunk, d), b_j, jnp.float32(thr))
    b_slots = TM._slot_blocks(_bf16(h), [torch.device("cpu")] * k)
    a_rows = TM._slot_copies(_bf16(h[:304]), b_slots)
    cols, bound, tmax = TM._phase1_scan(
        a_rows, b_slots, thr, np.array([0]), np.array([304]), tile=tile,
        chunk=chunk, cand_c=cand_c, k_tile=k_tile)
    np.testing.assert_array_equal(cols, np.asarray(cols_w))
    np.testing.assert_array_equal(bound, np.asarray(bound_w))
    np.testing.assert_array_equal(tmax, np.asarray(tmax_w))
    assert cols.shape[0] == 304 and cols.shape[1] % k == 0
    assert (cols >= 0).any()


def test_slot_blocks_and_copies():
    block = torch.arange(24, dtype=torch.float32).view(12, 2)
    cpu = torch.device("cpu")
    parts = TM._slot_blocks(block, [cpu] * 3)
    assert [p[0, 0].item() for p in parts] == [0.0, 8.0, 16.0]
    assert all(p.data_ptr() == block[4 * j:].data_ptr()
               for j, p in enumerate(parts))  # views: no copy on one device
    copies = TM._slot_copies(block, parts)
    assert list(copies) == [cpu] and copies[cpu] is block
    rows = TM._rows_of(copies, np.array([3, 0]))
    np.testing.assert_array_equal(rows[cpu].numpy(), block[[3, 0]].numpy())


# ---------------------------------------------------------------- errors
def test_mismatched_slot_counts_raise_naming_both(monkeypatch):
    """The slot counts gather once; ranks that differ raise, every rank
    alike, naming both counts (simulated peer with 2 slots)."""
    monkeypatch.setattr(TM, "_world", lambda: (0, 2))
    monkeypatch.setattr(
        TM, "_allgather_host",
        lambda x: np.stack([x, np.array([1, 2], np.int64)]))
    with pytest.raises(ValueError, match=r"rank 0\) has 1, rank 1 has 2"):
        TM._rank_slots(None, torch.device("cpu"))
    assert TM._rank_slots(_slots(2), torch.device("cpu")) == [
        torch.device("cpu")] * 2


def test_invalid_mesh_on_a_peer_raises_here(monkeypatch):
    monkeypatch.setattr(
        TM, "_allgather_host",
        lambda x: np.stack([x, np.array([0, 1], np.int64)]))
    with pytest.raises(ValueError, match="invalid on another rank"):
        TM._rank_slots(None, torch.device("cpu"))


def test_wrong_device_type_slot_raises():
    """A cuda slot beside device='cpu' is refused: at construction, and by
    the tier itself on every rank."""
    bad = Mesh([[torch.device("cpu"), torch.device("cuda", 0)]])
    s = _names(40, seed=3)
    with pytest.raises(Exception, match="not a cpu device"):
        StringGrouper(s, multihost="sharded", mesh=bad, device="cpu")
    cfg = TConfig(multihost="sharded", mesh=bad, device="cpu")
    with pytest.raises(Exception, match="not a cpu device"):
        TM.multihost_sharded_fit_pairs(s, None, cfg)
    ell, _, _ = TM.multihost_encode_shard(list(s), TConfig(device="cpu"))
    with pytest.raises(Exception, match="not a cpu device"):
        TM.multihost_match_shard(ell, 0, 40, 0.5, 5, hash_dim=128, tile=8,
                                 device="cpu", mesh=bad)


def test_replicated_tier_keeps_its_mesh_meaning():
    """Beside the replicated tier the mesh is each rank's matcher mesh:
    the engine's stats carry the mesh matcher's, not the sharded scan's."""
    s = _names(150, seed=12)
    sg = StringGrouper(s, min_similarity=0.6, multihost="replicated",
                       mesh=_slots(4, dp=2), device="cpu").fit()
    assert sg.timings.labels["multihost_tier"] == "replicated"
    assert "match.mh_esc_rows" not in sg.timings.seconds
    assert_same(sg.get_matches(), sgj.match_strings(s, min_similarity=0.6))
