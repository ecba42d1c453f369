"""The port's mesh tier against the JAX package's, on the CPU.

The port's mesh is a ``(dp, mp)`` grid of torch devices whose slots all
name ``cpu`` (a virtual mesh); the JAX mesh is ``make_mesh`` over the 8
virtual CPU devices of conftest.py.  Both run the corpora of
tests/test_distributed.py (built with a seeded numpy generator), and the
port's ``MatchPairs`` must equal JAX's mesh matcher AND the port's
single-device matcher bitwise (exact fp64 rescore, deterministic
selection): self-join at every mesh shape, cross-join, thresholdless and
hot-row escalation.  The sharded encoder must equal the host encoder and
JAX's sharded encoder bitwise, payload included; the API under ``mesh=``
must give the frames of ``device="cpu"`` without a mesh and of JAX's API
with its mesh, exactly.
"""

import logging

import numpy as np
import pandas as pd
import pytest
import torch
from jax import numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

import string_grouper_tpu as sgj
import string_grouper_tpu_torch as sgt
from string_grouper_tpu import parallel as JP
from string_grouper_tpu.config import StringGrouperConfig as JConfig
from string_grouper_tpu.corpus import TfidfEncoder as JEncoder
from string_grouper_tpu_torch import parallel as TP
from string_grouper_tpu_torch.config import StringGrouperConfig as TConfig
from string_grouper_tpu_torch.corpus import TfidfEncoder as TEncoder
from string_grouper_tpu_torch.corpus.tfidf import ell_from_numpy
from string_grouper_tpu_torch.ops.matcher import topn_cosine_matches

from test_distributed import _synthetic_names
from test_torch_api import assert_same
from test_torch_matcher import _assert_pairs_equal, _carry

CPU = torch.device("cpu")
MESH_SHAPES = [(1, 1), (1, 2), (1, 8), (2, 4), (4, 2), (8, 1)]


def meshes(dp, mp):
    """(port mesh of cpu slots, JAX mesh) of the same shape."""
    return (TP.make_mesh(dp * mp, dp=dp, device="cpu"),
            JP.make_mesh(dp * mp, dp=dp))


def _to_port(ell):
    if ell.device_src is None:
        return ell_from_numpy(ell.ids, ell.vals64, ell.n_terms)
    return _carry(ell)


def _encode(series, other=None, **cfg):
    """The JAX encoder's corpus, and the same corpus carried to the port."""
    jl, jr = JEncoder(JConfig(**cfg)).fit_transform_pair(list(series), other)
    return (jl, jr), (_to_port(jl), _to_port(jr) if other is not None else None)


def _three_way(j_args, t_args, dp, mp, thr, max_n, **knobs):
    """JAX mesh, port mesh and port single device on the same corpus: the
    port's mesh pairs equal both."""
    t_mesh, j_mesh = meshes(dp, mp)
    j = JP.distributed_topn_cosine_matches(*j_args, thr, max_n, j_mesh, **knobs)
    t = TP.distributed_topn_cosine_matches(*t_args, thr, max_n, t_mesh, **knobs)
    single = topn_cosine_matches(*t_args, thr, max_n, device=CPU, **knobs)
    _assert_pairs_equal(t, j)
    _assert_pairs_equal(t, single)
    assert len(t.rows) > 0
    return t


# ------------------------------------------------------------------ matcher
@pytest.mark.parametrize("dp,mp", MESH_SHAPES)
def test_self_join_equals_jax_mesh_and_single_device(dp, mp):
    (jl, _), (tl, _) = _encode(_synthetic_names(150), min_similarity=0.6)
    _three_way((jl, None), (tl, None), dp, mp, 0.6, 20,
               left_chunk=32, right_tile=16)


@pytest.mark.parametrize("dp,mp", [(2, 4), (4, 2)])
def test_self_join_several_segments(dp, mp):
    """Small chunks: several segments of several super-chunks, the last
    zero-padded, so the dp row striping crosses segment boundaries."""
    (jl, _), (tl, _) = _encode(_synthetic_names(300, seed=5))
    _three_way((jl, None), (tl, None), dp, mp, 0.6, 20,
               left_chunk=8, right_tile=16)


@pytest.mark.parametrize("dp,mp", [(1, 8), (2, 4), (8, 1)])
def test_cross_join_equals_jax_mesh_and_single_device(dp, mp):
    dupes = list(_synthetic_names(75, seed=2))
    (jl, jr), (tl, tr) = _encode(_synthetic_names(120, seed=1), dupes)
    _three_way((jl, jr), (tl, tr), dp, mp, 0.5, 5,
               left_chunk=16, right_tile=8)


@pytest.mark.parametrize("dp,mp", [(2, 4), (1, 8)])
def test_zero_threshold_dense(dp, mp):
    """min_similarity 0 keeps every nonzero pair (full-width ship, raw
    gathered columns) on any mesh."""
    (jl, _), (tl, _) = _encode(_synthetic_names(40, seed=3))
    _three_way((jl, None), (tl, None), dp, mp, 0.0, 40,
               left_chunk=8, right_tile=8)


@pytest.mark.parametrize("dp,mp", [(1, 4), (2, 2), (4, 1)])
def test_hot_rows_escalate_per_row(dp, mp, caplog, monkeypatch):
    """A cluster of identical strings overflows the initial width: one
    whole-corpus pass, then per-row escalation under the mesh."""
    monkeypatch.setenv("SG_TPU_DEVICE_ENCODE", "0")  # keep the hot rows uncollapsed
    strings = ["hyper mega global quantum systems incorporated"] * 40
    strings += [f"zzfiller{i} qq{i} ww{i}" for i in range(88)]
    (jl, _), (tl, _) = _encode(pd.Series(strings))
    with caplog.at_level(logging.DEBUG, logger="string_grouper_tpu_torch"):
        t_mesh, j_mesh = meshes(dp, mp)
        t = TP.distributed_topn_cosine_matches(
            tl, None, 0.8, 5, t_mesh, left_chunk=16, right_tile=16
        )
    port_log = "\n".join(r.getMessage() for r in caplog.records
                         if r.name.startswith("string_grouper_tpu_torch"))
    assert "escalate" in port_log
    assert port_log.count("phase1: C=") == 1
    j = JP.distributed_topn_cosine_matches(
        jl, None, 0.8, 5, j_mesh, left_chunk=16, right_tile=16
    )
    _assert_pairs_equal(t, j)
    _assert_pairs_equal(t, topn_cosine_matches(tl, None, 0.8, 5, device=CPU))


def test_sort_compact_restores_prefixes():
    """Per-shard prefixes side by side: the sort puts each row's valid ids
    first, so the compaction keeps them all."""
    cols = torch.tensor([[3, -1, 7, 9], [-1, -1, 5, -1], [2, 4, -1, -1]],
                        dtype=torch.int32)
    flat, n_i = TP.distributed._sort_compact(cols, 8)
    assert n_i.tolist() == [3, 1, 2]
    assert flat.tolist() == [9, 7, 3, 5, 4, 2, -1, -1]


# ------------------------------------------------------------------ encoder
def _assert_encoders_equal(t_enc, t_ell, ref_enc, ref_ell, payload=True):
    np.testing.assert_array_equal(t_enc.vocab_keys_, ref_enc.vocab_keys_)
    np.testing.assert_array_equal(t_enc.idf_, ref_enc.idf_)
    np.testing.assert_array_equal(t_ell.ids, ref_ell.ids)
    np.testing.assert_array_equal(t_ell.vals64, ref_ell.vals64)
    if not payload:
        return
    src, ref = t_ell.device_src, ref_ell.device_src
    assert src is not None and ref is not None
    assert (src.base, src.ngram) == (ref.base, ref.ngram)
    for f in ("flat_codes", "coff", "inv_norm", "table_id", "idf32"):
        np.testing.assert_array_equal(getattr(src, f), getattr(ref, f), err_msg=f)


@pytest.mark.parametrize("dp,mp", [(1, 8), (2, 4), (8, 1)])
def test_sharded_fit_transform_bitwise(dp, mp):
    series = list(_synthetic_names(100, seed=9))
    t_mesh, j_mesh = meshes(dp, mp)
    enc = TEncoder(TConfig())
    s_m, s_d = TP.sharded_fit_transform(enc, series, None, t_mesh)
    assert s_d is s_m
    host = TEncoder(TConfig())
    h_m, _ = host.fit_transform_pair(series, None)
    _assert_encoders_equal(enc, s_m, host, h_m)
    # the clean-equality hashes the duplicate collapse codes rows by
    np.testing.assert_array_equal(s_m.device_src.row_hash,
                                  h_m.device_src.row_hash)
    j_enc = JEncoder(JConfig())
    j_m, _ = JP.sharded_fit_transform(j_enc, series, None, j_mesh)
    _assert_encoders_equal(enc, s_m, j_enc, j_m)


@pytest.mark.parametrize("dp,mp", [(1, 8), (2, 4)])
def test_sharded_fit_transform_float32_bitwise(dp, mp):
    series = list(_synthetic_names(90, seed=12))
    t_mesh, j_mesh = meshes(dp, mp)
    enc = TEncoder(TConfig(tfidf_matrix_dtype=np.float32))
    s_m, _ = TP.sharded_fit_transform(enc, series, None, t_mesh)
    host = TEncoder(TConfig(tfidf_matrix_dtype=np.float32))
    h_m, _ = host.fit_transform_pair(series, None)
    _assert_encoders_equal(enc, s_m, host, h_m, payload=False)
    assert s_m.device_src is None  # float32 carries no payload
    j_enc = JEncoder(JConfig(tfidf_matrix_dtype=np.float32))
    j_m, _ = JP.sharded_fit_transform(j_enc, series, None, j_mesh)
    _assert_encoders_equal(enc, s_m, j_enc, j_m, payload=False)


def test_sharded_fit_transform_cross_join_slices():
    master = list(_synthetic_names(37, seed=10))
    dupes = list(_synthetic_names(21, seed=11))
    t_mesh, j_mesh = meshes(2, 4)
    enc = TEncoder(TConfig())
    s_m, s_d = TP.sharded_fit_transform(enc, master, dupes, t_mesh)
    host = TEncoder(TConfig())
    h_m, h_d = host.fit_transform_pair(master, dupes)
    j_enc = JEncoder(JConfig())
    j_m, j_d = JP.sharded_fit_transform(j_enc, master, dupes, j_mesh)
    for got, h, j in ((s_m, h_m, j_m), (s_d, h_d, j_d)):
        _assert_encoders_equal(enc, got, host, h)
        _assert_encoders_equal(enc, got, j_enc, j)


def test_sharded_unicode_width_is_global():
    """A wide codepoint in ONE shard widens the packing for all shards."""
    strings = ["abc def"] * 9 + ["中文名字"] * 7
    cfg = dict(normalize_to_ascii=False)
    t_mesh, j_mesh = meshes(1, 8)
    enc = TEncoder(TConfig(**cfg))
    s_m, _ = TP.sharded_fit_transform(enc, strings, None, t_mesh)
    host = TEncoder(TConfig(**cfg))
    h_m, _ = host.fit_transform_pair(strings, None)
    _assert_encoders_equal(enc, s_m, host, h_m, payload=False)
    j_enc = JEncoder(JConfig(**cfg))
    j_m, _ = JP.sharded_fit_transform(j_enc, strings, None, j_mesh)
    _assert_encoders_equal(enc, s_m, j_enc, j_m, payload=False)


def test_df_sum_and_idf_equal_jax():
    """Per-shard DF counts summed over the mesh equal JAX's psum and the
    host encoder's DF; the IDF equals JAX's ``replicated_idf`` (both f32:
    rtol 1e-6, the f32 log's last bits) and the host encoder's."""
    series = list(_synthetic_names(64, seed=4))
    enc = TEncoder(TConfig())
    ell = enc.fit_transform(series)
    presence = np.zeros((64, ell.n_terms), dtype=np.float32)
    r, k = np.nonzero(ell.ids >= 0)
    presence[r, ell.ids[r, k]] = 1.0
    t_mesh, j_mesh = meshes(1, 8)
    local = [torch.from_numpy(blk.sum(0)) for blk in np.split(presence, 8)]
    df = TP.distributed_df_counts(local, t_mesh)
    j_df = shard_map(
        lambda b: JP.distributed_df_counts(b.sum(axis=0), "mp"),
        mesh=j_mesh, in_specs=P("mp", None), out_specs=P(), check_vma=False,
    )(jnp.asarray(presence))
    np.testing.assert_array_equal(df.numpy(), np.asarray(j_df))
    np.testing.assert_array_equal(df.numpy(), presence.sum(0))
    idf = TP.replicated_idf(df, float(enc.n_docs_))
    j_idf = JP.replicated_idf(j_df, float(enc.n_docs_))
    np.testing.assert_allclose(idf.numpy(), np.asarray(j_idf), rtol=1e-6)
    np.testing.assert_allclose(idf.numpy(), enc.idf_, rtol=1e-6)


# ---------------------------------------------------------------------- API
API_CASES = {
    "match_strings": (lambda s1, s2: (s1,), dict(min_similarity=0.6)),
    "match_strings_cross": (lambda s1, s2: (s1, s2), dict(min_similarity=0.5)),
    "group_similar_strings": (lambda s1, s2: (s1,), dict(min_similarity=0.6)),
    "match_most_similar": (lambda s1, s2: (s1, s2), dict(min_similarity=0.5)),
    "compute_pairwise_similarities": (lambda s1, s2: (s1, s2), {}),
}


@pytest.mark.parametrize("dp,mp", [(2, 4), (8, 1)])
@pytest.mark.parametrize("case", sorted(API_CASES))
def test_api_under_mesh(case, dp, mp):
    fn = case.removesuffix("_cross")
    args = API_CASES[case][0](_synthetic_names(120, seed=11),
                              _synthetic_names(120, seed=21))
    kw = API_CASES[case][1]
    t_mesh, j_mesh = meshes(dp, mp)
    got = getattr(sgt, fn)(*args, device="cpu", mesh=t_mesh, **kw)
    assert_same(got, getattr(sgt, fn)(*args, device="cpu", **kw))
    assert_same(got, getattr(sgj, fn)(*args, mesh=j_mesh, **kw))


def test_api_float32_under_mesh():
    series = _synthetic_names(90, seed=12)
    kw = dict(min_similarity=0.5, tfidf_matrix_dtype=np.float32)
    t_mesh, j_mesh = meshes(2, 4)
    got = sgt.match_strings(series, device="cpu", mesh=t_mesh, **kw)
    assert_same(got, sgt.match_strings(series, device="cpu", **kw))
    assert_same(got, sgj.match_strings(series, mesh=j_mesh, **kw))


def test_engine_mesh_through_update_options_and_twins():
    s = _synthetic_names(80, seed=14)
    want = sgt.match_strings(s, min_similarity=0.6, device="cpu")
    mesh = TP.make_mesh(2, device="cpu")
    g = sgt.StringGrouper(s, min_similarity=0.6, device="cpu")
    g.update_options(mesh=mesh)
    assert g._config.mesh is mesh
    assert_same(g.fit().get_matches(), want)
    assert "match.p1_wait" in g.timings.seconds
    twin = sgt.StringGrouper(s, device="cpu").match_strings(
        s, min_similarity=0.6, mesh=TP.make_mesh(4, dp=2, device="cpu"))
    assert_same(twin, want)


# --------------------------------------------------------------- validation
def test_make_mesh():
    m = TP.make_mesh(8, dp=2, device="cpu")
    assert m.axis_names == ("dp", "mp") and m.shape == {"dp": 2, "mp": 4}
    assert m.devices.shape == (2, 4) and all(d == CPU for d in m.devices.flat)
    assert TP.make_mesh(device="cpu").shape == {"dp": 1, "mp": 1}
    with pytest.raises(ValueError, match="not divisible"):
        TP.make_mesh(6, dp=4, device="cpu")


@pytest.mark.parametrize("bad", ["jax_mesh", "axes", "tuple", "cuda_slots"])
def test_validate_mesh_rejects(bad):
    s = pd.Series(["hyper inc", "hyper inc.", "mega corp"])
    mesh = {
        "jax_mesh": lambda: JP.make_mesh(2),
        "axes": lambda: TP.Mesh([[CPU, CPU]], axis_names=("x", "y")),
        "tuple": lambda: (2, 2),
        "cuda_slots": lambda: TP.Mesh([["cuda:0", "cuda:0"]]),
    }[bad]()
    with pytest.raises(Exception, match="string_grouper_tpu_torch.parallel.make_mesh"):
        sgt.match_strings(s, device="cpu", mesh=mesh)
    with pytest.raises(Exception, match="make_mesh"):
        sgt.StringGrouper(s, device="cpu").update_options(mesh=mesh)


def test_cuda_mesh_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: cuda slots are valid here")
    s = pd.Series(["hyper inc", "hyper inc.", "mega corp"])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TP.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sgt.match_strings(s, mesh=TP.Mesh([["cuda:0"]]))
    (_, _), (tl, _) = _encode(s)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TP.distributed_topn_cosine_matches(tl, None, 0.8, 5, TP.Mesh([["cuda"]]))
