"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips without them.  This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: ``p1_fused_closed2``, ``p1_fused_chain`` and ``p1_tri_fused``
on dyadic inputs (every f32 sum of the bf16 products is exact in any order)
must EQUAL their plain versions -- the running buffers' column ids where
their values are finite (the ids of -inf slots are unspecified: the kernels
skip inserts without a qualified score, the plain versions do not);
``device_hash_codes`` must be within 1 bf16 ulp of its plain version (which
on the card sums by atomics in no fixed order) and bitwise repeatable.  The
packed-slot torch op ``_device_hash`` must equal itself on the CPU bitwise,
and payload-less corpora (float32, a custom regex) must give the CPU's frame
on the fused kernel with no ``device_hash_codes`` launch.  The grouping and
nearest-match entry points must give the CPU's frames, and the torch op
``_cc_labels`` on the card the native union-find's labels, bitwise.  Under
``mesh=`` (virtual meshes over the card, and ``make_mesh()``) the fits
must give the CPU's frames with the kernels launched; under ``multihost``
(world 1, and two gloo ranks both on ``cuda:0``; the sharded tier also over
a virtual mesh's device slots) the card's default frame.  Under
``SG_TPU_FUSED=0`` the card launches no ``p1_fused_closed2`` and gives the
same frame; the torch op ``hashed_projection`` gives the CPU's bits.
The epilogue A/B kernels ``p1_mm_floor`` and ``p1_closed2_variant`` (every
switch) must equal ``p1_fused_closed2`` bitwise and their plain versions
on dyadic inputs; the default match path launches neither.  A traced
match (``utils.profiling.trace``) holds the fused kernel's events, and a
match leaves the caller's TF32 setting as it was.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import string_grouper_tpu_torch as sgt
from string_grouper_tpu_torch.config import StringGrouperConfig
from string_grouper_tpu_torch.corpus import TfidfEncoder
from string_grouper_tpu_torch.ops import _build
from string_grouper_tpu_torch.ops import kernels as K
from string_grouper_tpu_torch.ops import matcher as M
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

pytestmark = pytest.mark.cuda

#: kernels the default match path launches
DEFAULT_PATH = ("p1_fused_closed2", "device_hash_codes")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc")
    return torch.device("cuda")


def _dyadic(n, d, seed=0, nnz=20, step=2.0 ** -7):
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, d), np.float32)
    np.put_along_axis(dense, rng.integers(0, d, size=(n, nnz)),
                      rng.random((n, nnz)).astype(np.float32), axis=1)
    dense[1] = dense[0]
    dense[2] = dense[0]
    dense /= np.linalg.norm(dense, axis=1, keepdims=True) + 1e-9
    return (np.round(dense / step) * step).astype(np.float32)


@pytest.mark.parametrize("m,n,d,tile,cand_c,thr", [
    (256, 1024, 128, 256, 8, 0.6),
    (300, 8192, 512, 4096, 64, 0.5),    # ragged last row block
    (512, 2048, 256, 512, 256, 0.3),    # widest top-C
    (256, 4096, 384, 1024, 24, 0.4),    # C not a multiple of 32
    (384, 4096, 512, 256, 256, 0.3),    # d 512, tile 256: 2 sub-blocks a tile
    (300, 2048, 512, 256, 8, 0.5),      # ragged, d 512, tile 256, smallest C
])
def test_p1_kernel_equals_plain(dev, m, n, d, tile, cand_c, thr):
    b = torch.from_numpy(_dyadic(n, d, seed=m)).to(torch.bfloat16).to(dev)
    a = b[:m].contiguous()
    before = K.LAUNCHES["p1_fused_closed2"]
    got = K.p1_fused_closed2(a, b, thr, tile=tile, cand_c=cand_c)
    assert K.LAUNCHES["p1_fused_closed2"] == before + 1
    want = K.p1_fused_closed2_plain(a, b, thr, tile=tile, cand_c=cand_c)
    for name, g, w in zip(("ship", "counts", "tmax", "bound", "max_cnt"), got, want):
        assert torch.equal(g.cpu(), w.cpu()), name
    assert int(got[1].sum()) > 0


def test_p1_kernel_ties_take_first_column(dev):
    """Many duplicate right rows: equal maxima at columns held by different
    lanes, quads and warps; the argmax must be the first (jnp.argmax), and
    tiles with exactly 2 qualified columns take the second by index sum."""
    rng = np.random.default_rng(4)
    distinct = _dyadic(512, 256, seed=9)
    b_np = distinct[rng.integers(0, 512, size=4096)]
    b = torch.from_numpy(b_np).to(torch.bfloat16).to(dev)
    a = torch.from_numpy(distinct[:256]).to(torch.bfloat16).to(dev)
    got = K.p1_fused_closed2(a, b, 0.95, tile=256, cand_c=16)
    want = K.p1_fused_closed2_plain(a, b, 0.95, tile=256, cand_c=16)
    for name, g, w in zip(("ship", "counts", "tmax", "bound", "max_cnt"), got, want):
        assert torch.equal(g.cpu(), w.cpu()), name
    tmax = got[2].cpu()
    assert int((tmax == 2).sum()) > 0 and int((tmax > 2).sum()) > 0


def _masked_cols(v, c):
    """Column ids where the value is finite (-inf slots' ids are
    unspecified)."""
    return torch.where(v > float("-inf"), c, -1).cpu()


@pytest.mark.parametrize("m,chunks,d,tile,cand_c,thr", [
    (512, [2048], 128, 256, 16, 0.5),                # one chunk
    (384, [1024, 768, 512], 128, 256, 8, 0.5),       # unequal chunks
    (256, [8192, 4096], 512, 4096, 64, 0.4),         # main-path tile and width
    (300, [768, 256, 1280], 512, 256, 16, 0.4),      # ragged; chunks of 1-5 tiles
])
def test_chain_kernel_equals_plain_and_one_pass(dev, m, chunks, d, tile,
                                                cand_c, thr):
    b = torch.from_numpy(_dyadic(sum(chunks), d, seed=m)).to(torch.bfloat16).to(dev)
    a = b[:m].contiguous()
    st_k = K.p1_chain_init(m, cand_c, dev)
    st_p = K.p1_chain_init(m, cand_c, dev)
    lo = 0
    for nc in chunks:
        before = K.LAUNCHES["p1_fused_chain"]
        got = K.p1_fused_chain(a, b[lo:lo + nc], thr, lo, st_k, tile, cand_c)
        assert K.LAUNCHES["p1_fused_chain"] == before + 1
        want = K.p1_fused_chain_plain(a, b[lo:lo + nc], thr, lo, st_p, tile, cand_c)
        for name, g, w in zip(("ship", "counts", "tmax", "bound", "max_cnt"),
                              got[:5], want[:5]):
            assert torch.equal(g.cpu(), w.cpu()), (lo, name)
        (vk, ck, mk, tk), (vp, cp, mp, tp) = st_k, st_p
        assert torch.equal(vk.cpu(), vp.cpu()), (lo, "v")
        assert torch.equal(_masked_cols(vk, ck), _masked_cols(vp, cp)), (lo, "c")
        assert torch.equal(mk.cpu(), mp.cpu()), (lo, "meta")
        assert torch.equal(tk.cpu(), tp.cpu()), (lo, "tb")
        lo += nc
    one = K.p1_fused_closed2(a, b, thr, tile=tile, cand_c=cand_c)
    for name, g, w in zip(("ship", "counts", "tmax", "bound", "max_cnt"),
                          got[:5], one):
        assert torch.equal(g.cpu(), w.cpu()), ("one pass", name)
    assert int(got[1].sum()) > 0 and int(got[2].max()) > 2


def _check_tri_segments(b, tile, cpg, bm, cand_c, thr):
    """Every segment of the triangular scan over ``b``, in order (the last
    one has no future columns), kernel against plain: row sides and the
    packed future state equal after each segment."""
    dev = b.device
    n = b.shape[0]
    seg_rows = cpg * tile
    f_k = K.tri_future_init(n, dev)
    f_p = K.tri_future_init(n, dev)
    for s in range(n // seg_rows):
        a = b[s * seg_rows:(s + 1) * seg_rows]
        before = K.LAUNCHES["p1_tri_fused"]
        rv, rc, rm, _ = K.p1_tri_fused(a, b, f_k, s * cpg, thr, tile, cand_c, bm)
        assert K.LAUNCHES["p1_tri_fused"] == before + 1
        pv, pc, pm, _ = K.p1_tri_fused_plain(a, b, f_p, s * cpg, thr, tile,
                                             cand_c, bm)
        assert torch.equal(rv.cpu(), pv.cpu()), (s, "rv")
        assert torch.equal(_masked_cols(rv, rc), _masked_cols(pv, pc)), (s, "rc")
        assert torch.equal(rm.cpu(), pm.cpu()), (s, "rmeta")
        (kv, kc, km), (qv, qc, qm) = K.tri_future_unpack(f_k), K.tri_future_unpack(f_p)
        assert torch.equal(kv.cpu(), qv.cpu()), (s, "future values")
        assert torch.equal(_masked_cols(kv, kc), _masked_cols(qv, qc)), (s, "future cols")
        assert torch.equal(km.cpu(), qm.cpu()), (s, "future meta")
    return K.tri_future_unpack(f_k)[2]


@pytest.mark.parametrize("n,d,tile,cpg,bm,cand_c,thr", [
    (2048, 128, 256, 2, 128, 16, 0.4),
    (1024, 256, 256, 1, 256, 8, 0.3),   # last segment's j0 is the last tile
    (4096, 512, 512, 2, 512, 64, 0.3),
    (2048, 384, 256, 1, 128, 256, 0.3),  # d 384, block_m < tile, widest top-C
    (4096, 512, 512, 2, 128, 8, 0.3),   # d 512, block_m 128, smallest C
    (2048, 128, 512, 1, 512, 256, 0.4),  # block_m = tile, C 256
    (3072, 384, 512, 2, 256, 8, 0.3),   # 3 segments, d 384, C 8
])
def test_tri_kernel_equals_plain(dev, n, d, tile, cpg, bm, cand_c, thr):
    b = torch.from_numpy(_dyadic(n, d, seed=n + d)).to(torch.bfloat16).to(dev)
    meta = _check_tri_segments(b, tile, cpg, bm, cand_c, thr)
    assert float(meta[:, 0].sum()) > 0


def test_tri_kernel_ties_take_first_row(dev):
    """Many duplicate rows: a future column meets equal maxima in rows held
    by different quads, warps, warpgroups and 128-row chunks; the column
    side must keep the first row, and count exactly-2 and more-than-2
    columns as the plain version does."""
    rng = np.random.default_rng(5)
    distinct = _dyadic(256, 256, seed=11)
    b_np = distinct[rng.integers(0, 256, size=2048)]
    b = torch.from_numpy(b_np).to(torch.bfloat16).to(dev)
    meta = _check_tri_segments(b, 256, 2, 256, 16, 0.95)
    assert int((meta[:, 1] == 2).sum()) > 0 and int((meta[:, 1] > 2).sum()) > 0


@pytest.mark.parametrize("m,n,d,tile,cand_c,thr", [
    (256, 1024, 128, 256, 8, 0.6),
    (300, 8192, 512, 4096, 64, 0.5),    # ragged: a 64-row block and a half one
    (512, 2048, 256, 512, 256, 0.3),    # widest top-C
    (384, 4096, 512, 256, 256, 0.3),    # d 512, tile 256
])
def test_epilogue_ab_kernels_equal_closed2_and_plain(dev, m, n, d, tile, cand_c, thr):
    b = torch.from_numpy(_dyadic(n, d, seed=m)).to(torch.bfloat16).to(dev)
    a = b[:m].contiguous()
    ref = K.p1_fused_closed2(a, b, thr, tile=tile, cand_c=cand_c)
    before = dict(K.LAUNCHES)
    floor = K.p1_mm_floor(a, b, thr)
    assert K.LAUNCHES["p1_mm_floor"] == before["p1_mm_floor"] + 1
    assert torch.equal(floor, ref[1])
    assert torch.equal(floor.cpu(), K.p1_mm_floor_plain(a, b, thr).cpu())
    for block_rows in K.VARIANT_BLOCK_ROWS:
        for argmax in K.VARIANT_ARGMAX:
            got = K.p1_closed2_variant(a, b, thr, tile, cand_c, block_rows, argmax)
            want = K.p1_closed2_variant_plain(a, b, thr, tile, cand_c,
                                              block_rows, argmax)
            for name, g, r, w in zip(("ship", "counts", "tmax", "bound", "max_cnt"),
                                     got, ref, want):
                assert torch.equal(g, r), (block_rows, argmax, name)
                assert torch.equal(g.cpu(), w.cpu()), (block_rows, argmax, name)
    assert K.LAUNCHES["p1_closed2_variant"] == before["p1_closed2_variant"] + 4
    assert int(floor.sum()) > 0


def test_variant_ties_take_first_column(dev):
    """test_p1_kernel_ties_take_first_column's duplicates under both tie
    rules and both block sizes."""
    rng = np.random.default_rng(4)
    distinct = _dyadic(512, 256, seed=9)
    b = torch.from_numpy(distinct[rng.integers(0, 512, size=4096)]).to(torch.bfloat16).to(dev)
    a = torch.from_numpy(distinct[:256]).to(torch.bfloat16).to(dev)
    ref = K.p1_fused_closed2(a, b, 0.95, tile=256, cand_c=16)
    for block_rows in K.VARIANT_BLOCK_ROWS:
        for argmax in K.VARIANT_ARGMAX:
            got = K.p1_closed2_variant(a, b, 0.95, 256, 16, block_rows, argmax)
            for g, r in zip(got, ref):
                assert torch.equal(g, r), (block_rows, argmax)
    assert int((ref[2] == 2).sum()) > 0 and int((ref[2] > 2).sum()) > 0


def test_default_match_launches_no_ab_kernel_and_keeps_tf32(dev):
    s = pd.Series(synthetic_company_names(3000, seed=33))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        K.reset_launches()
        sgt.match_strings(s)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
    assert K.LAUNCHES["p1_fused_closed2"] > 0, K.LAUNCHES
    assert K.LAUNCHES["p1_mm_floor"] == K.LAUNCHES["p1_closed2_variant"] == 0


def test_trace_holds_the_fused_kernel(dev, tmp_path):
    from string_grouper_tpu_torch.utils import profiling as P

    s = pd.Series(synthetic_company_names(3000, seed=35))
    want = sgt.match_strings(s)
    with P.trace(log_dir=str(tmp_path)):
        got = sgt.match_strings(s)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    events = P.read_trace(P.trace_files(str(tmp_path))[-1])
    assert any("scan_kernel" in k for k in P.kernel_durations(events))
    assert P.union_us(P.device_intervals(events)) > 0


def test_new_kernels_raise_on_unsupported_cuda_shapes(dev):
    b = torch.zeros((1024, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        K.p1_fused_chain(b[:100], b, 0.5, 0, K.p1_chain_init(100, 8, dev), 256, 8)
    with pytest.raises(ValueError):  # block_m not whole 128-row chunks
        K.p1_tri_fused(b[:256], b, K.tri_future_init(1024, dev), 0, 0.5, 256, 8, 64)
    with pytest.raises(TypeError):
        K.p1_tri_fused(b[:256].float(), b, K.tri_future_init(1024, dev), 0,
                       0.5, 256, 8, 128)
    with pytest.raises(ValueError):  # half a pair of sub-blocks
        K.p1_mm_floor(b[:256], b[:384], 0.5)
    with pytest.raises(ValueError):
        K.p1_closed2_variant(b[:256], b, 0.5, 256, 8, block_rows=32)
    with pytest.raises(TypeError):
        K.p1_mm_floor(b[:256].float(), b, 0.5)


# 2: one hash bit; 4096: > 48 KB of histograms; 32768: one warp per block
@pytest.mark.parametrize("dim", [2, 128, 512, 4096, 32768])
def test_device_hash_kernel_within_one_ulp(dev, dim):
    """Packed and raw codes; widths a multiple of 40, one that is not a
    multiple of 5, and one below the n-gram size (every row gets h = 0);
    rows shorter than the n-gram size in the corpus."""
    names = synthetic_company_names(5000) + ["ab", "q", "xy", "abc"]
    src = TfidfEncoder(StringGrouperConfig()).fit_transform(names).device_src
    n = len(src.inv_norm)
    wide = -(-int(src.row_lengths().max()) // 40) * 40
    for width in (wide, wide - 7, src.ngram - 1):
        for packed in (True, False):
            order = np.arange(n, dtype=np.int32)
            codes = (M._fill_code_rows6(src, order, width) if packed
                     else M._fill_code_rows(src, order, width))
            args = (M._to_device(codes, dev), M._to_device(src.inv_norm, dev),
                    M._to_device(src.table_id, dev), M._to_device(src.idf32, dev),
                    dim, src.base, src.ngram)
            w = width if packed else None
            got = K.device_hash_codes(*args, width=w)
            again = K.device_hash_codes(*args, width=w)
            want = K.device_hash_codes_plain(*args, width=w)
            assert torch.equal(got, again)
            ulp = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
            assert int(ulp.max()) <= 1, (width, packed)
            if width < src.ngram:
                assert int(got.view(torch.int16).abs().sum()) == 0
            else:
                assert int((got.float().abs().sum(1) == 0).sum()) < n


def test_match_strings_card_equals_cpu(dev):
    s = pd.Series(synthetic_company_names(3000, seed=5))
    K.reset_launches()
    card = sgt.match_strings(s)
    assert all(K.LAUNCHES[k] > 0 for k in DEFAULT_PATH), K.LAUNCHES
    pd.testing.assert_frame_equal(card, sgt.match_strings(s, device="cpu"))


def test_chunked_match_strings_card_equals_default(dev, monkeypatch):
    """SG_TPU_CHUNKED_P1=1 (size floor lowered; 256-row chunks give 8
    segments at 20,000 names): chained kernel passes, the default frame."""
    s = pd.Series(synthetic_company_names(20000, seed=7))
    knobs = dict(left_chunk=256, right_tile=256)
    want = sgt.match_strings(s, **knobs)
    monkeypatch.setattr(M, "_CHUNKED_P1_MIN_ROWS", 1000)
    for groups in ("2", "3"):
        monkeypatch.setenv("SG_TPU_CHUNKED_P1", "1")
        monkeypatch.setenv("SG_TPU_CHUNKED_P1_GROUPS", groups)
        K.reset_launches()
        got = sgt.match_strings(s, **knobs)
        assert K.LAUNCHES["p1_fused_chain"] > 0, K.LAUNCHES
        pd.testing.assert_frame_equal(got, want)


def test_kt2_escalation_rows_card_equals_cpu(dev):
    """``run_rows`` at k_tile=2 (the fused kernel on the card, the torch-op
    tile body on the CPU) returns the same candidate pairs, and bounds
    within 1e-5 (f32 sums in different orders)."""
    ell = TfidfEncoder(StringGrouperConfig()).fit_transform(
        synthetic_company_names(20000, seed=3)
    )
    rows = np.arange(0, 20000, 7, dtype=np.int64)
    thr = M.effective_threshold(0.8)
    out = {}
    for d in (dev, torch.device("cpu")):
        _, run_rows, _, _ = M._phase1_single(ell, ell, True, 512, 4096, 4096, d)
        r, c, b = run_rows(rows, thr, 128, 2, budget_hint=None)
        order = np.lexsort((c, r))
        out[d.type] = (r[order], c[order], b)
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=0, atol=1e-5)
    assert len(out["cpu"][0]) > 0


@pytest.mark.parametrize("dim", [128, 512])
def test_device_hash_card_equals_cpu(dev, dim):
    """The packed-slot torch op sums every bucket in slot order on both
    devices: bitwise equal."""
    ell = TfidfEncoder(StringGrouperConfig(tfidf_matrix_dtype=np.float32)
                       ).fit_transform(synthetic_company_names(6000, seed=9))
    assert ell.device_src is None
    packed = M.pack_hash_inputs(ell, ell.n_rows + 5, dim)
    got = M._device_hash(M._to_device(packed, dev), dim)
    want = M._device_hash(torch.from_numpy(packed), dim)
    assert torch.equal(got.cpu(), want)
    assert int((want.float().abs().sum(1) == 0).sum()) == 5  # padding rows


@pytest.mark.parametrize("kw", [
    dict(tfidf_matrix_dtype=np.float32),
    dict(regex=r"[,-./#&]|\s"),
], ids=["float32", "regex"])
def test_packed_match_strings_card_equals_cpu(dev, kw):
    """Payload-less corpora: the packed-slot hash feeds the fused kernel on
    the card; ``device_hash_codes`` is not launched."""
    s = pd.Series(synthetic_company_names(3000, seed=13))
    K.reset_launches()
    card = sgt.match_strings(s, **kw)
    assert K.LAUNCHES["p1_fused_closed2"] > 0, K.LAUNCHES
    assert K.LAUNCHES["device_hash_codes"] == 0, K.LAUNCHES
    pd.testing.assert_frame_equal(card, sgt.match_strings(s, device="cpu", **kw))


def test_match_strings_cross_join_card_equals_cpu(dev):
    master = pd.Series(synthetic_company_names(3000, seed=11))
    dupes = pd.Series(synthetic_company_names(2000, seed=12))
    K.reset_launches()
    card = sgt.match_strings(master, dupes, min_similarity=0.7)
    assert all(K.LAUNCHES[k] > 0 for k in DEFAULT_PATH), K.LAUNCHES
    cpu = sgt.match_strings(master, dupes, min_similarity=0.7, device="cpu")
    pd.testing.assert_frame_equal(card, cpu)


@pytest.mark.parametrize("rule", ["centroid", "first"])
def test_group_similar_strings_card_equals_cpu(dev, rule):
    s = pd.Series(synthetic_company_names(3000, seed=15), name="name")
    K.reset_launches()
    card = sgt.group_similar_strings(s, group_rep=rule)
    assert all(K.LAUNCHES[k] > 0 for k in DEFAULT_PATH), K.LAUNCHES
    cpu = sgt.group_similar_strings(s, group_rep=rule, device="cpu")
    pd.testing.assert_frame_equal(card, cpu, check_exact=True)
    assert card["group_rep_name"].nunique() < len(s)


def test_match_most_similar_with_ids_card_equals_cpu(dev):
    master = pd.Series(synthetic_company_names(3000, seed=11), name="name")
    dupes = pd.Series(synthetic_company_names(1500, seed=16) + list(master[:100]))
    mid = pd.Series([f"m{i}" for i in range(len(master))])
    did = pd.Series([f"d{i}" for i in range(len(dupes))])
    K.reset_launches()
    card = sgt.match_most_similar(master, dupes, mid, did, min_similarity=0.7)
    assert all(K.LAUNCHES[k] > 0 for k in DEFAULT_PATH), K.LAUNCHES
    cpu = sgt.match_most_similar(master, dupes, mid, did, min_similarity=0.7,
                                 device="cpu")
    pd.testing.assert_frame_equal(card, cpu, check_exact=True)
    assert len(card) == len(dupes)


def test_cc_labels_card_equals_native_union_find(dev):
    from string_grouper_tpu_torch.native import get_scorer_lib
    from string_grouper_tpu_torch.ops.connected_components import (
        _cc_labels,
        connected_components,
    )

    assert get_scorer_lib() is not None
    rng = np.random.default_rng(3)
    n = 100_000
    chain = np.arange(50_000, 55_000, dtype=np.int64)  # one long path
    a = np.r_[rng.integers(0, n, 80_000), chain[1:]].astype(np.int64)
    b = np.r_[rng.integers(0, n, 80_000), chain[:-1]].astype(np.int64)
    want = connected_components(a, b, n, dev)  # the native union-find
    got = _cc_labels(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), n)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert len(np.unique(want[chain])) == 1


def _virtual_mesh(dev, dp, mp):
    from string_grouper_tpu_torch.parallel import Mesh

    return Mesh([[dev] * mp for _ in range(dp)])


def test_mesh_match_strings_card_equals_cpu(dev):
    """A (2, 2) mesh over the one card: the host encode, then
    ``p1_fused_closed2`` per (segment, shard); the CPU's frame."""
    s = pd.Series(synthetic_company_names(4000, seed=5))
    K.reset_launches()
    card = sgt.match_strings(s, mesh=_virtual_mesh(dev, 2, 2))
    assert all(K.LAUNCHES[k] > 0 for k in DEFAULT_PATH), K.LAUNCHES
    pd.testing.assert_frame_equal(card, sgt.match_strings(s, device="cpu"))


def test_mesh_cross_join_and_groups_card_equals_cpu(dev):
    from string_grouper_tpu_torch.parallel import make_mesh

    master = pd.Series(synthetic_company_names(3000, seed=11), name="name")
    dupes = pd.Series(synthetic_company_names(2000, seed=12))
    mesh = make_mesh()
    K.reset_launches()
    card = sgt.match_strings(master, dupes, min_similarity=0.7, mesh=mesh)
    assert all(K.LAUNCHES[k] > 0 for k in DEFAULT_PATH), K.LAUNCHES
    # every GPU of the mesh launched its shards' scans, and only those
    on = {d for (k, d) in K.LAUNCHES_BY_DEVICE if k == "p1_fused_closed2"}
    assert on == {str(d) for d in mesh.devices.flat}, K.LAUNCHES_BY_DEVICE
    cpu = sgt.match_strings(master, dupes, min_similarity=0.7, device="cpu")
    pd.testing.assert_frame_equal(card, cpu)
    groups = sgt.group_similar_strings(master, mesh=_virtual_mesh(dev, 1, 4))
    pd.testing.assert_frame_equal(
        groups, sgt.group_similar_strings(master, device="cpu"), check_exact=True)


def test_mesh_float32_card_equals_cpu(dev):
    """The packed-slot hash under a (2, 2) mesh: no ``device_hash_codes``."""
    s = pd.Series(synthetic_company_names(3000, seed=13))
    kw = dict(tfidf_matrix_dtype=np.float32)
    K.reset_launches()
    card = sgt.match_strings(s, mesh=_virtual_mesh(dev, 2, 2), **kw)
    assert K.LAUNCHES["p1_fused_closed2"] > 0, K.LAUNCHES
    assert K.LAUNCHES["device_hash_codes"] == 0, K.LAUNCHES
    pd.testing.assert_frame_equal(card, sgt.match_strings(s, device="cpu", **kw))


def test_multihost_world1_card_equals_default(dev):
    """The multi-process tiers with no group (world 1) on the card: the
    replicated tier (the single-device matcher on the whole slice) and the
    sharded tier (scan + ring + ladder) give the default card frame."""
    s = pd.Series(synthetic_company_names(2000, seed=17))
    want = sgt.match_strings(s)
    for mh in (True, "sharded"):
        K.reset_launches()
        got = sgt.match_strings(s, multihost=mh)
        assert K.LAUNCHES["device_hash_codes"] > 0, (mh, K.LAUNCHES)
        pd.testing.assert_frame_equal(got, want, check_exact=True)


_RANK = r"""
import json, sys
from datetime import timedelta
import pandas as pd, torch, torch.distributed as dist
import string_grouper_tpu_torch as sgt
from string_grouper_tpu_torch.ops import kernels as K
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world,
                        timeout=timedelta(seconds=120))
s = pd.Series(synthetic_company_names(10000, seed=19))
want = sgt.match_strings(s, multihost=False)
for mh in (None, "sharded"):
    K.reset_launches()
    got = sgt.match_strings(s, multihost=mh)
    launches = dict(K.LAUNCHES)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    print("RANK_OK", rank, mh, json.dumps(launches), flush=True)
dist.destroy_process_group()
"""


def test_two_ranks_on_one_card_equal_frames(dev):
    """Two gloo ranks, both on cuda:0: the auto-selected replicated tier
    and the sharded tier give every rank the single-process card frame,
    and each rank launches ``p1_fused_closed2`` in both."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=root, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), "2", port],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        lines = [ln.split() for ln in out.splitlines() if ln.startswith("RANK_OK")]
        assert [ln[2] for ln in lines] == ["None", "sharded"], out[-3000:]
        for ln in lines:
            assert ln[1] == str(r)
            assert json.loads(" ".join(ln[3:]))["p1_fused_closed2"] > 0, ln


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2)])
def test_sharded_slots_card_equals_default(dev, dp, mp):
    """The sharded tier over a virtual mesh's slots (world 1, so dp x mp
    devices): the default card frame, ``p1_fused_closed2`` launched once
    per slot on the first (kt = 2) pass."""
    from string_grouper_tpu_torch.parallel import Mesh

    s = pd.Series(synthetic_company_names(8192, seed=23))
    want = sgt.match_strings(s)
    K.reset_launches()
    got = sgt.match_strings(s, multihost="sharded",
                            mesh=Mesh([[dev] * mp for _ in range(dp)]))
    assert K.LAUNCHES["p1_fused_closed2"] == dp * mp, K.LAUNCHES
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_fused_switch_off_launches_no_kernel(dev, monkeypatch):
    """``SG_TPU_FUSED=0``: the torch-op body everywhere, the same frame."""
    s = pd.Series(synthetic_company_names(5000, seed=29))
    K.reset_launches()
    want = sgt.match_strings(s)
    assert K.LAUNCHES["p1_fused_closed2"] > 0, K.LAUNCHES
    monkeypatch.setenv("SG_TPU_FUSED", "0")
    K.reset_launches()
    got = sgt.match_strings(s)
    assert K.LAUNCHES["p1_fused_closed2"] == 0, K.LAUNCHES
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_hashed_projection_card_equals_cpu(dev):
    """The torch op ``hashed_projection`` (one ``scatter_add_`` per slot
    column): the card's f32 sums bitwise the CPU's."""
    from string_grouper_tpu_torch.ops.hashing import hashed_projection

    ell = TfidfEncoder(StringGrouperConfig()).fit_transform(
        synthetic_company_names(3000, seed=31)).wait_ready()
    ids = torch.from_numpy(ell.ids)
    vals = torch.from_numpy(ell.vals64.astype(np.float32))
    want = hashed_projection(ids, vals, 512)
    got = hashed_projection(ids.to(dev), vals.to(dev), 512).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
