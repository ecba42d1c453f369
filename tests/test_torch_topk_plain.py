"""``p1_fused_topk``'s plain version and its route, on the CPU.

* The plain version against the JAX package's tile body ``_ub_topk_scan``
  and the port's torch-op copy of it, on the same dyadic inputs (exact
  sums): the same candidates per row, in the same order, the same counts and tmax, and a bound that is at least every
  qualified candidate the row did not keep and -inf when it kept them all
  -- at k_tile 4, 8, 16 and 32 and several top-C widths, on rows whose
  tiles overflow k_tile, rows truncated at C, duplicate right rows (ties)
  and rows with nothing qualified.
* The site: ``run_rows`` sends k_tile 4-32 to ``p1_fused_topk`` when
  ``use_fused_topk`` holds (the CPU opens it by patching the one device
  check, as tests/test_torch_fused_switch.py does), padded to 128-row
  blocks, and counts the rows in ``stats["esc_kernel_rows"]``; the same
  pairs as the torch-op body.  A real CPU fit launches nothing and counts
  0 in ``timings["match.esc_kernel_rows"]``.
* chip_smoke.py's spy on the escalation jobs, which its card phases use.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from string_grouper_tpu.ops import matcher as JM
import string_grouper_tpu_torch as sgt
from string_grouper_tpu_torch.config import StringGrouperConfig
from string_grouper_tpu_torch.corpus import TfidfEncoder
from string_grouper_tpu_torch.ops import kernels as K
from string_grouper_tpu_torch.ops import matcher as M
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

CPU = torch.device("cpu")


def topk_rows(m, n, d, seed=0, step=2.0 ** -7):
    """(a, b) dyadic bf16 rows (every f32 sum of their products exact): b
    draws half its rows from two "hot" rows (dozens of equal scores a tile:
    ties, overflowing tiles, rows truncated at C) and half from distinct
    sparse rows; a is b's first m rows with the two hot rows first and
    rows 2-9 zero (nothing qualifies)."""
    rng = np.random.default_rng(seed)
    distinct = np.zeros((n + 2, d), np.float32)
    np.put_along_axis(distinct, rng.integers(0, d, size=(n + 2, 20)),
                      rng.random((n + 2, 20)).astype(np.float32), axis=1)
    distinct /= np.linalg.norm(distinct, axis=1, keepdims=True)
    distinct = np.round(distinct / step) * step
    pick = np.arange(2, n + 2)
    hot = rng.random(n) < 0.5
    pick[hot] = rng.integers(0, 2, size=int(hot.sum()))
    b = distinct[pick]
    a = b[:m].copy()
    a[:2] = distinct[:2]
    a[2:10] = 0
    bf = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)
    return bf(a), bf(b)


@pytest.mark.parametrize("cand_c", [8, 64, 1024])
@pytest.mark.parametrize("k_tile", [4, 8, 16, 32])
def test_plain_equals_tile_body(k_tile, cand_c):
    a, b = topk_rows(256, 2048, 128, seed=k_tile)
    tile, thr = 256, 0.5
    ship, counts, tmax, bound, max_cnt = K.p1_fused_topk_plain(
        a, b, thr, tile=tile, cand_c=cand_c, k_tile=k_tile)
    w_vals, w_cols, t_counts, t_tmax, t_bound = M._ub_topk_scan(
        a, b.reshape(-1, tile, 128), thr, cand_c, k_tile)
    want = M.finalize_ship(w_vals, w_cols)
    w = want.shape[1]
    assert torch.equal(ship[:, :w], want)
    assert bool((ship[:, w:] == -1).all())
    assert torch.equal(counts, t_counts) and torch.equal(tmax, t_tmax)
    assert torch.equal(bound, t_bound)
    # the JAX package's tile body on the same rows
    bj = jnp.asarray(b.float().numpy(), jnp.bfloat16)
    j_vals, j_cols, j_counts, j_tmax, j_bound = JM._ub_topk_scan(
        jnp.asarray(a.float().numpy(), jnp.bfloat16), bj.reshape(-1, tile, 128),
        jnp.float32(thr), cand_c, k_tile)
    j_ship = np.asarray(JM.finalize_ship(j_vals, j_cols))
    np.testing.assert_array_equal(ship[:, :j_ship.shape[1]].numpy(), j_ship)
    assert bool((ship[:, j_ship.shape[1]:] == -1).all())
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(j_tmax))
    np.testing.assert_array_equal(bound.numpy(), np.asarray(j_bound))
    assert int(max_cnt) == int(tmax.max())
    # the bound covers every qualified candidate the row left out
    s = a.float() @ b.float().T
    for r in range(a.shape[0]):
        kept = set(ship[r][ship[r] >= 0].tolist())
        left = [c for c in torch.nonzero(s[r] >= thr).flatten().tolist()
                if c not in kept]
        if left:
            assert float(s[r, left].max()) <= float(bound[r]), r
        else:
            assert bound[r] == float("-inf"), r
    # the inputs hold what the test is for: tiles that overflow k_tile,
    # rows with nothing qualified and, where k_tile x tiles exceeds C, rows
    # truncated at C (more than C extracted candidates)
    per_tile = (s >= thr).reshape(a.shape[0], -1, tile).sum(2)
    nfin = torch.clamp(per_tile, max=k_tile).sum(1)
    assert int((tmax > k_tile).sum()) > 0
    assert int((counts[2:10] != 0).sum()) == 0
    if k_tile * (2048 // tile) > cand_c:
        assert int((nfin > cand_c).sum()) > 0


def test_plain_ties_take_first_column():
    """Equal scores of duplicate right rows come out in column order."""
    a, b = topk_rows(128, 1024, 128, seed=3)
    ship, *_ = K.p1_fused_topk_plain(a, b, 0.5, tile=256, cand_c=64, k_tile=8)
    s = (a.float() @ b.float().T)
    for r in (0, 1):
        cols = ship[r][ship[r] >= 0]
        vals = s[r, cols.long()]
        assert bool((vals[1:] <= vals[:-1]).all())
        for v in torch.unique(vals):
            same = cols[vals == v]
            assert bool((same[1:] > same[:-1]).all())


def test_supported_rule_and_splits():
    ok = dict(m=256, n_pad=8192, d=512, tile=4096, cand_c=64, k_tile=4)
    assert K.p1_fused_topk_supported(**ok)
    for bad in (dict(k_tile=2), dict(k_tile=64), dict(k_tile=12), dict(d=640),
                dict(d=192), dict(m=300), dict(m=0), dict(n_pad=6144),
                dict(tile=128), dict(cand_c=12), dict(cand_c=4),
                dict(cand_c=K.TOPK_MAX_C + 8)):
        assert not K.p1_fused_topk_supported(**{**ok, **bad}), bad
    assert K.p1_fused_topk_supported(**{**ok, "cand_c": K.TOPK_MAX_C})
    # 32 row blocks on 132 SMs: 4 splits fill a wave; 181 blocks: 8 splits
    assert K.topk_splits(4096, 569_344, 4096, 64, 132) == 4
    assert K.topk_splits(23_168, 569_344, 4096, 64, 132) == 8
    # never more splits than tiles, nor than TOPK_MAX_SPLITS
    assert K.topk_splits(128, 8192, 4096, 64, 132) == 2
    assert K.topk_splits(128, 569_344, 4096, 64, 132) == K.TOPK_MAX_SPLITS
    # a full wave of blocks, or wide lists past the byte cap: one split
    assert K.topk_splits(132 * 128, 569_344, 4096, 64, 132) == 1
    assert K.topk_splits(65_536, 569_344, 4096, 4096, 132) == 1


@pytest.mark.parametrize("k_tile", [2, 4, 8, 16, 32, 64])
def test_rule_opens_k_tile_4_to_32_on_the_card(k_tile, monkeypatch):
    args = (k_tile, 0.78, 256, 8192, 512, 4096, 64)
    assert not M.use_fused_topk(CPU, *args)
    monkeypatch.setattr(M, "_on_card", lambda device: True)
    assert M.use_fused_topk(CPU, *args) == (4 <= k_tile <= 32)
    monkeypatch.setenv("SG_TPU_FUSED", "0")
    assert not M.use_fused_topk(CPU, *args)
    monkeypatch.delenv("SG_TPU_FUSED")
    assert not M.use_fused_topk(CPU, k_tile, float("-inf"), *args[2:])
    assert not M.use_fused_topk(CPU, k_tile, 0.78, 300, *args[3:])


@pytest.fixture(scope="module")
def ell():
    return TfidfEncoder(StringGrouperConfig()).fit_transform(
        synthetic_company_names(4096)).wait_ready()


@pytest.mark.parametrize("k_tile", [4, 16, 32])
def test_run_rows_routes_to_the_kernel(k_tile, ell, monkeypatch):
    """The site with the kernel's branch open on the CPU: k_tile 4-32 call
    ``p1_fused_topk`` on rows padded to 128-row blocks and count them;
    under ``SG_TPU_FUSED=0`` the torch-op body runs; the same pairs."""
    monkeypatch.setattr(M, "_on_card", lambda device: True)
    monkeypatch.delenv("SG_TPU_FUSED", raising=False)
    calls = []
    real = M.p1_fused_topk

    def spy(a_hash, *args, **kw):
        calls.append((a_hash.shape[0], kw["k_tile"], kw["cand_c"]))
        return real(a_hash, *args, **kw)

    monkeypatch.setattr(M, "p1_fused_topk", spy)
    thr = M.effective_threshold(0.8)
    rows = np.arange(0, 4096, 13, dtype=np.int64)  # 316 rows
    out = {}
    for fused in ("1", "0"):
        monkeypatch.setenv("SG_TPU_FUSED", fused)
        _, run_rows, _, _ = M._phase1_single(ell, ell, True, 128, 256, 256, CPU)
        stats = {}
        r, c, b = run_rows(rows, thr, 64, k_tile, stats=stats)
        order = np.lexsort((c, r))
        out[fused] = (r[order], c[order], stats.get("esc_kernel_rows", 0))
    assert calls == [(384, k_tile, 64)]
    assert out["1"][2] == len(rows) and out["0"][2] == 0
    np.testing.assert_array_equal(out["1"][0], out["0"][0])
    np.testing.assert_array_equal(out["1"][1], out["0"][1])
    assert len(out["1"][0]) > 0


def test_match_counts_kernel_rows_by_route(monkeypatch):
    """A whole self-join that escalates at k_tile >= 4: with the kernel's
    branch open, every row of those rungs counts in
    ``match.esc_kernel_rows``; a plain CPU fit counts 0 and launches
    nothing; the frames are equal."""
    s = pd.Series(synthetic_company_names(3000))
    kw = dict(device="cpu", left_chunk=256, right_tile=256)
    K.reset_launches()
    plain = sgt.StringGrouper(s, **kw).fit()
    t = plain.timings.seconds
    wide = {k: v for k, v in t.items()
            if k.startswith("match.esc_rows_r") and int(k.rsplit("kt", 1)[1]) >= 4}
    assert sum(wide.values()) > 0, t
    assert t["match.esc_kernel_rows"] == 0
    assert K.LAUNCHES["p1_fused_topk"] == 0
    monkeypatch.setattr(M, "_on_card", lambda device: True)
    routed = sgt.StringGrouper(s, **kw).fit()
    t2 = routed.timings.seconds
    assert t2["match.esc_kernel_rows"] == sum(
        v for k, v in t2.items()
        if k.startswith("match.esc_rows_r") and 4 <= int(k.rsplit("kt", 1)[1]) <= 32)
    assert t2["match.esc_kernel_rows"] > 0
    assert K.LAUNCHES["p1_fused_topk"] == 0  # CPU tensors: the plain version
    pd.testing.assert_frame_equal(routed.get_matches(), plain.get_matches())


def test_chip_smoke_spy_logs_the_jobs_and_restores(monkeypatch):
    """chip_smoke.py's phase-5 spy on the CPU (the kernel's branch open):
    every escalation job's route is logged under the call's label, the
    first ``p1_fused_topk`` job of each (call, k_tile, C) is kept, the
    matcher's names come back afterwards, and phase 2's comparison holds
    the wrapper's (here its plain version's) outputs on the kept rows
    with no row left over."""
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as CS

    monkeypatch.setattr(M, "_on_card", lambda device: True)
    rule, kernel = M.use_fused_topk, M.p1_fused_topk
    now, jobs, keep = ["self-join"], {}, {}
    restore = CS.spy_topk_jobs(M, now, jobs, keep, rows=256)
    try:
        g = sgt.StringGrouper(pd.Series(synthetic_company_names(3000)), device="cpu",
                              left_chunk=256, right_tile=256).fit()
    finally:
        restore()
    assert M.use_fused_topk is rule and M.p1_fused_topk is kernel
    t = g.timings.seconds
    routed = [j for j in jobs["self-join"] if j["kernel"]]
    assert routed and all(4 <= j["k_tile"] <= 32 for j in routed)
    assert sum(j["m_pad"] for j in routed) >= t["match.esc_kernel_rows"] > 0
    assert {k[1:] for k in keep} == {(j["k_tile"], j["cand_c"]) for j in routed}
    for (_, kt, cand_c), (a, b, thr, tile) in keep.items():
        got = K.p1_fused_topk(a, b, thr, tile=tile, cand_c=cand_c, k_tile=kt)
        want = K.p1_fused_topk_plain(a, b, thr, tile=tile, cand_c=cand_c, k_tile=kt)
        err, n_border = CS.compare_scan("p1_fused_topk", got[:4], want[:4], a, b, thr)
        assert err == 0.0 and n_border == 0
