"""The plain PyTorch versions of the port's two CUDA kernels against the
JAX package, on the CPU.

* ``p1_fused_closed2_plain`` against the Pallas ``p1_fused_closed2`` (in
  interpret mode, as tests/test_pallas_kernels.py runs it) and against the
  XLA tile body ``_ub_topk_scan(k_tile=2)``.  Inputs are dyadic (multiples
  of 2^-7, so every f32 sum of their bf16 products is exact in any order):
  counts, tmax, bound and the ship matrix must be EQUAL, not merely close.
* ``device_hash_codes_plain`` against ``_device_hash_codes`` on a real
  encoded corpus, packed and raw: tolerance 1 bf16 ulp per element (the
  two sum the window values in different orders before the bf16 round).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from string_grouper_tpu.config import StringGrouperConfig as JConfig
from string_grouper_tpu.corpus.tfidf import TfidfEncoder as JEncoder
from string_grouper_tpu.ops import matcher as JM
from string_grouper_tpu.ops.pallas_kernels import p1_fused_closed2 as j_fused
from string_grouper_tpu_torch.ops import kernels as K

from test_matcher import random_names


def dyadic_rows(m, n, d, seed=0, nnz=20, step=2.0 ** -7):
    """L2-normalized sparse rows rounded to multiples of ``step`` (exact in
    bf16), with planted exact duplicates for ties (tests/test_pallas_kernels
    .py ``_rand``).  Returns numpy float32 (a, b)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, d), np.float32)
    cols = rng.integers(0, d, size=(n, nnz))
    vals = rng.random((n, nnz)).astype(np.float32)
    np.put_along_axis(dense, cols, vals, axis=1)
    dense[1] = dense[0]
    dense[2] = dense[0]
    dense /= np.linalg.norm(dense, axis=1, keepdims=True) + 1e-9
    dense = (np.round(dense / step) * step).astype(np.float32)
    return dense[:m], dense


def truncation_rows(step=2.0 ** -7):
    """tests/test_pallas_kernels.py ``test_fused_truncation_bound`` input,
    rounded to dyadic values: 512 near-parallel rows."""
    rng = np.random.default_rng(3)
    d = 128
    base = rng.random(d).astype(np.float32)
    dense = base[None, :] * rng.uniform(0.9, 1.1, (512, 1)).astype(np.float32)
    dense += rng.random((512, d)).astype(np.float32) * 0.01
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    dense = (np.round(dense / step) * step).astype(np.float32)
    return dense[:256], dense


def _bf16_torch(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _bf16_jax(x):
    return jnp.asarray(x, jnp.bfloat16)


def _run_plain(a, b, thr, tile, cand_c):
    out = K.p1_fused_closed2(_bf16_torch(a), _bf16_torch(b), np.float32(thr),
                             tile=tile, cand_c=cand_c)
    return [np.asarray(x) for x in out]


def _run_jax_fused(a, b, thr, tile, cand_c):
    out = j_fused(_bf16_jax(a), _bf16_jax(b), jnp.float32(thr), tile=tile,
                  cand_c=cand_c, block_m=256, interpret=True)
    return [np.asarray(x) for x in out]


def _run_jax_xla(a, b, thr, tile, cand_c):
    bj = _bf16_jax(b)
    w_vals, w_cols, counts, tmax, bound = JM._ub_topk_scan(
        _bf16_jax(a), bj.reshape(-1, tile, bj.shape[1]), jnp.float32(thr),
        cand_c, 2,
    )
    ship = np.asarray(JM.finalize_ship(w_vals, w_cols))
    return ship, np.asarray(counts), np.asarray(tmax), np.asarray(bound)


def _assert_prefix(ship):
    valid = ship >= 0
    assert (valid[:, 1:] <= valid[:, :-1]).all()


@pytest.mark.parametrize("thr", [0.6, 0.85])
@pytest.mark.parametrize("m,n,tile,cand_c", [
    (256, 512, 256, 8),
    (512, 1024, 256, 16),
])
def test_p1_plain_equals_pallas_and_xla(m, n, tile, cand_c, thr):
    assert K.p1_fused_supported(m, n, 128, tile, cand_c)
    a, b = dyadic_rows(m, n, 128)
    ship, counts, tmax, bound, max_cnt = _run_plain(a, b, thr, tile, cand_c)
    j_ship, j_counts, j_tmax, j_bound, j_max = _run_jax_fused(a, b, thr, tile, cand_c)
    assert counts.any() and (tmax > 2).any()  # the closed form and its bound
    np.testing.assert_array_equal(counts, j_counts)
    np.testing.assert_array_equal(tmax, j_tmax)
    np.testing.assert_array_equal(bound, j_bound)
    np.testing.assert_array_equal(ship, j_ship)
    assert int(max_cnt) == int(j_max)
    x_ship, x_counts, x_tmax, x_bound = _run_jax_xla(a, b, thr, tile, cand_c)
    np.testing.assert_array_equal(counts, x_counts)
    np.testing.assert_array_equal(tmax, x_tmax)
    np.testing.assert_array_equal(bound, x_bound)
    for r in range(m):
        assert set(ship[r][ship[r] >= 0]) == set(x_ship[r][x_ship[r] >= 0]), r
    _assert_prefix(ship)


def test_p1_plain_empty_threshold():
    a, b = dyadic_rows(256, 512, 128)
    ship, counts, tmax, bound, max_cnt = _run_plain(a, b, 1e9, 256, 8)
    assert (counts == 0).all() and (tmax == 0).all()
    assert (ship == -1).all()
    assert int(max_cnt) == 0
    assert not np.isfinite(bound).any()


def test_p1_plain_truncation_bound():
    a, b = truncation_rows()
    ship, counts, tmax, bound, _ = _run_plain(a, b, 0.5, 256, 8)
    j_ship, j_counts, j_tmax, j_bound, _ = _run_jax_fused(a, b, 0.5, 256, 8)
    np.testing.assert_array_equal(counts, j_counts)
    np.testing.assert_array_equal(tmax, j_tmax)
    np.testing.assert_array_equal(bound, j_bound)
    np.testing.assert_array_equal(ship, j_ship)
    assert np.isfinite(bound).all()  # every row truncates here
    _assert_prefix(ship)


def test_p1_supported_shapes():
    assert K.p1_fused_supported(4096, 8192, 512, 4096, 64)
    assert not K.p1_fused_supported(4096, 8192, 1024, 4096, 64)  # smem
    assert not K.p1_fused_supported(128, 8192, 512, 4096, 64)
    assert not K.p1_fused_supported(4096, 8192, 512, 4096, 512)


# ------------------------------------------------------------- device hash
def _payload(strings):
    return JEncoder(JConfig()).fit_transform(strings).device_src


def _bf16_bits(x) -> np.ndarray:
    """bf16 bit patterns as int32 (monotonic for the non-negative h)."""
    f = np.asarray(x, dtype=np.float32)
    return (f.view(np.int32) >> 16).astype(np.int32)


def _assert_within_one_ulp(got, want):
    g = _bf16_bits(got)
    w = _bf16_bits(want)
    diff = np.abs(g - w)
    assert diff.max(initial=0) <= 1, f"max {diff.max()} bf16 ulp"
    return int((diff > 0).sum())


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dim", [512, 64])
def test_device_hash_plain_matches_jax(packed, dim):
    strings = random_names(300, seed=5) + ["x", "", "ab", "Hyper-Startup Inc."]
    src = _payload(strings)
    lens = src.row_lengths()
    width = max(src.ngram, -(-int(lens.max()) // 40) * 40)
    order = np.arange(len(lens), dtype=np.int32)
    if packed:
        codes = JM._fill_code_rows6(src, order, width)
        j_codes, t_codes, w = jnp.asarray(codes), torch.from_numpy(codes.view(np.int32)), width
    else:
        codes = JM._fill_code_rows(src, order, width)
        j_codes, t_codes, w = jnp.asarray(codes), torch.from_numpy(codes), None
    want = JM._device_hash_codes(
        j_codes, jnp.asarray(src.inv_norm), jnp.asarray(src.table_id),
        jnp.asarray(src.idf32), dim=dim, base=src.base, ngram=src.ngram,
        width=w,
    )
    got = K.device_hash_codes(
        t_codes, torch.from_numpy(src.inv_norm), torch.from_numpy(src.table_id),
        torch.from_numpy(src.idf32), dim, src.base, src.ngram, width=w,
    )
    assert got.dtype == torch.bfloat16 and got.shape == (len(lens), dim)
    want32 = np.asarray(want.astype(jnp.float32))
    got32 = got.float().numpy()
    assert (want32 > 0).any()
    _assert_within_one_ulp(got32, want32)


def test_device_hash_plain_short_width_is_zero():
    src = _payload(["ab", "cd", "abc"])
    order = np.arange(3, dtype=np.int32)
    codes = JM._fill_code_rows(src, order, 2)  # width 2 < ngram 3
    got = K.device_hash_codes(
        torch.from_numpy(codes), torch.from_numpy(src.inv_norm),
        torch.from_numpy(src.table_id), torch.from_numpy(src.idf32),
        64, src.base, src.ngram,
    )
    want = JM._device_hash_codes(
        jnp.asarray(codes), jnp.asarray(src.inv_norm),
        jnp.asarray(src.table_id), jnp.asarray(src.idf32), dim=64,
        base=src.base, ngram=src.ngram,
    )
    assert not got.float().any()
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_wrappers_take_plain_version_on_cpu_and_count_nothing():
    K.reset_launches()
    a, b = dyadic_rows(256, 512, 128)
    K.p1_fused_closed2(_bf16_torch(a), _bf16_torch(b), 0.6, tile=256, cand_c=8)
    src = _payload(["hyper startup inc", "mega corp"])
    codes = JM._fill_code_rows(src, np.arange(2, dtype=np.int32), 24)
    K.device_hash_codes(
        torch.from_numpy(codes), torch.from_numpy(src.inv_norm),
        torch.from_numpy(src.table_id), torch.from_numpy(src.idf32),
        64, src.base, src.ngram,
    )
    at, bt = _bf16_torch(a), _bf16_torch(b)
    K.p1_fused_chain(at, bt, 0.6, 0, K.p1_chain_init(256, 8), tile=256, cand_c=8)
    K.p1_tri_fused(bt[:256], bt, K.tri_future_init(512), 0, 0.6, tile=256,
                   cand_c=8, block_m=128)
    K.p1_mm_floor(at, bt, 0.6)
    K.p1_closed2_variant(at, bt, 0.6, tile=256, cand_c=8, block_rows=64,
                         argmax="minidx")
    assert K.LAUNCHES == {"p1_fused_closed2": 0, "p1_fused_chain": 0,
                          "p1_tri_fused": 0, "device_hash_codes": 0,
                          "p1_mm_floor": 0, "p1_closed2_variant": 0}


@pytest.mark.parametrize("err,words", [
    (0, None),
    (1, "cudaError_t 1"),                    # a refused launch
    (10000, "CUresult 0"),                   # no driver entry point
    (10001, "CUresult 1"),                   # cuTensorMapEncodeTiled refused
])
def test_build_check_names_the_failure(err, words):
    from string_grouper_tpu_torch.ops import _build

    if words is None:
        _build.check("p1_fused_closed2", err)
        return
    with pytest.raises(RuntimeError, match=words):
        _build.check("p1_fused_closed2", err)
