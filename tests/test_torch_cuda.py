"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips without them.  This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: ``p1_fused_closed2`` on dyadic inputs (every f32 sum of the
bf16 products is exact in any order) must EQUAL its plain version;
``device_hash_codes`` must be within 1 bf16 ulp of its plain version (which
on the card sums by atomics in no fixed order) and bitwise repeatable.
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


@pytest.mark.parametrize("dim", [512, 4096])  # 4096: > 48 KB of histograms
def test_device_hash_kernel_within_one_ulp(dev, dim):
    src = TfidfEncoder(StringGrouperConfig()).fit_transform(
        synthetic_company_names(5000)
    ).device_src
    n = len(src.inv_norm)
    width = -(-int(src.row_lengths().max()) // 40) * 40
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
        assert int(ulp.max()) <= 1


def test_match_strings_card_equals_cpu(dev):
    s = pd.Series(synthetic_company_names(3000, seed=5))
    K.reset_launches()
    card = sgt.match_strings(s)
    assert all(v > 0 for v in K.LAUNCHES.values()), K.LAUNCHES
    pd.testing.assert_frame_equal(card, sgt.match_strings(s, device="cpu"))


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


def test_match_strings_cross_join_card_equals_cpu(dev):
    master = pd.Series(synthetic_company_names(3000, seed=11))
    dupes = pd.Series(synthetic_company_names(2000, seed=12))
    K.reset_launches()
    card = sgt.match_strings(master, dupes, min_similarity=0.7)
    assert all(v > 0 for v in K.LAUNCHES.values()), K.LAUNCHES
    cpu = sgt.match_strings(master, dupes, min_similarity=0.7, device="cpu")
    pd.testing.assert_frame_equal(card, cpu)
