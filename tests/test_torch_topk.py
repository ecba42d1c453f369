"""``p1_fused_topk`` on the card against its plain PyTorch version, and the
escalation that runs it.

Needs an NVIDIA GPU and nvcc; skips without them.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_topk.py

On dyadic inputs (every f32 sum of the bf16 products is exact in any
order) the kernel must EQUAL its plain version bitwise: the candidate
matrix (-1 where the running value is -inf), counts, tmax, bound and
max_cnt -- at k_tile 4, 8, 16 and 32, top-C widths up to ``TOPK_MAX_C``,
one split and several, on tiles that overflow k_tile, rows truncated at C,
duplicate right rows (ties take the first column) and rows with nothing
qualified.  A 20,000-name self-join that escalates at k_tile >= 4 must give
the CPU's frame, launch the kernel and count every row of those rungs in
``match.esc_kernel_rows``; under ``SG_TPU_FUSED=0`` it launches none and
gives the same frame.  The wrapper raises on shapes it does not take.
"""

import pandas as pd
import pytest
import torch

import string_grouper_tpu_torch as sgt
from string_grouper_tpu_torch.ops import _build
from string_grouper_tpu_torch.ops import kernels as K
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

from test_torch_topk_plain import topk_rows

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


def _check(dev, m, n, d, tile, cand_c, k_tile, thr, seed=0, splits=None,
           monkeypatch=None):
    a, b = topk_rows(m, n, d, seed=seed)
    if splits is not None:
        monkeypatch.setattr(K, "topk_splits", lambda *args: splits)
    before = K.LAUNCHES["p1_fused_topk"]
    got = K.p1_fused_topk(a.to(dev), b.to(dev), thr, tile=tile, cand_c=cand_c,
                          k_tile=k_tile)
    torch.cuda.synchronize()
    assert K.LAUNCHES["p1_fused_topk"] == before + 1
    want = K.p1_fused_topk_plain(a, b, thr, tile=tile, cand_c=cand_c,
                                 k_tile=k_tile)
    for name, g, w in zip(("ship", "counts", "tmax", "bound", "max_cnt"), got, want):
        assert torch.equal(g.cpu(), w), name
    counts, tmax = want[1], want[2]
    assert int((tmax > k_tile).sum()) > 0        # tiles that overflow k_tile
    assert int((counts[2:10] != 0).sum()) == 0   # rows with nothing qualified
    return want


@pytest.mark.parametrize("cand_c", [8, 64, 1024, K.TOPK_MAX_C])
@pytest.mark.parametrize("k_tile", K.TOPK_WIDTHS)
def test_topk_kernel_equals_plain(dev, k_tile, cand_c):
    _check(dev, 256, 4096, 128, 256, cand_c, k_tile, 0.5, seed=k_tile)


@pytest.mark.parametrize("m,n,d,tile,cand_c,k_tile,splits", [
    (384, 8192, 512, 4096, 64, 4, 1),      # the default tile and width
    (384, 8192, 512, 4096, 64, 4, 2),      # two splits of one tile each
    (256, 8192, 384, 1024, 256, 16, 8),    # 8 splits, 1 tile each
    (128, 4096, 512, 256, 24, 32, 16),     # one row block, 16 splits
    (512, 6144, 256, 512, 128, 8, 3),      # 12 tiles over 3 splits
])
def test_topk_kernel_splits_equal_plain(dev, monkeypatch, m, n, d, tile,
                                        cand_c, k_tile, splits):
    _check(dev, m, n, d, tile, cand_c, k_tile, 0.5, seed=m + splits,
           splits=splits, monkeypatch=monkeypatch)


def test_topk_kernel_ties_take_first_column(dev):
    """Many duplicate right rows: equal scores held by different lanes,
    quads, warps, tiles and splits come out in column order."""
    a, b = topk_rows(256, 8192, 256, seed=11)
    got = K.p1_fused_topk(a.to(dev), b.to(dev), 0.5, tile=1024, cand_c=512,
                          k_tile=32)
    want = K.p1_fused_topk_plain(a, b, 0.5, tile=1024, cand_c=512, k_tile=32)
    assert torch.equal(got[0].cpu(), want[0])
    s = a.float() @ b.float().T
    cols = want[0][0][want[0][0] >= 0]
    vals = s[0, cols.long()]
    assert int((vals[1:] == vals[:-1]).sum()) > 0
    assert bool(((vals[1:] < vals[:-1]) | (cols[1:] > cols[:-1])).all())


def _esc_rows(timings, lo=4, hi=32):
    return sum(v for k, v in timings.items() if k.startswith("match.esc_rows_r")
               and lo <= int(k.rsplit("kt", 1)[1]) <= hi)


def test_match_strings_escalates_on_the_kernel(dev, monkeypatch):
    """20,000 clustered names: escalation at k_tile >= 4 runs on the kernel
    (every such row counted), the CPU's frame; under ``SG_TPU_FUSED=0``
    no launch and the same frame."""
    s = pd.Series(synthetic_company_names(20000, seed=3))
    K.reset_launches()
    card = sgt.StringGrouper(s).fit()
    t = card.timings.seconds
    assert K.LAUNCHES["p1_fused_topk"] > 0, K.LAUNCHES
    assert _esc_rows(t) > 0, t
    assert t["match.esc_kernel_rows"] == _esc_rows(t)
    want = sgt.StringGrouper(s, device="cpu").fit().get_matches()
    pd.testing.assert_frame_equal(card.get_matches(), want)
    monkeypatch.setenv("SG_TPU_FUSED", "0")
    K.reset_launches()
    off = sgt.StringGrouper(s).fit()
    assert K.LAUNCHES["p1_fused_topk"] == 0, K.LAUNCHES
    assert off.timings.seconds["match.esc_kernel_rows"] == 0
    pd.testing.assert_frame_equal(off.get_matches(), want)


def test_topk_raises_on_unsupported_cuda_shapes(dev):
    b = torch.zeros((1024, 128), dtype=torch.bfloat16, device=dev)
    for kw in (dict(k_tile=2), dict(k_tile=64), dict(cand_c=12),
               dict(cand_c=K.TOPK_MAX_C + 8), dict(tile=128)):
        with pytest.raises(ValueError):
            K.p1_fused_topk(b[:256], b, 0.5, **{"tile": 256, "cand_c": 8,
                                                "k_tile": 4, **kw})
    with pytest.raises(ValueError):  # not whole 128-row blocks
        K.p1_fused_topk(b[:100], b, 0.5, tile=256, cand_c=8, k_tile=4)
    with pytest.raises(ValueError):  # half a tile of columns
        K.p1_fused_topk(b[:256], b[:384], 0.5, tile=256, cand_c=8, k_tile=4)
    with pytest.raises(TypeError):
        K.p1_fused_topk(b[:256].float(), b, 0.5, tile=256, cand_c=8, k_tile=4)
    wide = torch.zeros((1024, 1024), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # A resident only: d <= 512
        K.p1_fused_topk(wide[:256], wide, 0.5, tile=256, cand_c=8, k_tile=4)
