"""The plain PyTorch versions of the epilogue A/B kernels against the JAX
package, on the CPU.

``p1_mm_floor_plain`` and ``p1_closed2_variant_plain`` are the port's twins
of the Pallas A/B probes ``mm_floor`` and ``variant``
(benchmarks/ab_p1_epilogue.py:65-88, :160-200).  The probe module itself
cannot be imported: at import time it allocates 32,768 x 663,552 arrays on
the default device and times three kernels on them.  Its own check says
what the twins must meet: ``variant`` (either body, any ``bm``) reproduces
``p1_fused_closed2`` (``identical=``, :209, :213), and ``mm_floor`` computes
its ``counts``.  So both twins are held EQUAL to the Pallas
``p1_fused_closed2`` in interpret mode (as tests/test_pallas_kernels.py runs
it) on the dyadic inputs of tests/test_torch_kernels.py (every f32 sum of
their bf16 products is exact in any order), whose planted duplicate rows
give exact ties, where the first argmax and the smallest index among the
maxima could part.
"""

import numpy as np
import pytest
import torch

from string_grouper_tpu_torch.ops import kernels as K

from test_torch_kernels import _bf16_torch, _run_jax_fused, dyadic_rows

N, TILE = 1024, 256


@pytest.mark.parametrize("cand_c", [8, 64])
@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("m", [256, 512])
def test_floor_and_variants_equal_pallas_closed2(m, d, cand_c):
    thr = 0.5
    a, b = dyadic_rows(m, N, d, seed=m + d)
    want = _run_jax_fused(a, b, thr, TILE, cand_c)
    j_ship, j_counts, j_tmax, j_bound, j_max = want
    assert (j_tmax > 2).any()  # the planted ties: a tile with 3 equal maxima
    at, bt = _bf16_torch(a), _bf16_torch(b)
    np.testing.assert_array_equal(K.p1_mm_floor_plain(at, bt, thr).numpy(), j_counts)
    for block_rows in K.VARIANT_BLOCK_ROWS:
        for argmax in K.VARIANT_ARGMAX:
            got = K.p1_closed2_variant_plain(at, bt, thr, TILE, cand_c,
                                             block_rows, argmax)
            ship, counts, tmax, bound, max_cnt = [np.asarray(x) for x in got]
            np.testing.assert_array_equal(ship, j_ship)
            np.testing.assert_array_equal(counts, j_counts)
            np.testing.assert_array_equal(tmax, j_tmax)
            np.testing.assert_array_equal(bound, j_bound)
            assert int(max_cnt) == int(j_max)


def test_minidx_takes_the_smallest_column_of_a_tie():
    """Rows 0, 1 and 2 are equal, so row 0's tile holds three equal
    maxima (columns 0, 1, 2): both rules ship column 0 first, then the
    index-sum column of the pair (none here: 3 > 2 qualified)."""
    a, b = dyadic_rows(256, 512, 128)
    at, bt = _bf16_torch(a), _bf16_torch(b)
    s = at.float() @ bt[:256].float().T
    first = K._tile_top2(s, 0.99, 1)
    minidx = K._tile_top2(s, 0.99, 1, minidx=True)
    for x, y in zip(first, minidx):
        assert torch.equal(x, y)
    assert int(first[0][0]) == 3 and int(first[3][0]) == 0
    empty = K._tile_top2(s, 2.0, 1, minidx=True)
    assert (empty[3] == 0).all() and torch.isneginf(empty[2]).all()


def test_wrappers_on_cpu_take_the_plain_versions():
    a, b = dyadic_rows(256, 512, 128)
    at, bt = _bf16_torch(a), _bf16_torch(b)
    want = K.p1_fused_closed2_plain(at, bt, 0.6, 256, 8)
    assert torch.equal(K.p1_mm_floor(at, bt, 0.6), want[1])
    got = K.p1_closed2_variant(at, bt, 0.6, 256, 8, 64, "minidx")
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [dict(block_rows=256), dict(block_rows=32),
                                dict(argmax="last"), dict(argmax="min")])
def test_variant_rejects_unknown_switches(kw):
    a, b = dyadic_rows(256, 512, 128)
    with pytest.raises(ValueError, match="block_rows must be one of"):
        K.p1_closed2_variant(_bf16_torch(a), _bf16_torch(b), 0.6, 256, 8, **kw)


def test_floor_supported_shapes():
    assert K.p1_mm_floor_supported(32_768, 663_552, 512)
    assert K.p1_mm_floor_supported(300, 256, 128)  # ragged rows
    assert not K.p1_mm_floor_supported(256, 384, 512)  # half a pair of sub-blocks
    assert not K.p1_mm_floor_supported(256, 512, 1024)  # A's rows past shared memory
    assert not K.p1_mm_floor_supported(256, 512, 192)
