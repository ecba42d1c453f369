"""The plain PyTorch versions of the chained and the triangular phase-1
kernels against the JAX package's Pallas kernels (interpret mode), on the
CPU.

Inputs are dyadic (multiples of 2^-7, exact in bf16, so every f32 sum of
their products is exact in any order): every output must be BITWISE equal,
including the column ids the running buffers carry in -inf slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from string_grouper_tpu.ops.pallas_kernels import (
    p1_chain_init as j_chain_init,
    p1_fused_chain as j_chain,
    p1_tri_fused as j_tri,
    tri_future_init as j_tri_init,
)
from string_grouper_tpu_torch.ops import kernels as K

STEP = 2.0 ** -7


def _dyadic(x):
    return (np.round(x / STEP) * STEP).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


# ------------------------------------------------------------------ chain
def chain_inputs():
    """tests/test_pallas_kernels.py ``test_chained_passes_equal_single_pass``
    input, rounded to dyadic values: unequal tile-aligned chunks and
    planted ties within and across chunks."""
    rng = np.random.default_rng(11)
    m, d = 512, 128
    n_chunks = [1024, 768, 512]
    a = _dyadic(rng.random((m, d)) * 0.15)
    bf = rng.random((sum(n_chunks), d)) * 0.15
    bf[100] = bf[50]
    bf[1300] = bf[50]  # cross-chunk tie
    bf[2000] = bf[701]
    return a, _dyadic(bf), n_chunks


@pytest.mark.parametrize("thr,cand_c", [(0.8, 16), (0.7, 8)])
def test_chain_plain_equals_jax_every_chunk(thr, cand_c):
    a, b, n_chunks = chain_inputs()
    tile = 256
    starts = np.concatenate(([0], np.cumsum(n_chunks)))
    j_st = j_chain_init(a.shape[0], cand_c)
    t_st = K.p1_chain_init(a.shape[0], cand_c)
    aj, at = jnp.asarray(a, jnp.bfloat16), _bf16(a)
    hits = 0
    for k in range(len(n_chunks)):
        lo, hi = int(starts[k]), int(starts[k + 1])
        j_out = j_chain(aj, jnp.asarray(b[lo:hi], jnp.bfloat16), jnp.float32(thr),
                        lo, *j_st, tile=tile, cand_c=cand_c, block_m=256,
                        interpret=True)
        j_st = j_out[5:]
        t_out = K.p1_fused_chain(at, _bf16(b[lo:hi]), np.float32(thr), lo,
                                 t_st, tile=tile, cand_c=cand_c)
        assert t_out[5] is t_st  # the state is updated in place
        for name, t, j in zip(("ship", "counts", "tmax", "bound", "max_cnt"),
                              t_out[:5], j_out[:5]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"chunk {k} {name}")
        v, c, meta, tb = (x.numpy() for x in t_st)
        j_v, j_c, j_meta = (np.asarray(x) for x in j_st)
        np.testing.assert_array_equal(v, j_v, err_msg=f"chunk {k} v")
        np.testing.assert_array_equal(c, j_c, err_msg=f"chunk {k} c")
        np.testing.assert_array_equal(meta, j_meta[:, :3].astype(np.int32),
                                      err_msg=f"chunk {k} meta")
        np.testing.assert_array_equal(tb, j_meta[:, 3], err_msg=f"chunk {k} tb")
        hits = int(meta[:, 0].sum())
    assert hits > 0 and (t_out[2].numpy() > 2).any()  # closed form + bound


def test_chain_plain_equals_one_pass():
    a, b, n_chunks = chain_inputs()
    at = _bf16(a)
    single = K.p1_fused_closed2_plain(at, _bf16(b), 0.8, 256, 16)
    st = K.p1_chain_init(a.shape[0], 16)
    lo = 0
    for nc in n_chunks:
        out = K.p1_fused_chain_plain(at, _bf16(b[lo:lo + nc]), 0.8, lo, st,
                                     256, 16)
        lo += nc
    for name, g, w in zip(("ship", "counts", "tmax", "bound", "max_cnt"),
                          out[:5], single):
        assert torch.equal(g, w), name


# --------------------------------------------------------------- triangle
TRI_N, TRI_D, TRI_TILE, TRI_BM, TRI_CPG = 512, 128, 128, 64, 2


def tri_inputs():
    """tests/test_matcher.py ``test_triangular_kernel_candidate_
    completeness`` input, rounded to dyadic values."""
    rng = np.random.default_rng(0)
    h = rng.random((TRI_N, TRI_D)) * (rng.random((TRI_N, TRI_D)) < 0.05)
    h /= np.maximum(np.linalg.norm(h, axis=1, keepdims=True), 1e-9)
    return _dyadic(h)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.int32)


@pytest.mark.parametrize("thr,cand_c", [(0.15, 16), (0.05, 8)])
def test_tri_plain_equals_jax_every_segment(thr, cand_c):
    h = tri_inputs()
    seg_rows = TRI_CPG * TRI_TILE
    bj, bt = jnp.asarray(h, jnp.bfloat16), _bf16(h)
    j_f = j_tri_init(TRI_N)
    t_f = K.tri_future_init(TRI_N)
    np.testing.assert_array_equal(_bits(t_f.numpy()), _bits(j_f))
    for s in range(TRI_N // seg_rows):
        j0 = s * TRI_CPG
        rows = slice(s * seg_rows, (s + 1) * seg_rows)
        j_rv, j_rc, j_rm, j_f = j_tri(
            bj[rows], bj, j_f, jnp.int32(j0), jnp.float32(thr),
            tile=TRI_TILE, cand_c=cand_c, block_m=TRI_BM, interpret=True,
        )
        rv, rc, rm, t_f2 = K.p1_tri_fused(
            bt[rows], bt, t_f, j0, np.float32(thr), tile=TRI_TILE,
            cand_c=cand_c, block_m=TRI_BM,
        )
        assert t_f2 is t_f  # updated in place
        np.testing.assert_array_equal(rv.numpy(), np.asarray(j_rv), err_msg=f"seg {s} rv")
        np.testing.assert_array_equal(rc.numpy(), np.asarray(j_rc), err_msg=f"seg {s} rc")
        np.testing.assert_array_equal(rm.numpy(), np.asarray(j_rm), err_msg=f"seg {s} rmeta")
        np.testing.assert_array_equal(_bits(t_f.numpy()), _bits(j_f),
                                      err_msg=f"seg {s} fpack")
    fv, fc, fm = K.tri_future_unpack(t_f)
    assert (fm[:, 0] > 0).any() and (fv > -np.inf).any()  # column side ran
    assert fc.dtype == torch.int32


@pytest.mark.parametrize("thr,cand_c", [(0.15, 16), (0.05, 8)])
def test_tri_plain_candidate_completeness(thr, cand_c):
    """Per segment, the row side plus the segment rows' future state
    (accumulated by earlier segments) cover every qualified column or bound
    it, with exact counts and per-tile maxima (the port's copy of
    tests/test_matcher.py ``test_triangular_kernel_candidate_
    completeness``)."""
    h = tri_inputs()
    n, tile, cpg = TRI_N, TRI_TILE, TRI_CPG
    nt = n // tile
    seg_rows = cpg * tile
    b = _bf16(h)
    S = b.float().numpy() @ b.float().numpy().T
    fpack = K.tri_future_init(n)
    segs = []
    for s in range(nt // cpg):
        rv, rc, rme, fpack = K.p1_tri_fused(
            b[s * seg_rows:(s + 1) * seg_rows], b, fpack, s * cpg, thr,
            tile=tile, cand_c=cand_c, block_m=TRI_BM,
        )
        fv, fc, fme = (x.numpy().copy() for x in K.tri_future_unpack(fpack))
        rows = slice(s * seg_rows, (s + 1) * seg_rows)
        segs.append((rv.numpy(), rc.numpy(), rme.numpy(), fv[rows], fc[rows],
                     fme[rows]))
    for s, (rv, rc, rme, sfv, sfc, sfme) in enumerate(segs):
        for r_loc in range(seg_rows):
            r = s * seg_rows + r_loc
            qual = np.flatnonzero(S[r] >= thr)
            vs = np.concatenate([rv[r_loc], sfv[r_loc]])
            cs = np.concatenate([rc[r_loc], sfc[r_loc]])
            fin = vs > -np.inf
            got = set(cs[fin].tolist())
            assert rme[r_loc, 0] + sfme[r_loc, 0] == len(qual)
            nfin = rme[r_loc, 3] + sfme[r_loc, 3]
            ms = np.sort(vs[fin])[::-1]
            trunc = (ms[cand_c - 1] if nfin > cand_c and len(ms) >= cand_c
                     else -np.inf)
            bound = max(rme[r_loc, 2], sfme[r_loc, 2], trunc)
            for c in set(qual.tolist()) - got:
                assert S[r, c] <= bound + 1e-6, (r, c, S[r, c], bound)
            per_tile = (S[r].reshape(nt, tile) >= thr).sum(axis=1)
            assert max(rme[r_loc, 1], sfme[r_loc, 1]) == per_tile.max()


def test_tri_supported_shapes():
    assert K.p1_tri_supported(65536, 499712, 512, 4096, 64, 512)
    assert not K.p1_tri_supported(65536, 499712, 512, 4096, 64, 64)  # chunks
    assert not K.p1_tri_supported(4096 + 2048, 65536, 512, 4096, 64)  # tiles
    assert not K.p1_tri_supported(4096, 1 << 24, 512, 4096, 64)  # f32 counts
    assert K.p1_tri_supported(4096, 8192, 1024, 4096, 64)  # A streams
    assert not K.p1_tri_supported(4096, 8192, 192, 4096, 64)  # lanes
