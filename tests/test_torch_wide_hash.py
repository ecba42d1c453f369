"""The phase-1 scan at hash widths past 512 (``hash_dim`` 768 ... 32768),
port against the JAX package, on the CPU.

The JAX package runs its Pallas scan at every ``d % 128 == 0``
(``p1_fused_supported``, string_grouper_tpu/ops/pallas_kernels.py:729-743);
so does the port's CUDA scan, which streams A through its ring past
d = 512.  Here the port's plain versions (what the kernels are held to on
the card) meet the Pallas kernels in interpret mode at d = 640, 768 and
1024, with one pair of 128-column sub-blocks and with a ragged row block
of 100, on dyadic rows (multiples of 2^-9 below 1/2: exact in bf16, and
every f32 sum of their products is exact in any order), so every output
must be BITWISE equal.  Then ``match_strings(..., hash_dim=1024)``: the port on the CPU
against JAX on the CPU, exactly, without a mesh and on a (2, 2) virtual
mesh, and with the fused branches opened on the CPU (``_on_card`` patched)
so that the matcher's own rule sends the scan through the kernel wrappers
at that width: the single-device scan, the mesh tier and the slots of the
multi-process sharded tier.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import string_grouper_tpu as sgj
import string_grouper_tpu_torch as sgt
from string_grouper_tpu import parallel as JP
from string_grouper_tpu.ops.pallas_kernels import (
    p1_chain_init as j_chain_init,
    p1_fused_chain as j_chain,
    p1_fused_closed2 as j_fused,
    p1_tri_fused as j_tri,
    tri_future_init as j_tri_init,
)
from string_grouper_tpu_torch import parallel as TP
from string_grouper_tpu_torch.ops import kernels as K
from string_grouper_tpu_torch.ops import matcher as M
from string_grouper_tpu_torch.parallel import distributed as D

from test_matcher import random_names
from test_reference_conformance import SimpleExample
from test_torch_api import assert_same

STEP = 2.0 ** -9
NAMES = SimpleExample().customers_df["Customer Name"]


def cluster_rows(n, d, seed, k=12, noise=0.6):
    """n L2-normalised rows around k random centres, rounded to multiples
    of STEP: many qualified columns per tile (ties, tmax > 2, top-C
    truncation), exact in bf16 (every |x| < 1/2 has at most 8 significant
    bits), planted duplicates within and across chunks."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, d))
    x = centres[rng.integers(0, k, n)] + noise * rng.standard_normal((n, d))
    x[1] = x[0]
    x[n // 2 + 3] = x[0]
    x[n - 1] = x[5]
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x = np.round(x / STEP) * STEP
    assert np.abs(x).max() < 0.5
    return x.astype(np.float32)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.int32)


def _tj(x):
    return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)


# ------------------------------------------------------------------ closed
@pytest.mark.parametrize("m,n,d", [
    (256, 1024, 768),
    (256, 1024, 1024),
    (256, 1024, 640),  # 10 k blocks of 64 (5 of 128)
    (256, 256, 1024),  # one tile of 256: a single pair of 128-column sub-blocks
    (100, 1024, 768),  # one ragged row block (the card's cluster peer has no rows)
])
@pytest.mark.parametrize("thr,cand_c", [(0.5, 8), (0.3, 16)])
def test_closed2_plain_equals_pallas_wide(m, n, d, thr, cand_c):
    b = cluster_rows(n, d, seed=d)
    (at, aj), (bt, bj) = _tj(b[:m]), _tj(b)
    # the wrapper's shape rule (JAX's) wants m >= 256; the card tests lift it
    assert m < 256 or K.p1_fused_supported(m, n, d, 256, cand_c)
    got = K.p1_fused_closed2(at, bt, np.float32(thr), tile=256, cand_c=cand_c)
    want = j_fused(aj, bj, jnp.float32(thr), tile=256, cand_c=cand_c,
                   block_m=256, interpret=True)
    for name, g, w in zip(("ship", "counts", "tmax", "bound", "max_cnt"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    tmax, bound = got[2].numpy(), got[3].numpy()
    assert (tmax > 2).any() and np.isfinite(bound).any()  # bound and truncation


# ------------------------------------------------------------------- chain
@pytest.mark.parametrize("thr,cand_c", [(0.5, 8), (0.3, 16)])
def test_chain_plain_equals_pallas_at_1024(thr, cand_c):
    d, n_chunks = 1024, [512, 256, 256]
    b = cluster_rows(sum(n_chunks), d, seed=7)
    (at, aj) = _tj(b[:256])
    starts = np.concatenate(([0], np.cumsum(n_chunks)))
    j_st = j_chain_init(256, cand_c)
    t_st = K.p1_chain_init(256, cand_c)
    for k in range(len(n_chunks)):
        lo, hi = int(starts[k]), int(starts[k + 1])
        bt, bj = _tj(b[lo:hi])
        j_out = j_chain(aj, bj, jnp.float32(thr), lo, *j_st, tile=256,
                        cand_c=cand_c, block_m=256, interpret=True)
        j_st = j_out[5:]
        t_out = K.p1_fused_chain(at, bt, np.float32(thr), lo, t_st, tile=256,
                                 cand_c=cand_c)
        for name, t, j in zip(("ship", "counts", "tmax", "bound", "max_cnt"),
                              t_out[:5], j_out[:5]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=f"chunk {k} {name}")
        v, c, meta, tb = (x.numpy() for x in t_st)
        j_v, j_c, j_meta = (np.asarray(x) for x in j_st)
        np.testing.assert_array_equal(v, j_v, err_msg=f"chunk {k} v")
        np.testing.assert_array_equal(c, j_c, err_msg=f"chunk {k} c")
        np.testing.assert_array_equal(meta, j_meta[:, :3].astype(np.int32))
        np.testing.assert_array_equal(tb, j_meta[:, 3])
    one = K.p1_fused_closed2(at, _tj(b)[0], np.float32(thr), 256, cand_c)
    for name, g, w in zip(("ship", "counts", "tmax", "bound", "max_cnt"),
                          t_out[:5], one):
        assert torch.equal(g, w), ("chained != one pass", name)
    assert (t_out[2].numpy() > 2).any()


# ---------------------------------------------------------------- triangle
@pytest.mark.parametrize("thr,cand_c", [(0.5, 8), (0.3, 16)])
def test_tri_plain_equals_pallas_at_1024(thr, cand_c):
    n, d, tile, bm, cpg = 512, 1024, 128, 64, 2
    h = cluster_rows(n, d, seed=3)
    bt, bj = _tj(h)
    seg_rows = cpg * tile
    j_f = j_tri_init(n)
    t_f = K.tri_future_init(n)
    for s in range(n // seg_rows):
        j0 = s * cpg
        rows = slice(s * seg_rows, (s + 1) * seg_rows)
        j_rv, j_rc, j_rm, j_f = j_tri(
            bj[rows], bj, j_f, jnp.int32(j0), jnp.float32(thr),
            tile=tile, cand_c=cand_c, block_m=bm, interpret=True,
        )
        rv, rc, rm, _ = K.p1_tri_fused(bt[rows], bt, t_f, j0, np.float32(thr),
                                       tile=tile, cand_c=cand_c, block_m=bm)
        np.testing.assert_array_equal(rv.numpy(), np.asarray(j_rv), err_msg=f"seg {s} rv")
        np.testing.assert_array_equal(rc.numpy(), np.asarray(j_rc), err_msg=f"seg {s} rc")
        np.testing.assert_array_equal(rm.numpy(), np.asarray(j_rm), err_msg=f"seg {s} rmeta")
        np.testing.assert_array_equal(_bits(t_f.numpy()), _bits(j_f),
                                      err_msg=f"seg {s} fpack")
    fv, _fc, fm = K.tri_future_unpack(t_f)
    assert (fm[:, 0] > 0).any() and (fm[:, 1] > 2).any()  # the column side ran


# --------------------------------------------------------------- predicates
def test_use_fused_at_1024_on_the_card_only():
    """The default 663k self-join's segment (73,728 rows against 589,824
    padded columns, tile 4096, C 64) at hash_dim 1024: the kernel on a CUDA
    device, the torch-op body on the CPU; the epilogue probes keep d <= 512."""
    thr = float(M.effective_threshold(0.8))
    args = (2, thr, 73_728, 589_824, 1024, 4096, 64)
    assert M.use_fused(torch.device("cuda"), *args)
    assert not M.use_fused(torch.device("cpu"), *args)
    assert M.use_fused(torch.device("cuda"), 2, thr, 256, 589_824, 32_768, 4096, 64)
    assert not K.p1_closed2_variant_supported(256, 4096, 1024, 4096, 64)
    assert K.p1_closed2_variant_supported(256, 4096, 512, 4096, 64)
    assert not K.p1_mm_floor_supported(256, 4096, 1024)


# --------------------------------------------------------------------- API
WIDE_CASES = {
    "conformance": ((NAMES,), dict(min_similarity=0.6)),
    "conformance_cross": (
        (NAMES, SimpleExample().customers_df2["Customer Name"]), dict(min_similarity=0.5)),
    "random_300": ((pd.Series(random_names(300, seed=41)),), dict(min_similarity=0.5)),
}


@pytest.mark.parametrize("hash_dim", [1024, 2048])
@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_match_strings_wide_hash_equals_jax(case, hash_dim):
    args, kw = WIDE_CASES[case]
    want = sgj.match_strings(*args, hash_dim=hash_dim, **kw)
    got = sgt.match_strings(*args, hash_dim=hash_dim, device="cpu", **kw)
    assert_same(got, want)
    assert_same(got, sgt.match_strings(*args, device="cpu", **kw))  # any width is exact


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_match_strings_wide_hash_under_mesh_equals_jax(case):
    args, kw = WIDE_CASES[case]
    t_mesh, j_mesh = TP.make_mesh(4, dp=2, device="cpu"), JP.make_mesh(4, dp=2)
    got = sgt.match_strings(*args, hash_dim=1024, device="cpu", mesh=t_mesh, **kw)
    assert_same(got, sgj.match_strings(*args, hash_dim=1024, mesh=j_mesh, **kw))
    assert_same(got, sgt.match_strings(*args, hash_dim=1024, device="cpu", **kw))


@pytest.fixture
def fused_open(monkeypatch):
    """The fused branches open on the CPU (the kernel wrappers run their
    plain versions there); each wrapper call counted by its shape."""
    monkeypatch.setattr(M, "_on_card", lambda device: True)
    monkeypatch.delenv("SG_TPU_FUSED", raising=False)
    calls = []

    def spy(mod):
        real = mod.p1_fused_closed2

        def counted(a, b, *x, **k):
            calls.append(a.shape[1])
            return real(a, b, *x, **k)

        monkeypatch.setattr(mod, "p1_fused_closed2", counted)

    spy(M)
    spy(D)
    return calls


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_fused_branch_at_1024_equals_jax(fused_open, mesh):
    """The matcher's own rule (``use_fused``) takes the kernel at
    hash_dim 1024, every scan launch at that width; the frame is JAX's."""
    s = pd.Series(random_names(600, seed=43))
    kw = dict(min_similarity=0.5, hash_dim=1024)
    t_mesh = None if mesh is None else TP.make_mesh(4, dp=2, device="cpu")
    j_mesh = None if mesh is None else JP.make_mesh(4, dp=2)
    got = sgt.match_strings(s, device="cpu", mesh=t_mesh, **kw)
    assert fused_open and set(fused_open) == {1024}, fused_open
    assert_same(got, sgj.match_strings(s, mesh=j_mesh, **kw))


@pytest.mark.parametrize("n,slots", [(300, None), (512, 2)])
def test_fused_branch_at_1024_sharded_tier_equals_jax(fused_open, n, slots):
    """The multi-process sharded tier (one process, ``slots`` device slots
    per rank): each slot's kt = 2 pass takes the kernel at hash_dim 1024 by
    the same rule, and the frame is JAX's sharded frame.  ``n`` distinct
    names at ``right_tile=256`` give every slot a shape the kernel takes."""
    names = pd.Series(random_names(2 * n, seed=44)).drop_duplicates()
    s = names[:n].reset_index(drop=True)
    kw = dict(min_similarity=0.5, hash_dim=1024, multihost="sharded",
              right_tile=256)
    mesh = None if slots is None else TP.make_mesh(slots, dp=1, device="cpu")
    got = sgt.match_strings(s, device="cpu", mesh=mesh, **kw)
    assert len(fused_open) == (slots or 1) and set(fused_open) == {1024}, fused_open
    assert_same(got, sgj.match_strings(s, **kw))
