"""The ``SG_TPU_FUSED=0`` switch (``ops.matcher.fused_enabled``) reaches
every site that can launch the fused phase-1 kernels, as the JAX package's
does: the single-device scan (``_phase1_single.run_stream``) and its kt = 2
escalation (``run_rows``), the mesh tier's ``_phase1_distributed`` and the
multi-process tiers' ``_phase1_scan``.

The kernels run on the card only, so these tests let the CPU take the
fused branch by patching the one device check (``ops.matcher._on_card``,
read by ``use_fused``) and count every call of the kernel wrappers (which
run their plain versions on CPU tensors).  Switch on: each site calls its
kernel.  Switch off: none does, and the outputs are the same pairs.  No
site calls the chained kernel ``p1_fused_chain``, on or off.
"""

import numpy as np
import pytest
import torch

from string_grouper_tpu.config import StringGrouperConfig as JConfig
from string_grouper_tpu.corpus.tfidf import TfidfEncoder as JEncoder
from string_grouper_tpu.ops import matcher as JMatcher
from string_grouper_tpu_torch.config import StringGrouperConfig
from string_grouper_tpu_torch.corpus import TfidfEncoder
from string_grouper_tpu_torch.ops import kernels as K
from string_grouper_tpu_torch.ops import matcher as M
from string_grouper_tpu_torch.parallel import distributed as D
from string_grouper_tpu_torch.parallel import make_mesh
from string_grouper_tpu_torch.parallel import multihost as MH
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

from test_torch_matcher import _assert_pairs_equal, _carry

CPU = torch.device("cpu")
KNOBS = dict(left_chunk=256, right_tile=256)
SITES = ("single_stream", "single_rows", "mesh", "multihost")


@pytest.fixture(scope="module")
def ell():
    return TfidfEncoder(StringGrouperConfig()).fit_transform(
        synthetic_company_names(4096)).wait_ready()


@pytest.fixture
def launches(monkeypatch):
    """Fused branches open on the CPU; each kernel wrapper call counted."""
    monkeypatch.setattr(M, "_on_card", lambda device: True)
    monkeypatch.delenv("SG_TPU_FUSED", raising=False)
    count = {"p1_fused_closed2": 0, "p1_fused_chain": 0}

    def spy(mod, name):
        real = getattr(mod, name)

        def counted(*a, **k):
            count[name] += 1
            return real(*a, **k)

        monkeypatch.setattr(mod, name, counted)

    spy(M, "p1_fused_closed2")
    spy(K, "p1_fused_chain")
    spy(D, "p1_fused_closed2")  # the mesh and multi-process tiers' shards
    return count


def _drive(site, ell, thr):
    """Run ``site`` once; return what it computed (host arrays)."""
    if site in ("single_stream", "single_rows"):
        run_stream, run_rows, _n, _tile = M._phase1_single(
            ell, ell, True, 128, device=CPU, **KNOBS)
        if site == "single_rows":
            return run_rows(np.arange(512), thr, 64, 2)
        return [x[:2] for x in run_stream(thr, 64, 2)]
    if site == "mesh":
        run_stream, _rows, _n, _tile = D._phase1_distributed(
            ell, ell, True, make_mesh(2, device="cpu"), 128, **KNOBS)
        return [x[:2] for x in run_stream(thr, 64, 2)]
    h = M.build_hash_matrix(ell, 2 * 1024, 128, CPU)
    b_slots = MH._slot_blocks(h, [CPU, CPU])
    return MH._phase1_scan(
        MH._slot_copies(h[:1024], b_slots), b_slots, thr, np.array([0]),
        np.array([1024]), tile=256, chunk=8, cand_c=64, k_tile=2)


def _same_pairs(got, want, site):
    """The sites' outputs on and off: the same candidate sets row by row
    (the kernel and the torch-op body may order a row's candidates
    differently)."""
    if site == "multihost":
        got, want = [got], [want]
    elif site == "single_rows":
        got, want = [got[:2]], [want[:2]]
    for g, w in zip(got, want):
        if site == "multihost":
            g_set = [set(r[r >= 0].tolist()) for r in g[0]]
            w_set = [set(r[r >= 0].tolist()) for r in w[0]]
            assert g_set == w_set
            np.testing.assert_array_equal(g[1], w[1])
            continue
        pairs = lambda x: sorted(zip(np.asarray(x[0]).tolist(),
                                     np.asarray(x[1]).tolist()))
        assert pairs(g) == pairs(w)


@pytest.mark.parametrize("site", SITES)
def test_switch_reaches_site(site, ell, launches, monkeypatch):
    thr = float(M.effective_threshold(0.8))
    on = _drive(site, ell, thr)
    assert launches["p1_fused_closed2"] > 0, launches
    assert launches["p1_fused_chain"] == 0, launches
    launches["p1_fused_closed2"] = 0
    monkeypatch.setenv("SG_TPU_FUSED", "0")
    off = _drive(site, ell, thr)
    assert launches == {"p1_fused_closed2": 0, "p1_fused_chain": 0}
    _same_pairs(off, on, site)


def test_fused_enabled_read_per_call(monkeypatch):
    monkeypatch.delenv("SG_TPU_FUSED", raising=False)
    assert M.fused_enabled()
    monkeypatch.setenv("SG_TPU_FUSED", "0")
    assert not M.fused_enabled()
    monkeypatch.setenv("SG_TPU_FUSED", "1")
    assert M.fused_enabled()


@pytest.mark.parametrize("fused", ["1", "0"])
def test_matcher_pairs_equal_jax_either_way(fused, ell, launches, monkeypatch):
    """The whole matcher with the fused branch open, switch on or off:
    ``MatchPairs`` bitwise the JAX package's (which runs its XLA body on
    the CPU); the kernel is called only when the switch is on."""
    monkeypatch.setenv("SG_TPU_FUSED", fused)
    names = synthetic_company_names(4096)
    j_ell = JEncoder(JConfig()).fit_transform(names)
    want = JMatcher.topn_cosine_matches(j_ell, None, 0.8, 20, hash_dim=128,
                                        **KNOBS)
    got = M.topn_cosine_matches(_carry(j_ell), None, 0.8, 20, hash_dim=128,
                                device=CPU, **KNOBS)
    _assert_pairs_equal(got, want)
    assert (launches["p1_fused_closed2"] > 0) == (fused == "1")
