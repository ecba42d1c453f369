"""The port's column-chunked phase-1 pipeline (SG_TPU_CHUNKED_P1=1) on the
CPU, against the unchunked run and the JAX package.

The pipeline runs on the card only; these tests force it onto the CPU by
patching the device test and the size floor, so the chained passes run the
plain ``p1_fused_chain`` version.  The corpus (6,300 names, 5,970 unique
after the collapse) at ``left_chunk = right_tile = 256`` has 3 segments of
2,048 rows: G = 2 gives chunks of 4,096 and 2,048 rows, G = 3 three chunks
of 2,048.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import string_grouper_tpu as sgj
import string_grouper_tpu_torch as sgt
import string_grouper_tpu_torch.engine as TE
from string_grouper_tpu.config import StringGrouperConfig as JConfig
from string_grouper_tpu.corpus.tfidf import TfidfEncoder as JEncoder
from string_grouper_tpu.ops import matcher as JM
from string_grouper_tpu_torch.config import StringGrouperConfig
from string_grouper_tpu_torch.corpus import TfidfEncoder
from string_grouper_tpu_torch.ops import matcher as TM
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

from test_torch_matcher import _assert_pairs_equal, _carry

CPU = torch.device("cpu")
CORPUS = synthetic_company_names(6300)
KNOBS = dict(left_chunk=256, right_tile=256)


@pytest.fixture
def passes(monkeypatch):
    """Let the chunked branch engage on the CPU; record every chained pass
    as (col_off, chunk rows)."""
    monkeypatch.setattr(TM, "_CHUNKED_P1_MIN_ROWS", 1000)
    monkeypatch.setattr(TM, "_on_card", lambda device: True)
    monkeypatch.delenv("SG_TPU_CHUNKED_P1", raising=False)
    monkeypatch.delenv("SG_TPU_CHUNKED_P1_GROUPS", raising=False)
    seen = []
    real = TM.p1_fused_chain

    def spy(a, b, thr, col_off, state, **kw):
        seen.append((col_off, b.shape[0]))
        return real(a, b, thr, col_off, state, **kw)

    monkeypatch.setattr(TM, "p1_fused_chain", spy)
    return seen


@pytest.fixture(scope="module")
def reference_pairs():
    ell = JEncoder(JConfig()).fit_transform(CORPUS)
    return ell, JM.topn_cosine_matches(ell, None, 0.8, 20, **KNOBS)


@pytest.mark.parametrize("groups,chunks", [
    (2, [(0, 4096), (4096, 2048)]),
    (3, [(0, 2048), (2048, 2048), (4096, 2048)]),
])
def test_chunked_pairs_bitwise_equal_unchunked_and_jax(
        passes, monkeypatch, reference_pairs, groups, chunks):
    ell, want = reference_pairs
    plain = TM.topn_cosine_matches(_carry(ell), None, 0.8, 20, device=CPU,
                                   **KNOBS)
    assert passes == []
    monkeypatch.setenv("SG_TPU_CHUNKED_P1", "1")
    monkeypatch.setenv("SG_TPU_CHUNKED_P1_GROUPS", str(groups))
    got = TM.topn_cosine_matches(_carry(ell), None, 0.8, 20, device=CPU,
                                 **KNOBS)
    # every one of the 3 segments chains through every chunk, in order
    assert sorted(set(passes)) == chunks
    assert len(passes) == 3 * groups
    _assert_pairs_equal(got, plain)
    _assert_pairs_equal(got, want)
    assert got.stats["rounds"] >= 1  # escalation read the concatenated hash


def test_chunked_frames_equal_unchunked_and_jax(passes, monkeypatch):
    s = pd.Series(CORPUS)
    want = sgj.match_strings(s, **KNOBS)
    plain = sgt.match_strings(s, device="cpu", **KNOBS)
    prefetched = []
    real_prefetch = TE.prefetch_corpus_hash
    monkeypatch.setattr(
        TE, "prefetch_corpus_hash",
        lambda *a, **k: (prefetched.append(1), real_prefetch(*a, **k)),
    )
    monkeypatch.setenv("SG_TPU_CHUNKED_P1", "1")
    got = sgt.match_strings(s, device="cpu", **KNOBS)
    assert passes and prefetched == []  # chunked, and the prefetch skipped
    pd.testing.assert_frame_equal(got, plain)
    pd.testing.assert_frame_equal(got, want)


def _prefetch_spy(monkeypatch):
    calls = []
    real = TE.prefetch_corpus_hash

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TE, "prefetch_corpus_hash", spy)
    return calls


def test_engine_prefetches_when_the_matcher_declines(passes, monkeypatch):
    """With the knob on, fits the matcher does not chunk keep the prefetch:
    a single segment, a candidate width the chained kernel does not take,
    a corpus without a byte payload."""
    monkeypatch.setenv("SG_TPU_CHUNKED_P1", "1")
    calls = _prefetch_spy(monkeypatch)
    small = pd.Series(CORPUS[:2000])  # one segment
    sgt.StringGrouper(small, device="cpu", **KNOBS).fit()
    assert calls == [1] and passes == []

    enc = TfidfEncoder(StringGrouperConfig())
    ell = enc.fit_transform(CORPUS)
    assert TM.chunked_p1_will_engage(ell, True, 0.8, 20, 512, 256, 256, "cpu")
    assert not TM.chunked_p1_will_engage(  # cand_c 512 > 256
        ell, True, 0.8, 300, 512, 256, 256, "cpu")
    assert not TM.chunked_p1_will_engage(  # cross-join
        ell, False, 0.8, 20, 512, 256, 256, "cpu")

    f32 = StringGrouperConfig(tfidf_matrix_dtype=np.float32)
    bare = TfidfEncoder(f32).fit_transform(CORPUS)
    assert bare.device_src is None
    assert not TM.chunked_p1_will_engage(bare, True, 0.8, 20, 512, 256, 256, "cpu")
    calls.clear()
    # payload-less: the prefetch is a no-op and the packed-slot path runs
    grouper = sgt.StringGrouper(pd.Series(CORPUS), device="cpu",
                                tfidf_matrix_dtype=np.float32, **KNOBS).fit()
    assert len(grouper.get_matches()) >= len(CORPUS)
    assert calls == [1] and passes == []


def test_chunked_knob_off_by_default(monkeypatch):
    monkeypatch.delenv("SG_TPU_CHUNKED_P1", raising=False)
    ell = TfidfEncoder(StringGrouperConfig()).fit_transform(CORPUS)
    monkeypatch.setattr(TM, "_on_card", lambda device: True)
    assert not TM.chunked_p1_will_engage(ell, True, 0.8, 20, 512, 256, 256, "cpu")
