"""The port's packed-slot hash path (corpora without the byte-level
payload, or any corpus under ``SG_TPU_DEVICE_ENCODE=0``) against the JAX
package's, on the CPU.

* Host packing (``_pack_rows``, ``_pack_rows_ordered``,
  ``pack_hash_inputs``): bitwise equal, on the native branch and on the
  numpy branch.
* ``_device_hash``: bitwise equal (0 differing elements) at dim 128 and
  512, on rows whose buckets collide.
* ``build_hash_matrix``'s packed branch, single and two-tier: bitwise equal,
  padding rows zero.
* ``topn_cosine_matches``: ``MatchPairs`` bitwise equal, self-join and
  cross-join, for each payload-less case (float32, a custom regex,
  ``ngram_size=4``, a row over 4096 characters, non-ASCII with
  ``normalize_to_ascii=False``), and through the duplicate-collapse layer.
* ``match_strings(..., device="cpu")`` frame-equal for the same cases;
  float32 against the sklearn oracle of test_float32_conformance.py; the
  ``SG_TPU_DEVICE_ENCODE=0`` frame equal to the default one and to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import string_grouper_tpu as sgj
import string_grouper_tpu.native as jnative
import string_grouper_tpu_torch as sgt
import string_grouper_tpu_torch.engine as TE
import string_grouper_tpu_torch.native as tnative
from string_grouper_tpu.config import StringGrouperConfig as JConfig
from string_grouper_tpu.corpus.tfidf import EllMatrix as JEll
from string_grouper_tpu.corpus.tfidf import TfidfEncoder as JEncoder
from string_grouper_tpu.ops import matcher as JM
from string_grouper_tpu_torch.config import StringGrouperConfig
from string_grouper_tpu_torch.corpus import TfidfEncoder
from string_grouper_tpu_torch.corpus.tfidf import ell_from_numpy
from string_grouper_tpu_torch.ops import matcher as TM
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

from test_float32_conformance import CORPUS as F32_CORPUS
from test_float32_conformance import _f32_merge_scores, _sklearn_f32
from test_torch_matcher import _assert_pairs_equal, _skewed_names

CPU = torch.device("cpu")
CUSTOM_REGEX = r"[,-./#&]|\s"


def _accented(names):
    """Every third name with accented letters (kept as is under
    ``normalize_to_ascii=False``, so the native encoder declines)."""
    table = str.maketrans({"a": "á", "e": "é", "o": "ö", "u": "ü"})
    return [s.translate(table) if i % 3 == 0 else s for i, s in enumerate(names)]


BASE = _skewed_names(400, seed=21)  # escalating clusters, repeated strings
LONG_ROW = "alpha beta gamma delta holdings " * 140  # 4,480 characters

#: the payload-less cases: (encoder options, corpus)
CASES = {
    "float32": (dict(tfidf_matrix_dtype=np.float32), BASE),
    "regex": (dict(regex=CUSTOM_REGEX), BASE),
    "ngram4": (dict(ngram_size=4), BASE),
    "long_row": ({}, BASE[:200] + [LONG_ROW] + BASE[200:]),
    "non_ascii": (dict(normalize_to_ascii=False), _accented(BASE)),
}


def _split(names):
    """(master, duplicates) of a cross-join: the first 250 names against
    the rest plus 20 of the master's."""
    return names[:250], names[250:] + names[:20]


def _bare(ell):
    """The port's copy of a JAX-encoded payload-less matrix."""
    assert ell.device_src is None
    return ell_from_numpy(ell.ids, ell.vals64, ell.n_terms)


def _encode_jax(name, cross=False):
    kw, names = CASES[name]
    enc = JEncoder(JConfig(**kw))
    if cross:
        return enc.fit_transform_pair(*_split(names))
    return enc.fit_transform(names), None


def _bf16_bits(h):
    """bf16 tensor or JAX array -> its uint16 bit patterns."""
    if isinstance(h, torch.Tensor):
        return h.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(h).view(np.uint16)


def test_encoders_leave_the_cases_payload_less():
    for name, (kw, names) in CASES.items():
        assert TfidfEncoder(StringGrouperConfig(**kw)).fit_transform(
            names).device_src is None, name
        assert _encode_jax(name)[0].device_src is None, name
    assert len(LONG_ROW) > 4096


# ------------------------------------------------------------ host packing
@pytest.fixture(params=["native", "numpy"])
def pack_branch(request, monkeypatch):
    """Both packages' ``_pack_rows_ordered`` on the native library, or on
    the numpy branch (no library)."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "get_scorer_lib", lambda: None)
        monkeypatch.setattr(tnative, "get_scorer_lib", lambda: None)
    elif tnative.get_scorer_lib() is None:
        pytest.skip("native library not built")
    return request.param


@pytest.mark.parametrize("dim", [128, 512])
def test_packing_equals_jax(pack_branch, dim):
    ell, _ = _encode_jax("long_row")
    t_ell = _bare(ell)
    rng = np.random.default_rng(dim)
    order = rng.permutation(ell.n_rows).astype(np.int32)
    for out_width in (8, ell.width):
        want = JM._pack_rows_ordered(ell.ids, ell.vals64, order, out_width, dim)
        got = TM._pack_rows_ordered(t_ell.ids, t_ell.vals64, order, out_width, dim)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TM._pack_rows(t_ell.ids, t_ell.vals64, dim),
        JM._pack_rows(ell.ids, ell.vals64, dim),
    )
    n_pad = ell.n_rows + 37
    got = TM.pack_hash_inputs(t_ell, n_pad, dim)
    np.testing.assert_array_equal(got, np.asarray(JM.pack_hash_inputs(ell, n_pad, dim)))
    assert got.shape == (n_pad, ell.width) and not got[ell.n_rows:].any()
    if pack_branch == "native":  # the native pass is bitwise the numpy one
        np.testing.assert_array_equal(
            got[:ell.n_rows], TM._pack_rows(t_ell.ids, t_ell.vals64, dim)
        )


def test_pack_hash_inputs_rejects_wide_dim():
    ell, _ = _encode_jax("float32")
    with pytest.raises(ValueError):
        TM.pack_hash_inputs(_bare(ell), ell.n_rows, 1 << 16)
    with pytest.raises(ValueError):
        TM.build_hash_matrix(_bare(ell), ell.n_rows, 1 << 16, CPU)


# ------------------------------------------------------------ device hash
@pytest.mark.parametrize("dim", [128, 512])
@pytest.mark.parametrize("name", sorted(CASES))
def test_device_hash_bitwise_equal_jax(name, dim):
    """Tolerance: 0 differing bf16 elements."""
    ell, _ = _encode_jax(name)
    packed = np.array(JM.pack_hash_inputs(ell, ell.n_rows, dim))
    # plus rows whose buckets collide: each of the first 64 rows again,
    # every slot moved into the bucket of the row's first slot
    coll = packed[:64].copy()
    coll = np.where(coll != 0, (coll[:, :1] & ~0xFFFF) | (coll & 0xFFFF), 0)
    assert ((coll != 0).sum(1) > 1).any()
    packed = np.concatenate([packed, coll])
    want = _bf16_bits(JM._device_hash(jnp.asarray(packed), dim))
    got = TM._device_hash(torch.from_numpy(packed), dim)
    assert got.dtype == torch.bfloat16 and got.shape == (len(packed), dim)
    np.testing.assert_array_equal(_bf16_bits(got), want)


# ------------------------------------------------------------ packed build
def _long_tail_ell(seed=5, n=300, n_terms=900):
    """ELL rows with a long-tail width distribution (most rows narrow)."""
    rng = np.random.default_rng(seed)
    ids = np.full((n, 64), -1, np.int32)
    vals = np.zeros((n, 64), np.float64)
    for i in range(n):
        k = int(rng.integers(5, 24 if i % 4 else 64))
        ids[i, :k] = np.sort(rng.choice(n_terms, size=k, replace=False))
        v = rng.random(k) + 0.1
        vals[i, :k] = v / np.sqrt((v * v).sum())
    return JEll(ids=ids, vals64=vals, n_terms=n_terms)


@pytest.mark.parametrize("min_rows", [10**9, 0], ids=["single", "tiered"])
def test_build_hash_matrix_packed_equals_jax(min_rows):
    ell = _long_tail_ell()
    t_ell = ell_from_numpy(ell.ids, ell.vals64, ell.n_terms)
    n_pad = 384
    want = JM.build_hash_matrix(ell, n_pad, 128, min_rows=min_rows)
    got = TM.build_hash_matrix(t_ell, n_pad, 128, CPU, min_rows=min_rows)
    assert got.shape == (n_pad, 128)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))
    assert not got[ell.n_rows:].any()
    single = TM.build_hash_matrix(t_ell, n_pad, 128, CPU, min_rows=10**9)
    assert torch.equal(got, single)


# ------------------------------------------------------------ full matcher
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_topn_pairs_bitwise_equal_jax(name, cross):
    left, right = _encode_jax(name, cross)
    dtype = CASES[name][0].get("tfidf_matrix_dtype", np.float64)
    j = JM.topn_cosine_matches(left, right, 0.8, 20, score_dtype=dtype)
    t = TM.topn_cosine_matches(
        _bare(left), None if right is None else _bare(right), 0.8, 20,
        score_dtype=dtype, device=CPU,
    )
    _assert_pairs_equal(t, j)
    assert len(t.rows) > 0


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_collapse_gathers_selected_rows_of_packed_hash(cross):
    """A payload-less corpus with repeated strings goes through the
    collapse layer: the phase-1 factory gets row selectors (``left_sel``,
    ``right_sel``), so the hash of the full matrix must be gathered down to
    the selected unique rows."""
    kw = dict(left_chunk=256, right_tile=256)
    left, right = _encode_jax("float32", cross)
    names = CASES["float32"][1]
    if cross:
        m, d = _split(names)
        codes_l, codes_r = pd.factorize(pd.Series(m))[0], pd.factorize(pd.Series(d))[0]
    else:
        codes_l, codes_r = pd.factorize(pd.Series(names))[0], None
    assert len(np.unique(codes_l)) < len(codes_l)
    j = JM.topn_cosine_matches(left, right, 0.8, 20, left_codes=codes_l,
                               right_codes=codes_r, **kw)
    t = TM.topn_cosine_matches(
        _bare(left), None if right is None else _bare(right), 0.8, 20,
        left_codes=codes_l, right_codes=codes_r, device=CPU, **kw,
    )
    assert "expand" in t.stats  # the collapsed path ran
    _assert_pairs_equal(t, j)


# ------------------------------------------------------------ frames
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross_ids"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_match_strings_frame_equal_jax(name, cross):
    kw, names = CASES[name]
    if cross:
        m, d = (pd.Series(x) for x in _split(names))
        mid = pd.Series([f"m{i}" for i in range(len(m))])
        did = pd.Series([f"d{i}" for i in range(len(d))])
        want = sgj.match_strings(m, d, mid, did, min_similarity=0.7, **kw)
        got = sgt.match_strings(m, d, mid, did, min_similarity=0.7,
                                device="cpu", **kw)
    else:
        s = pd.Series(names)
        want = sgj.match_strings(s, **kw)
        got = sgt.match_strings(s, device="cpu", **kw)
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("thr", [0.5, 0.7, 0.8])
def test_match_strings_float32_vs_sklearn_oracle(thr):
    """The port's float32 self-join against sklearn's float32 TF-IDF with
    f32 accumulation (test_float32_conformance.py's oracle): threshold in
    f32, the diagonal exactly 1, symmetrized; similarities equal."""
    x = _sklearn_f32(F32_CORPUS)
    sims = _f32_merge_scores(x)
    thr32 = np.float32(thr)
    out = sgt.match_strings(pd.Series(F32_CORPUS), min_similarity=thr,
                            tfidf_matrix_dtype=np.float32, device="cpu")
    assert out.similarity.dtype == np.float32
    got = {
        (int(r), int(c)): np.float32(s)
        for r, c, s in zip(out.left_index, out.right_index, out.similarity)
    }
    n = len(F32_CORPUS)
    exp = {(i, i): np.float32(1.0) for i in range(n)}
    for i in range(n):
        for j in range(n):
            if i != j and sims[i, j] > 0 and sims[i, j] >= thr32:
                exp[(i, j)] = exp[(j, i)] = sims[i, j]
    assert set(got) == set(exp)
    for k, v in exp.items():
        assert got[k] == v, (k, got[k], v)


# ------------------------------------------------------------ the switch
def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_device_encode_off_frame_equal(monkeypatch, cross):
    """``SG_TPU_DEVICE_ENCODE=0`` sends a payload corpus down the packed
    path (no prefetch, no ``device_hash_codes``, no clean-equality
    collapse): the frame equals the default one and the JAX package's
    under the same switch."""
    names = CASES["float32"][1]
    args = [pd.Series(x) for x in _split(names)] if cross else [pd.Series(names)]
    kw = dict(min_similarity=0.6) if cross else {}
    on = sgt.match_strings(*args, device="cpu", **kw)
    calls = []
    _spy(monkeypatch, TM, "_device_hash", calls)
    _spy(monkeypatch, TM, "device_hash_codes", calls)
    _spy(monkeypatch, TE, "prefetch_corpus_hash", calls)
    monkeypatch.setenv("SG_TPU_DEVICE_ENCODE", "0")
    off = sgt.match_strings(*args, device="cpu", **kw)
    assert "_device_hash" in calls and "device_hash_codes" not in calls
    pd.testing.assert_frame_equal(off, on)
    pd.testing.assert_frame_equal(off, sgj.match_strings(*args, **kw))


def test_device_encode_off_skips_prefetch(monkeypatch):
    ell = TfidfEncoder(StringGrouperConfig()).fit_transform(
        synthetic_company_names(6300))
    assert ell.device_src is not None
    monkeypatch.setenv("SG_TPU_DEVICE_ENCODE", "0")
    TM.prefetch_corpus_hash(ell, 512, "cpu")
    assert getattr(ell.device_src, "_hash_prefetch", None) is None
