"""The port's TF-IDF encoder against the JAX package's: ELL ids, values and
every field of the byte-level device payload must be BITWISE equal (the
port keeps its own copy of the native encoder and the numpy path), in
float64 and float32; and ``ell_from_numpy`` carries an encoded corpus
across unchanged."""

import numpy as np
import pytest

from string_grouper_tpu.config import StringGrouperConfig as JConfig
from string_grouper_tpu.corpus.tfidf import TfidfEncoder as JEncoder
from string_grouper_tpu_torch.config import StringGrouperConfig as TConfig
from string_grouper_tpu_torch.corpus.tfidf import TfidfEncoder as TEncoder
from string_grouper_tpu_torch.corpus.tfidf import ell_from_numpy

from test_native_encode import CORPORA as NATIVE_CORPORA
from test_tfidf_parity import CORPORA as PARITY_CORPORA

CORPORA = {f"parity_{k}": v for k, v in PARITY_CORPORA.items()}
CORPORA.update({f"native_{k}": v for k, v in NATIVE_CORPORA.items()})

SRC_FIELDS = (
    "flat_codes", "coff", "inv_norm", "table_id", "idf32", "row_hash",
)


def _encode_both(strings, **kw):
    j = JEncoder(JConfig(**kw)).fit_transform(strings)
    t = TEncoder(TConfig(**kw)).fit_transform(strings)
    return j, t


def _assert_ell_equal(j, t):
    assert t.n_terms == j.n_terms
    np.testing.assert_array_equal(t.ids, j.ids)
    np.testing.assert_array_equal(t.vals64, j.vals64)
    assert (t.device_src is None) == (j.device_src is None)
    if j.device_src is not None:
        for f in SRC_FIELDS:
            np.testing.assert_array_equal(
                getattr(t.device_src, f), getattr(j.device_src, f), err_msg=f
            )
        assert t.device_src.base == j.device_src.base
        assert t.device_src.ngram == j.device_src.ngram


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_encoder_bitwise_equal(name, dtype):
    j, t = _encode_both(CORPORA[name], tfidf_matrix_dtype=dtype)
    _assert_ell_equal(j, t)


def test_encoder_pair_slices_equal():
    master = CORPORA["parity_customers"]
    dupes = ["hyper startup inc", "mega enterprises corp", "q9 zz ltd"]
    jm, jd = JEncoder(JConfig()).fit_transform_pair(master, dupes)
    tm, td = TEncoder(TConfig()).fit_transform_pair(master, dupes)
    _assert_ell_equal(jm, tm)
    _assert_ell_equal(jd, td)


def test_ell_from_numpy_carries_corpus_across():
    j = JEncoder(JConfig()).fit_transform(CORPORA["parity_customers"])
    src = j.device_src
    t = ell_from_numpy(
        j.ids, j.vals64, j.n_terms,
        table_id=src.table_id, idf32=src.idf32, inv_norm=src.inv_norm,
        flat_codes=src.flat_codes, coff=src.coff, base=src.base,
        ngram=src.ngram, row_hash=src.row_hash,
    )
    _assert_ell_equal(j, t)
    bare = ell_from_numpy(j.ids, j.vals64, j.n_terms)
    assert bare.device_src is None
    np.testing.assert_array_equal(bare.vals64, j.vals64)
