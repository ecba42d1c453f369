"""The collapse layer's duplicate grouping in one native pass.

``clean_group_positions`` (native/exact_scorer.cpp) groups a payload's
rows by clean equality and emits ``_group_positions``' canonical tuple
``(codes, first, perm, starts, counts)`` directly.  It is held bitwise
against the numpy chain ``_group_positions(_clean_refined_codes(src))``,
which ``_clean_codes`` takes with ``get_scorer_lib`` patched to None:

* on the 20k clustered corpus, at 1 and at 7 native threads;
* on forged hashes that make rows with different bytes collide, at equal
  lengths (each collider demoted to a singleton) and at unequal lengths;
* on empty strings, one row, all rows equal and all rows distinct.

A fit counts the rows the native pass grouped in
``timings["match.collapse_native_rows"]``: n for a self-join, n_left +
n_right for a cross-join, and 0 on the numpy route, whose frame is the
same.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest

import string_grouper_tpu_torch as sgt
import string_grouper_tpu_torch.native as N
from string_grouper_tpu_torch.config import StringGrouperConfig
from string_grouper_tpu_torch.corpus import TfidfEncoder
from string_grouper_tpu_torch.ops import matcher as M
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

FIELDS = ("codes", "first", "perm", "starts", "counts")
DTYPES = (np.int64, np.int32, np.int64, np.int64, np.int64)


@pytest.fixture(scope="module")
def lib():
    lib = N.get_scorer_lib()
    if lib is None:
        pytest.skip(f"native library unavailable: {N.build.BUILD_ERROR}")
    return lib


@pytest.fixture(scope="module")
def src20k():
    return _payload(synthetic_company_names(20_000))


def _payload(strings):
    return TfidfEncoder(StringGrouperConfig()).fit_transform(
        list(strings)).wait_ready().device_src


def _native(src):
    groups, native = M._clean_codes(dataclasses.replace(src))
    assert native
    return groups


def _numpy(src, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(N, "get_scorer_lib", lambda: None)
        groups, native = M._clean_codes(dataclasses.replace(src))
    assert not native
    return groups


def _assert_bitwise(got, want):
    assert len(got) == len(want) == len(FIELDS)
    for g, w, name, dt in zip(got, want, FIELDS, DTYPES):
        assert g.dtype == w.dtype == dt, name
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _forged(src, hashes):
    return dataclasses.replace(src, row_hash=np.asarray(hashes, dtype=np.uint64))


@pytest.mark.parametrize("threads", [1, 7])
def test_native_pass_equals_numpy_chain_on_20k(lib, src20k, threads, monkeypatch):
    before = lib.get_max_threads()
    lib.set_num_threads(threads)
    try:
        got = _native(src20k)
    finally:
        lib.set_num_threads(before)
    want = _numpy(src20k, monkeypatch)
    _assert_bitwise(got, want)
    codes, first, perm, starts, counts = got
    n = len(codes)
    assert 0 < len(first) < n  # the clusters collapse
    assert (np.diff(first) > 0).all() and first[0] == 0
    assert counts.sum() == n and sorted(perm) == list(range(n))


@pytest.mark.parametrize("forge", ["length", "constant", "mod5"])
def test_colliding_hashes_demote_to_singletons(lib, src20k, forge, monkeypatch):
    """Forged hashes: ``length`` makes every pair of equal-length rows
    collide, ``constant`` every pair of rows (the lengths split them
    first), ``mod5`` five hash classes of mixed lengths.  Byte
    verification must demote each mismatching row to its own group."""
    lens = np.diff(src20k.coff)
    h = {"length": lens,
         "constant": np.full(len(lens), 7),
         "mod5": src20k.row_hash % np.uint64(5)}[forge]
    forged = _forged(src20k, h)
    got = _native(forged)
    _assert_bitwise(got, _numpy(forged, monkeypatch))
    # a forged class never joins different bytes; it may split equal rows
    # whose run starts at another string, so groups can only grow
    true_groups = len(_native(src20k)[1])
    assert len(got[1]) >= true_groups


def test_collider_of_equal_length_is_its_own_group(lib, monkeypatch):
    src = _payload(["aaa bbb", "ccc ddd", "aaa bbb", "ccc ddd", "eee"])
    forged = _forged(src, [7, 7, 7, 7, 7])
    got = _native(forged)
    _assert_bitwise(got, _numpy(forged, monkeypatch))
    # rows 0 and 2 are equal; 1 and 3 are equal to each other but not to
    # their run's first row (0), so each is demoted alone
    assert list(got[0]) == [0, 1, 0, 2, 3]


@pytest.mark.parametrize("case", ["empty_strings", "one_row", "all_equal",
                                  "all_distinct"])
def test_edge_corpora(lib, case, monkeypatch):
    strings = {
        "empty_strings": ["", "Mega Corp", " ", "", "mega corp", "!!", "x y z",
                          "", "MEGA-CORP"],
        "one_row": ["Mega Corp Industries"],
        "all_equal": ["Acme Holdings Inc"] * 37,
        "all_distinct": [f"company{i:04d} holdings" for i in range(300)],
    }[case]
    src = _payload(strings)
    got = _native(src)
    _assert_bitwise(got, _numpy(src, monkeypatch))
    n_groups = {"one_row": 1, "all_equal": 1, "all_distinct": len(strings)}
    if case in n_groups:
        assert len(got[1]) == n_groups[case]


@pytest.mark.parametrize("join", ["self", "cross"])
def test_fit_counts_native_rows(lib, join, monkeypatch):
    master = pd.Series(synthetic_company_names(1_200))
    new = pd.Series(synthetic_company_names(300, seed=7))
    args = (master,) if join == "self" else (master, new)
    kw = dict(device="cpu", left_chunk=256, right_tile=256)
    native = sgt.StringGrouper(*args, **kw).fit()
    n = len(master) + (0 if join == "self" else len(new))
    assert native.timings.seconds["match.collapse_native_rows"] == n
    monkeypatch.setattr(N, "get_scorer_lib", lambda: None)
    numpy_route = sgt.StringGrouper(*args, **kw).fit()
    assert numpy_route.timings.seconds["match.collapse_native_rows"] == 0
    pd.testing.assert_frame_equal(numpy_route.get_matches(), native.get_matches())
