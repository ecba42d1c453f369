"""The port's four API functions against the JAX package's, on the CPU.

Each case calls ``string_grouper_tpu.<function>`` and
``string_grouper_tpu_torch.<function>(..., device="cpu")`` on the same
inputs and requires the same frame or Series, EXACTLY (``check_exact``):
the rescoring is exact fp64 (or the reference's f32 chain) and the
selection deterministic, so no tolerance is needed.  Inputs: the fixtures
of test_reference_conformance.py, the float32 corpus of
test_float32_conformance.py, ``tutorials/accounts.csv`` with the tutorials'
arguments, the tutorials' index / ID layouts, and the planted-cluster
corpora of test_fuzz_oracle.py under random options.
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import string_grouper_tpu as sgj
import string_grouper_tpu_torch as sgt

from test_float32_conformance import CORPUS as F32_CORPUS
from test_fuzz_oracle import planted_corpus
from test_matcher import random_names
from test_reference_conformance import SimpleExample

ACCOUNTS = pd.read_csv(
    Path(__file__).resolve().parents[1] / "tutorials" / "accounts.csv"
)


def assert_same(got, want):
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    else:
        pd.testing.assert_series_equal(got, want, check_exact=True)


def both(fn, *args, **kwargs):
    """(port, JAX) results of the API function ``fn`` on the same input."""
    want = getattr(sgj, fn)(*args, **kwargs)
    got = getattr(sgt, fn)(*args, device="cpu", **kwargs)
    return got, want


# ------------------------------------------------------------------ inputs
EX = SimpleExample()
NAMES = EX.customers_df["Customer Name"]
NAMES2 = EX.customers_df2["Customer Name"]
IDS = EX.customers_df["Customer ID"]
IDS2 = EX.customers_df2["Customer ID"]

MULTI = pd.Series(
    ["Mega Corp", "Mega Corp Inc.", "Tiny Co", "Tiny Company"],
    name="Customer Name",
    index=pd.MultiIndex.from_tuples(
        [("CA", 101), ("NY", 205), ("CA", 317), ("TX", 428)],
        names=["State", "Acct"],
    ),
)
MULTI_DUPES = pd.Series(
    ["Mega Corp Incorporated", "Tiny Co.", "Nothing Alike"],
    index=pd.MultiIndex.from_tuples(
        [("WA", 1), ("OR", 2), ("NV", 3)], names=["St", "No"]
    ),
)
REGISTRY = pd.Series(["foooo", "bar", "baz"], index=[100, 101, 102], name="name")
INCOMING = pd.Series(
    ["foooob", "bar", "new thing"], index=["a", "b", "c"], name="name"
)
GRID_MASTER = pd.Series(
    ["foooo", "bar"], name="m", index=pd.Index([10, 11], name="mid")
)
GRID_MASTER_ID = pd.Series(pd.array([1, 2], dtype="Int64"), index=GRID_MASTER.index)
GRID_DUPES = pd.Series(
    ["foooob", "bar", "zzz"], name="d", index=pd.Index([7, 8, 9], name="did")
)
GRID_DUPES_ID = pd.Series(pd.array([71, 81, 91], dtype="Int64"), index=GRID_DUPES.index)
NO_MATCH_M = pd.Series(["foooo", "bar", "baz"])
NO_MATCH_D = pd.Series(["foooo", "dooz", "bar", "baz", "foooob"])
RANDOM = pd.Series(random_names(300, seed=21), name="company")
RANDOM_D = pd.Series(random_names(120, seed=22) + list(RANDOM[:30]))
NEW_NAMES = pd.Series(
    ["granite peak industires inc", "blue harbor logistics", "quantum nine labs"]
)
F32 = dict(tfidf_matrix_dtype=np.float32)


# ------------------------------------------------------------------ cases
GROUP_CASES = {
    "centroid_ignore_index": ((NAMES,), dict(min_similarity=0.6, ignore_index=True)),
    "centroid_with_index": ((NAMES,), dict(min_similarity=0.6)),
    "first": ((NAMES,), dict(group_rep="first", min_similarity=0.6, ignore_index=True)),
    "ids": ((NAMES2, IDS2), dict(min_similarity=0.6)),
    "ids_first_ignore_index": (
        (NAMES2, IDS2), dict(min_similarity=0.6, group_rep="first", ignore_index=True)
    ),
    "single_value": ((pd.Series(["hello"]),), dict(min_similarity=0.6)),
    "multiindex": ((MULTI,), dict(min_similarity=0.5)),
    "multiindex_ignore_index": ((MULTI,), dict(min_similarity=0.5, ignore_index=True)),
    "nameless_defaults": ((pd.Series(["foooo", "bar", "baz", "foooob"]),), {}),
    "random_centroid": ((RANDOM,), dict(min_similarity=0.5)),
    "random_first": ((RANDOM,), dict(min_similarity=0.5, group_rep="first")),
    "thresholdless": ((NAMES,), dict(min_similarity=0, include_zeroes=True)),
    "float32": ((pd.Series(F32_CORPUS),), dict(min_similarity=0.5, **F32)),
    "float32_first": (
        (pd.Series(F32_CORPUS),), dict(min_similarity=0.5, group_rep="first", **F32)
    ),
    "accounts_ids": ((ACCOUNTS.name, ACCOUNTS.id), dict(min_similarity=0.7)),
    "accounts_ignore_index": ((ACCOUNTS["name"],), dict(min_similarity=0.8, ignore_index=True)),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_similar_strings_equal(case):
    args, kw = GROUP_CASES[case]
    got, want = both("group_similar_strings", *args, **kw)
    assert_same(got, want)


MOST_SIMILAR_CASES = {
    "names": ((NAMES, NAMES2), dict(min_similarity=0.6)),
    "names_ids": ((NAMES, NAMES2, IDS, IDS2), dict(min_similarity=0.6)),
    "no_match_passthrough": ((NO_MATCH_M, NO_MATCH_D), dict(ignore_index=True)),
    "no_match_passthrough_ids": (
        (NO_MATCH_M, NO_MATCH_D, pd.Series(["A0", "A1", "A2"]),
         pd.Series(["B0", "B1", "B2", "B3", "B4"])),
        dict(ignore_index=True),
    ),
    "numeric_ids_missing_master": (
        (pd.Series(["foooo", "bar", "foooo"]), NO_MATCH_D[[0, 2, 3, 4]].reset_index(drop=True),
         pd.Series([0, 1, 2], dtype="Int64"), pd.Series([100, 101, 102, 103], dtype="Int64")),
        dict(ignore_index=True),
    ),
    "replace_na_int64_index": (
        (pd.Series(["foooo", "bar"], index=pd.Index([0, 1], dtype="Int64")),
         pd.Series(["foooo", "bar", "baz"], index=pd.Index([100, 101, 102], dtype="Int64"))),
        dict(replace_na=True),
    ),
    "named_index_passthrough": ((REGISTRY, INCOMING), dict(min_similarity=0.6)),
    "grid_ids": (
        (GRID_MASTER, GRID_DUPES, GRID_MASTER_ID, GRID_DUPES_ID), dict(min_similarity=0.5)
    ),
    "grid_ids_replace_na": (
        (GRID_MASTER, GRID_DUPES, GRID_MASTER_ID, GRID_DUPES_ID),
        dict(min_similarity=0.5, replace_na=True),
    ),
    "grid_ids_ignore_index": (
        (GRID_MASTER, GRID_DUPES, GRID_MASTER_ID, GRID_DUPES_ID),
        dict(min_similarity=0.5, ignore_index=True),
    ),
    "multiindex": ((MULTI, MULTI_DUPES), dict(min_similarity=0.5)),
    "multiindex_replace_na": ((MULTI, MULTI_DUPES), dict(min_similarity=0.5, replace_na=True)),
    "multiindex_ignore_index": ((MULTI, MULTI_DUPES), dict(min_similarity=0.5, ignore_index=True)),
    "random": ((RANDOM, RANDOM_D), dict(min_similarity=0.6)),
    "float32_ties": (
        (pd.Series(F32_CORPUS),
         pd.Series(["Mega Enterprises Co", "Hyper Startup", "completely unrelated text"])),
        dict(min_similarity=0.3, ignore_index=True, **F32),
    ),
    "accounts": ((ACCOUNTS.name, NEW_NAMES), dict(min_similarity=0.5)),
    "max_n_matches_is_forced": ((NAMES, NAMES2), dict(min_similarity=0.1, max_n_matches=20)),
}


@pytest.mark.parametrize("case", sorted(MOST_SIMILAR_CASES))
def test_match_most_similar_equal(case):
    args, kw = MOST_SIMILAR_CASES[case]
    got, want = both("match_most_similar", *args, **kw)
    assert_same(got, want)


PAIRWISE_CASES = {
    "reference": ((NAMES, EX.expected_result_centroid), {}),
    "named_index": (
        (NAMES.set_axis(list("abcdef")), NAMES2[:6].rename("other")), {}
    ),
    "random": ((RANDOM[:120], RANDOM_D[:120]), {}),
    "ngram_2": ((NAMES, NAMES2[:6]), dict(ngram_size=2)),
}


@pytest.mark.parametrize("case", sorted(PAIRWISE_CASES))
def test_compute_pairwise_similarities_equal(case):
    args, kw = PAIRWISE_CASES[case]
    got, want = both("compute_pairwise_similarities", *args, **kw)
    assert_same(got, want)
    assert got.dtype == np.float64


def test_compute_pairwise_similarities_float32_bitwise():
    """The float32 path reduces with ``np.add.reduceat`` (scipy's pairwise
    ``multiply().sum(axis=1)``): bitwise JAX's."""
    s1 = pd.Series(F32_CORPUS[:4])
    s2 = pd.Series(F32_CORPUS[4:])
    got, want = both("compute_pairwise_similarities", s1, s2, **F32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.to_numpy().view(np.uint32),
                                  want.to_numpy().view(np.uint32))
    assert_same(got, want)


def test_compute_pairwise_similarities_unequal_lengths_raise():
    with pytest.raises(Exception, match="same length"):
        sgt.compute_pairwise_similarities(NAMES, NAMES2, device="cpu")


MATCH_CASES = {
    "zeroes": ((NAMES, EX.whatever_series_1), dict(min_similarity=0)),
    "zeroes_excluded": ((NAMES, EX.whatever_series_1), dict(min_similarity=0, include_zeroes=False)),
    "self_zeroes": ((NAMES,), dict(min_similarity=0, max_n_matches=None)),
    "accounts_ids": ((ACCOUNTS.name, None, ACCOUNTS.id), dict(min_similarity=0.7)),
    "multiindex": ((MULTI,), dict(min_similarity=0.5)),
    "float32": ((pd.Series(F32_CORPUS),), dict(min_similarity=0.5, **F32)),
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_strings_equal(case):
    args, kw = MATCH_CASES[case]
    got, want = both("match_strings", *args, **kw)
    assert_same(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_groups_and_nearest_equal(seed):
    """Planted duplicate clusters of 1-40 members (every escalation bucket)
    under a random threshold, cap, representative rule and dtype."""
    rng = np.random.default_rng(4000 + seed)
    master = pd.Series(planted_corpus(rng))
    dupes = pd.Series(planted_corpus(rng))
    kw = dict(
        min_similarity=float(rng.choice([0.15, 0.5, 0.8, 0.95])),
        max_n_matches=int(rng.choice([1, 3, 20])),
        group_rep=str(rng.choice(["centroid", "first"])),
        tfidf_matrix_dtype=(np.float64, np.float32)[seed % 2],
    )
    assert_same(*both("group_similar_strings", master, **kw))
    assert_same(*both("match_most_similar", master, dupes, **kw))
