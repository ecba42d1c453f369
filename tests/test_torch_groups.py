"""Grouping in the port against the JAX package, on the CPU.

* ``connected_components`` (the native union-find) and the torch op
  ``_cc_labels`` are each BITWISE JAX's XLA ``_cc_kernel`` and the
  union-find oracle, at the sizes of test_connected_components.py, plus the
  chain and self-loop case; without the native library the function routes
  to the torch op with the same labels.
* ``group_representatives`` equal to JAX's for both rules, on random edge
  lists with tied weights and on the matches list of a real fit.
* The three ``new_group_rep_by_*`` utilities equal to JAX's on the
  ``customers_df`` fixture of test_utils.py.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import string_grouper_tpu as sgj
import string_grouper_tpu.utils as JU
import string_grouper_tpu_torch.utils as TU
from string_grouper_tpu.frame import group_representatives as j_group_reps
from string_grouper_tpu_torch.frame import group_representatives as t_group_reps
from string_grouper_tpu_torch.ops import connected_components as TCC

from test_connected_components import _device_labels, _oracle_labels
from test_torch_api import assert_same
from test_torch_matcher import FRAME_CORPUS
from test_utils import customers_df  # noqa: F401  (pytest fixture)

CPU = torch.device("cpu")


def _torch_labels(a, b, n):
    return TCC._cc_labels(torch.from_numpy(a), torch.from_numpy(b), n).numpy()


def _random_edges(seed, n, e):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, size=e).astype(np.int64),
            rng.integers(0, n, size=e).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,e", [(1, 0), (7, 3), (64, 200), (500, 1500)])
def test_labels_equal_jax_kernel_and_oracle(seed, n, e):
    a, b = _random_edges(seed, n, e)
    want = _oracle_labels(a, b, n)
    np.testing.assert_array_equal(_device_labels(a, b, n), want)
    native = TCC.connected_components(a, b, n, CPU)
    assert native.dtype == np.int64
    np.testing.assert_array_equal(native, want)
    np.testing.assert_array_equal(_torch_labels(a, b, n), want)


def test_chain_and_selfloops():
    n = 300
    a = np.arange(n - 1, dtype=np.int64)
    b = a + 1
    a = np.r_[a, np.arange(n, dtype=np.int64)]
    b = np.r_[b, np.arange(n, dtype=np.int64)]
    zeros = np.zeros(n, dtype=np.int64)
    np.testing.assert_array_equal(TCC.connected_components(a, b, n, CPU), zeros)
    np.testing.assert_array_equal(_torch_labels(a, b, n), zeros)
    # reversed chain: the smallest label has to travel the whole path
    np.testing.assert_array_equal(_torch_labels(a[::-1].copy(), b[::-1].copy(), n), zeros)
    np.testing.assert_array_equal(_device_labels(a, b, n), zeros)


def test_without_native_library_routes_to_the_torch_op(monkeypatch):
    a, b = _random_edges(5, 400, 900)
    want = TCC.connected_components(a, b, 400, CPU)
    monkeypatch.setattr(TCC, "get_scorer_lib", lambda: None)
    np.testing.assert_array_equal(TCC.connected_components(a, b, 400, CPU), want)
    assert len(TCC.connected_components(a[:0], b[:0], 0, CPU)) == 0


def _matches(seed, n, e, tie_step):
    a, b = _random_edges(seed, n, e)
    rng = np.random.default_rng(seed + 100)
    sims = np.round(rng.uniform(0.5, 1.0, size=e) / tie_step) * tie_step
    return pd.DataFrame({"master_side": a, "dupe_side": b, "similarity": sims})


@pytest.mark.parametrize("rule", ["centroid", "first"])
@pytest.mark.parametrize("seed,n,e,tie_step", [
    (0, 50, 40, 0.25), (1, 300, 250, 0.5), (2, 1000, 1200, 1e-9),
])
def test_group_representatives_equal(rule, seed, n, e, tie_step):
    ml = _matches(seed, n, e, tie_step)
    want = j_group_reps(ml, n, rule)
    got = t_group_reps(ml, n, rule, CPU)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64


@pytest.mark.parametrize("rule", ["centroid", "first"])
def test_group_representatives_of_a_fit_equal(rule):
    ml = sgj.StringGrouper(FRAME_CORPUS, min_similarity=0.5).fit()._matches_list
    n = len(FRAME_CORPUS)
    got = t_group_reps(ml, n, rule, CPU)
    np.testing.assert_array_equal(got, j_group_reps(ml, n, rule))
    assert len(np.unique(got)) < n


def test_group_representatives_empty():
    empty = pd.DataFrame({"master_side": [], "dupe_side": [], "similarity": []})
    assert len(t_group_reps(empty, 0, "first", CPU)) == 0


def _as_timestamps(df):
    return df["timestamp"].transform(lambda t: pd.Timestamp(t))


@pytest.mark.parametrize("fn,args", [
    ("new_group_rep_by_earliest_timestamp", ("group ID", "Customer ID", "timestamp")),
    ("new_group_rep_by_earliest_timestamp",
     ("group ID", "Customer ID", "timestamp", "Customer Name")),
    ("new_group_rep_by_earliest_timestamp", ("group ID", "Customer ID", "weight", "Customer Name")),
    ("new_group_rep_by_earliest_timestamp", (8, 0, _as_timestamps, 1)),
    ("new_group_rep_by_completeness", ("group ID", "Customer ID", "Customer Name", [1, 2, 3, 4])),
    ("new_group_rep_by_completeness", ("group ID", "Customer ID", "Customer Name")),
    ("new_group_rep_by_completeness", ("group ID", "Customer ID")),
    ("new_group_rep_by_highest_weight", ("group ID", "Customer ID", "weight", "Customer Name")),
    ("new_group_rep_by_highest_weight", ("group name", "Customer ID", "weight")),
])
def test_group_rep_utils_equal(customers_df, fn, args):  # noqa: F811
    args = tuple(a(customers_df) if callable(a) else a for a in args)
    assert_same(getattr(TU, fn)(customers_df, *args), getattr(JU, fn)(customers_df, *args))


@pytest.mark.parametrize("fn,args", [
    ("new_group_rep_by_earliest_timestamp", ("group ID", "Customer ID", "Customer ID")),
    ("new_group_rep_by_highest_weight",
     ("group ID", "Customer ID", lambda df: df["weight"].iloc[:-2])),
    ("new_group_rep_by_completeness",
     ("group ID", "Customer ID", None, lambda df: df.iloc[:-2, :])),
])
def test_group_rep_utils_raise_alike(customers_df, fn, args):  # noqa: F811
    args = tuple(a(customers_df) if callable(a) else a for a in args)
    with pytest.raises(Exception) as want:
        getattr(JU, fn)(customers_df, *args)
    with pytest.raises(Exception) as got:
        getattr(TU, fn)(customers_df, *args)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
