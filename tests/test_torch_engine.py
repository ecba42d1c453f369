"""The port's ``StringGrouper`` lifecycle against the JAX package's, on the
CPU: option and data resets invalidate the fit, the method twins' kwargs
reach the encoder, ``add_match`` / ``remove_match`` sequences leave the same
matches list and groups, and the errors are the same; a fit prefetches
each list's corpus hash once and phase 1 reads it.  Frames are compared
exactly (``check_exact``)."""

import warnings
from unittest import mock

import pandas as pd
import pytest

import string_grouper_tpu as sgj
import string_grouper_tpu_torch as sgt
import string_grouper_tpu_torch.engine as TE
from string_grouper_tpu_torch.corpus.tfidf import EllMatrix
from string_grouper_tpu_torch.ops import kernels as TK
from string_grouper_tpu_torch.ops import matcher as TM
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

from test_reference_conformance import SimpleExample
from test_torch_api import assert_same as frame_eq

CPU = dict(device="cpu")
EX = SimpleExample()


def test_update_options_invalidates_fit():
    s = pd.Series(["abc", "abd", "abe", "xyz"])
    j = sgj.StringGrouper(s, min_similarity=0.1).fit()
    t = sgt.StringGrouper(s, min_similarity=0.1, **CPU).fit()
    frame_eq(t.get_matches(), j.get_matches())
    j.update_options(min_similarity=0.5)
    t.update_options(min_similarity=0.5)
    assert t._config.min_similarity == 0.5 and t._config.device == "cpu"
    for method in ("get_matches", "get_groups"):
        with pytest.raises(sgt.StringGrouperNotFitException):
            getattr(t, method)()
    frame_eq(t.fit().get_matches(), j.fit().get_matches())
    frame_eq(t.get_groups(), j.get_groups())


def test_reset_data_invalidates_fit():
    s, s2 = pd.Series(["abc", "abd"]), pd.Series(["hyper inc", "hyper inc.", "mega"])
    j = sgj.StringGrouper(s, min_similarity=0.1).fit()
    t = sgt.StringGrouper(s, min_similarity=0.1, **CPU).fit()
    j.reset_data(s2)
    t.reset_data(s2)
    with pytest.raises(sgt.StringGrouperNotFitException):
        t.get_matches()
    pd.testing.assert_series_equal(t.master, s2)
    frame_eq(t.fit().get_matches(), j.fit().get_matches())
    frame_eq(t.get_groups(), j.get_groups())


def test_fit_keeps_no_encoded_matrix():
    """A refit starts from fresh ELL matrices: nothing of a fit's encode
    (nor the device hash hanging off its payload) stays on the engine."""
    t = sgt.StringGrouper(pd.Series(["abc", "abd", "x y z"]), **CPU).fit()
    t.fit()
    assert not any(isinstance(v, EllMatrix) for v in vars(t).values())


def test_method_twin_kwargs_reach_the_encoder():
    s = pd.Series(["hyper startup inc", "hyper startups inc", "mega corp"])
    fresh = sgt.StringGrouper(s, ngram_size=2, **CPU).fit().get_matches()
    frame_eq(fresh, sgj.StringGrouper(s, ngram_size=2).fit().get_matches())
    frame_eq(sgt.StringGrouper(s, **CPU).match_strings(s, ngram_size=2), fresh)
    via_update = sgt.StringGrouper(s, **CPU)
    via_update.update_options(ngram_size=2)
    frame_eq(via_update.fit().get_matches(), fresh)


@pytest.mark.parametrize("twin,args,kw", [
    ("match_strings", (EX.customers_df2["Customer Name"],), dict(min_similarity=0.3)),
    ("group_similar_strings", (EX.customers_df["Customer Name"],),
     dict(min_similarity=0.6, group_rep="first")),
    ("match_most_similar", (EX.customers_df["Customer Name"],
                            EX.customers_df2["Customer Name"]), dict(min_similarity=0.6)),
    ("compute_pairwise_similarities", (EX.customers_df["Customer Name"],
                                       EX.expected_result_centroid), dict(ngram_size=2)),
], ids=lambda x: x if isinstance(x, str) else "")
def test_method_twins_equal(twin, args, kw):
    seed = pd.Series(["whatever", "whatever else"])
    j = sgj.StringGrouper(seed)
    t = sgt.StringGrouper(seed, **CPU)
    frame_eq(getattr(t, twin)(*args, **kw), getattr(j, twin)(*args, **kw))
    assert all(getattr(t._config, k) == v for k, v in kw.items())
    assert t._config.device == "cpu"


def test_max_n_matches_rule():
    """The API function forces max_n_matches=1; the method twin keeps what
    it is given (as in the reference)."""
    m, d = EX.customers_df["Customer Name"], EX.customers_df2["Customer Name"]
    with mock.patch("string_grouper_tpu_torch.api.StringGrouper") as sg:
        sgt.match_most_similar(m, d, max_n_matches=20, **CPU)
    assert sg.call_args.kwargs["max_n_matches"] == 1
    t = sgt.StringGrouper(m, **CPU)
    j = sgj.StringGrouper(m)
    got = t.match_most_similar(m, d, max_n_matches=3, min_similarity=0.1)
    assert t._config.max_n_matches == 3
    assert t._matches_list.groupby("master_side").size().max() == 3
    frame_eq(got, j.match_most_similar(m, d, max_n_matches=3, min_similarity=0.1))
    frame_eq(t._matches_list, j._matches_list)


SELF = pd.Series(["foooo", "no match", "baz", "foooo", "foooob"])
CROSS_D = pd.Series(["foooo", "bar", "baz", "foooob"])
EDITS = [
    ("add_match", "no match", "baz"),
    ("add_match", "foooo", "baz"),
    ("remove_match", "foooo", "foooob"),
    ("add_match", "foooob", "no match"),
    ("remove_match", "baz", "foooo"),
]


@pytest.mark.parametrize("dupes", [None, CROSS_D], ids=["self", "cross"])
def test_add_remove_match_sequence(dupes):
    j = sgj.StringGrouper(SELF, dupes, min_similarity=0.5).fit()
    t = sgt.StringGrouper(SELF, dupes, min_similarity=0.5, **CPU).fit()
    for op, a, b in EDITS:
        if dupes is not None and b not in set(CROSS_D):
            b = "bar"
        assert getattr(t, op)(a, b) is t
        getattr(j, op)(a, b)
        frame_eq(t._matches_list, j._matches_list)
        frame_eq(t.get_matches(), j.get_matches())
        frame_eq(t.get_groups(), j.get_groups())


def test_prior_matches_propagate():
    names = pd.Series(["microsoftoffice 365 home", "microsoftoffice 365 pers",
                       "microsoft office"])
    out = {}
    for pkg, kw in ((sgj, {}), (sgt, CPU)):
        sg = pkg.StringGrouper(names, ignore_index=True, **kw).fit()
        sg = sg.add_match("microsoft office", "microsoftoffice 365 home")
        sg = sg.add_match("microsoftoffice 365 pers", "microsoft office")
        out[pkg] = sg.get_groups()
    frame_eq(out[sgt], out[sgj])
    assert out[sgt].nunique() == 1


@pytest.mark.parametrize("dupes", [None, CROSS_D], ids=["self", "cross"])
@pytest.mark.parametrize("a,b", [("doesnt exist", "baz"), ("baz", "doesnt exist")])
def test_missing_string_raises_value_error(dupes, a, b):
    j = sgj.StringGrouper(SELF, dupes).fit()
    t = sgt.StringGrouper(SELF, dupes, **CPU).fit()
    for op in ("add_match", "remove_match"):
        with pytest.raises(ValueError) as want:
            getattr(j, op)(a, b)
        with pytest.raises(ValueError) as got:
            getattr(t, op)(a, b)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("method,args", [
    ("get_matches", ()), ("get_groups", ()),
    ("add_match", ("foooo", "baz")), ("remove_match", ("foooo", "baz")),
])
def test_not_fit_raises(method, args):
    t = sgt.StringGrouper(SELF, **CPU)
    with pytest.raises(sgt.StringGrouperNotFitException, match=method):
        getattr(t, method)(*args)


@pytest.mark.parametrize("kw", [
    {}, dict(ignore_case=False), dict(ngram_size=2), dict(ngram_size=5),
    dict(regex=r"[aeiou]"), dict(normalize_to_ascii=False),
])
def test_n_grams_equal(kw):
    j = sgj.StringGrouper(pd.Series(["aaa"]), **kw)
    t = sgt.StringGrouper(pd.Series(["aaa"]), **kw, **CPU)
    for s in ("McDonalds", "Café Müller GmbH", "Hyper-Startup Inc.", "ab", ""):
        assert t.n_grams(s) == j.n_grams(s)


def test_clear_data():
    t = sgt.StringGrouper(SELF, CROSS_D, **CPU).fit()
    t.clear_data()
    assert t.master is None and t.duplicates is None
    assert t._master_id is None and t._duplicates_id is None
    assert t._matches_list is None and not t.is_build
    with pytest.raises(sgt.StringGrouperNotFitException):
        t.get_matches()
    frame_eq(t.match_strings(SELF, min_similarity=0.5),
             sgj.match_strings(SELF, min_similarity=0.5))


def test_dot_errors_equal():
    """Unequal lengths raise the plain Exception with JAX's message; a
    self-join grouper fails in dot() the way JAX's does."""
    m, short = EX.customers_df["Customer Name"], EX.expected_result_centroid[:-2]
    with pytest.raises(Exception) as want:
        sgj.StringGrouper(m, short).dot()
    with pytest.raises(Exception) as got:
        sgt.StringGrouper(m, short, **CPU).dot()
    assert type(got.value) is type(want.value) is Exception
    assert str(got.value) == str(want.value)
    with pytest.raises(Exception) as want:
        sgj.StringGrouper(m).dot()
    with pytest.raises(Exception) as got:
        sgt.StringGrouper(m, **CPU).dot()
    assert type(got.value) is type(want.value)


def test_topn_slack_warns_only_when_passed():
    s = pd.Series(["abc", "abd"])
    with pytest.warns(DeprecationWarning, match="topn_slack"):
        t = sgt.StringGrouper(s, topn_slack=4, **CPU)
    with pytest.warns(DeprecationWarning, match="topn_slack"):
        t.update_options(topn_slack=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        t.update_options(min_similarity=0.3)  # the merged config holds topn_slack
        sgt.StringGrouper(s, **CPU).match_strings(s, min_similarity=0.2)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(no_such_option=1), TypeError, "no_such_option"),
    (dict(group_rep="nonsense"), Exception, "group_rep"),
    (dict(device="tpu"), ValueError, "device"),
    (dict(hash_dim=3), Exception, "hash_dim"),
])
def test_update_options_validates(kw, exc, match):
    with pytest.raises(exc, match=match):
        sgt.StringGrouper(SELF, **CPU).update_options(**kw)


def test_setters_validate():
    t = sgt.StringGrouper(SELF, **CPU)
    with pytest.raises(TypeError):
        t.master = pd.Series(["a", 1])
    with pytest.raises(TypeError):
        t.duplicates = "not a series"


PREFETCH_NAMES = synthetic_company_names(6300)
PREFETCH_DUPES = synthetic_company_names(4096, seed=7)
PREFETCH_KNOBS = dict(left_chunk=256, right_tile=256)


@pytest.mark.parametrize("retired_knob", [{}, {"SG_TPU_CHUNKED_P1": "1",
                                               "SG_TPU_CHUNKED_P1_GROUPS": "2"}],
                         ids=["knob_unset", "knob_set"])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_fit_prefetches_each_list_once_and_scans_from_it(
        monkeypatch, cross, retired_knob):
    """Every single-device fit prefetches each list's corpus hash exactly
    once, and phase 1 gathers from that prefetch and builds no hash of its
    own: with the fused branch open (``_on_card`` patched), over several
    segments, and whatever the retired column-chunked pipeline's variables
    say.  The frame is the JAX package's."""
    args = [pd.Series(PREFETCH_NAMES)]
    if cross:
        args.append(pd.Series(PREFETCH_DUPES))
    want = sgj.match_strings(*args, **PREFETCH_KNOBS)

    monkeypatch.setattr(TM, "_on_card", lambda device: True)
    # The retired pipeline engaged only from this many rows up: lowered, so
    # that the variables below would have turned it on at this size.
    monkeypatch.setattr(TM, "_CHUNKED_P1_MIN_ROWS", 1000, raising=False)
    for var in ("SG_TPU_CHUNKED_P1", "SG_TPU_CHUNKED_P1_GROUPS"):
        monkeypatch.delenv(var, raising=False)
    for var, value in retired_knob.items():
        monkeypatch.setenv(var, value)
    seen = {}

    def spy(module, name):
        real = getattr(module, name)
        seen[name] = []

        def recorded(*a, **k):
            out = real(*a, **k)
            seen[name].append((a, out))
            return out

        monkeypatch.setattr(module, name, recorded)

    for module, name in ((TE, "prefetch_corpus_hash"),
                         (TM, "_build_hash_from_codes"),
                         (TM, "_prefetched_hash"), (TM, "_device_hash"),
                         (TM, "p1_fused_closed2"), (TK, "p1_fused_chain")):
        spy(module, name)

    got = sgt.match_strings(*args, **CPU, **PREFETCH_KNOBS)

    n_lists = len(args)
    prefetched = {id(a[0]) for a, _ in seen["prefetch_corpus_hash"]}
    assert len(seen["prefetch_corpus_hash"]) == len(prefetched) == n_lists
    # the prefetch worker's builds, one a list, and no other
    assert len(seen["_build_hash_from_codes"]) == n_lists
    assert not seen["_device_hash"]
    gathers = seen["_prefetched_hash"]
    assert gathers and all(out is not None for _, out in gathers)
    assert len({id(a[0]) for a, _ in gathers}) == n_lists
    assert seen["p1_fused_closed2"] and not seen["p1_fused_chain"]
    frame_eq(got, want)
