"""The plain reference against the port's CPU path, and the reference's
parts alone.  (The test imports the port; the reference does not.)"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from portbench.entries import match_most_similar as nearest_entry
from portbench.entries import match_strings as self_entry
from portbench.lib import traffic
from portbench.lib.spec import HERE
from portbench.reference import nearest, selfjoin, tfidf, topn

NO, MAYBE, YES = topn.NO, topn.MAYBE, topn.YES


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _lists(mix, sizes, seed):
    spec = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    return traffic.Traffic(spec, sizes, seed)


def test_tfidf_against_scikit_learn():
    sk = pytest.importorskip("sklearn.feature_extraction.text")
    sem = _cfg("edgar_dedup")["semantics"]
    strings = ["Hyper Startup Inc.", "Hyper-Startup Inc.", "Mega Corp.", "mega corp",
               "Café Müller GmbH", "Cafe Muller GmbH", "ab", "Startup Hyper Inc"]
    import re
    import unicodedata

    def grams(s):
        s = unicodedata.normalize("NFKD", s.lower()).encode("ASCII", "ignore").decode()
        s = re.sub(sem["regex"], "", s)
        return ["".join(g) for g in zip(*[s[i:] for i in range(3)])]

    x = sk.TfidfVectorizer(min_df=1, analyzer=grams).fit_transform(strings)
    want = (x @ x.T).toarray()
    corpus = tfidf.build({"master": strings}, sem)
    cos = tfidf.Cosines(corpus, "master", "cpu")
    cls = corpus.cls["master"]
    got = cos.columns(np.arange(corpus.n_classes)).numpy()
    full = np.zeros_like(want)
    rows = cos.rows
    at = {c: i for i, c in enumerate(rows)}
    for i in range(len(strings)):
        for j in range(len(strings)):
            full[i, j] = got[at[cls[i]], cls[j]]
    assert np.max(np.abs(full - want)) < 1e-12


def test_column_status_ties_and_bands():
    mult = np.array([3, 1, 1, 1])
    cls = np.array([0, 1, 2, 3])
    vals = np.array([1.0, 0.95, 0.9, 0.85])
    # class 0's three names tie: the first two are in a top 2, the third not
    st = topn.column_status(cls, vals, mult, 0, 1.0, np.arange(3), 2, 0.8, 1e-10)
    assert list(st) == [YES, YES, NO]
    # class 2 behind 3 + 1 names: out of a top 4, in a top 5
    assert topn.column_status(cls, vals, mult, 2, 0.9, [0], 4, 0.8, 1e-10)[0] == NO
    assert topn.column_status(cls, vals, mult, 2, 0.9, [0], 5, 0.8, 1e-10)[0] == YES
    # a different class within eps of the cut: either order is accepted
    near = np.array([1.0, 0.9, 0.9 + 1e-12, 0.85])
    assert topn.column_status(cls, near, mult, 1, 0.9, [0], 4, 0.8, 1e-10)[0] == MAYBE
    # on the threshold within eps, and below it
    assert topn.column_status(cls, vals, mult, 3, 0.8 + 1e-12, [0], 20, 0.8, 1e-10)[0] == MAYBE
    assert topn.column_status(cls, vals, mult, 3, 0.79, [0], 20, 0.8, 1e-10)[0] == NO
    assert list(topn.either(np.array([NO, NO, MAYBE, YES]),
                            np.array([NO, MAYBE, MAYBE, NO]))) == [NO, MAYBE, MAYBE, YES]


def _judge_self(frame, mix, sem, eps):
    names = mix.lists["master"]
    n = len(names)
    sample = np.arange(n)
    calls = [{"order": {"master": np.arange(n)}, "sample": sample,
              **self_entry.take(frame, sample)}]
    corpus = tfidf.build({"master": names}, sem)
    out = self_entry.judge(corpus, mix.lists, calls, sem, eps, "cpu")
    out["frame_errors"] = selfjoin.frame_errors(frame, names, sem, eps)
    return out


def test_self_join_reference_equals_port_cpu_path():
    import string_grouper_tpu_torch as sgt

    cfg = _cfg("edgar_dedup")
    sem, eps = cfg["semantics"], cfg["limits"]["sim_gap"]
    mix = _lists("clustered", {"master": 2000}, 2**31 + 5)
    frame = sgt.StringGrouper(pd.Series(mix.lists["master"]), device="cpu").fit().get_matches()
    out = _judge_self(frame, mix, sem, eps)
    assert out["rows_checked"] == 2000
    assert out["sim_gap"] <= 1e-14
    assert out["wrong_pairs"] == 0 and out["frame_errors"] == 0
    # and a frame with one similarity moved is caught by both numbers
    bad = frame.copy()
    at = int(np.flatnonzero(bad["left_index"] != bad["right_index"])[0])
    bad.loc[at, "similarity"] += 1e-6
    out = _judge_self(bad, mix, sem, eps)
    assert out["sim_gap"] > 1e-7 and out["frame_errors"] > 0


def _judge_link(out_pair, mix, sem, eps):
    lists = mix.lists
    n_new = len(lists["new"])
    order = {k: np.arange(len(v)) for k, v in lists.items()}
    sample = np.arange(n_new)
    calls = [{"order": order, "sample": sample, **nearest_entry.take(out_pair, sample)}]
    corpus = tfidf.build({k: lists[k] for k in ("master", "new")}, sem)
    res = nearest_entry.judge(corpus, lists, calls, sem, eps, "cpu")
    res["frame_errors"] = nearest_entry.frame_errors(out_pair, lists, sem, eps)
    return res


def test_link_reference_equals_port_cpu_path():
    import string_grouper_tpu_torch as sgt

    cfg = _cfg("edgar_link")
    sem, eps = cfg["semantics"], cfg["limits"]["sim_gap"]
    mix = _lists("new100k", {"master": 2000, "new": 300}, 2**31 + 6)
    # half the new names are registry names in another case: sure matches
    rng = np.random.default_rng(1)
    mix.lists["new"] = np.concatenate(
        [mix.lists["new"],
         np.array([s.upper() for s in rng.choice(mix.lists["master"], 300)], dtype=object)])
    sg = sgt.StringGrouper(pd.Series(mix.lists["master"]),
                           duplicates=pd.Series(mix.lists["new"]),
                           max_n_matches=1, device="cpu")
    answer = sg.fit().get_groups()
    out_pair = (answer, sg.get_matches())
    res = _judge_link(out_pair, mix, sem, eps)
    assert res["rows_checked"] == 600
    assert res["sim_gap"] <= 1e-14
    assert res["wrong_pairs"] == 0 and res["wrong_nearest"] == 0
    assert res["frame_errors"] == 0
    # an answer moved to another master is caught
    bad = answer.copy()
    hit = np.flatnonzero(~np.isnan(bad["most_similar_index"].to_numpy(dtype=float)))[0]
    bad.iloc[hit, 0] = (bad.iloc[hit, 0] + 1) % 2000
    res = _judge_link((bad, out_pair[1]), mix, sem, eps)
    assert res["wrong_nearest"] >= 1 and res["frame_errors"] >= 1


@pytest.mark.cuda
def test_reference_cosines_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the reference's card product needs one")
    sem = _cfg("edgar_dedup")["semantics"]
    mix = _lists("clustered", {"master": 5000}, 9)
    corpus = tfidf.build({"master": mix.lists["master"]}, sem)
    q = np.arange(0, corpus.n_classes, 7)
    cpu = tfidf.Cosines(corpus, "master", "cpu").columns(q)
    card = tfidf.Cosines(corpus, "master", "cuda").columns(q).cpu()
    assert float((cpu - card).abs().max()) < 1e-14
