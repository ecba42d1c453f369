"""The frozen generator and the traffic files."""

import hashlib
import json

import numpy as np
import pytest

from portbench.lib import traffic
from portbench.lib.spec import HERE


def _spec(mix):
    return json.loads((HERE / "traffic" / f"{mix}.json").read_text())


def _params(mix, name="master"):
    p = dict(_spec(mix)["lists"][name])
    p.pop("corpus_seed")
    return traffic.generator(p.pop("generator")), p


def _digest(strings):
    return hashlib.sha256("\n".join(strings).encode()).hexdigest()


def test_timed_lists_fixed_check_lists_from_the_seed():
    """The timed lists come from each list's corpus seed: every run seed
    gets the same names (so the same work), in its own orders.  The check
    lists come from the run's seed: the same seed the same lists, another
    seed others, of the same sizes; a run's two lists on streams of their
    own."""
    sizes = {"master": 3000, "new": 500}
    a = traffic.Traffic(_spec("new100k"), sizes, 2**31 + 11)
    a2 = traffic.Traffic(_spec("new100k"), sizes, 2**31 + 11)
    b = traffic.Traffic(_spec("new100k"), sizes, 2**33 + 12)
    ca, ca2, cb = a.check_lists(), a2.check_lists(), b.check_lists()
    for k in ("master", "new"):
        assert list(a.lists[k]) == list(b.lists[k])
        assert not np.array_equal(a.order(1)[k], b.order(1)[k])
        assert list(ca[k]) == list(ca2[k])
        assert list(ca[k]) != list(cb[k]) and list(ca[k]) != list(a.lists[k])
        assert len(ca[k]) == len(cb[k]) == sizes[k]
    assert list(a.lists["master"][:500]) != list(a.lists["new"])
    assert list(ca["master"][:500]) != list(ca["new"])


def test_seed_42_checksums():
    """The copy cannot drift: seed 42's first 1,000 names, of a 1,000-name
    list and of the cells' own timed lists (the new names: corpus seed 7)."""
    small = traffic.Traffic(_spec("clustered"), {"master": 1000}, 1).lists["master"]
    assert _digest(small) == "bedf11f64ddd93a4f064a991a3cf1cc675ea2891365ccfbdaa99caf28f2352b6"
    full = traffic.Traffic(_spec("new100k"), {"master": 663000, "new": 100000}, 5).lists
    assert _digest(full["master"][:1000]) == \
        "18e4cf924c4e955f21407a0c382b214a6ae89efb8b36a1731f264e8066529508"
    assert _digest(full["new"][:1000]) == \
        "0ed59d698fca0e38ff8d1d69d157c1ee9b5f52dade827a9750b01de690ee307d"


def test_the_port_corpus_at_the_clustered_parameters():
    from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

    gen, p = _params("clustered")
    assert gen.generate(4000, np.random.default_rng(42), **p) == \
        synthetic_company_names(4000, 42)


def test_orders_are_seeded_permutations():
    t = traffic.Traffic(_spec("new100k"), {"master": 800, "new": 200}, 5)
    o1, o1b, o2 = t.order(1), t.order(1), t.order(2)
    for k, n in (("master", 800), ("new", 200)):
        assert np.array_equal(np.sort(o1[k]), np.arange(n))
        assert np.array_equal(o1[k], o1b[k])
        assert not np.array_equal(o1[k], o2[k])


def test_unknown_generator_refused():
    spec = _spec("clustered")
    spec["lists"]["master"]["generator"] = "no_such_generator"
    with pytest.raises(FileNotFoundError, match="no_such_generator"):
        traffic.Traffic(spec, {"master": 10}, 1)


def test_mismatched_lists_refused():
    with pytest.raises(ValueError, match="differ"):
        traffic.Traffic(_spec("clustered"), {"master": 10, "new": 10}, 1)
