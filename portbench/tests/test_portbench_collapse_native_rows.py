"""The ``collapse_native_rows`` reader on hand-made window calls."""

from types import SimpleNamespace

import pytest

from portbench.lib.spec import HERE, load_module


def _read(calls):
    reader = load_module(HERE / "metrics" / "collapse_native_rows.py", "metric")
    return reader.read(SimpleNamespace(calls=calls))


def test_mean_of_the_calls_counter():
    calls = [
        {"wall": 1.5, "timings": {"match.collapse_native_rows": 763_000,
                                  "match.collapse": 0.05}},
        {"wall": 1.6, "timings": {"match.collapse_native_rows": 763_000,
                                  "match.collapse": 0.06}},
    ]
    assert _read(calls) == pytest.approx(763_000)


def test_zero_on_the_numpy_route():
    calls = [{"wall": 1.0, "timings": {"match.collapse_native_rows": 0,
                                       "match.collapse": 0.4}}]
    assert _read(calls) == 0


def test_nothing_to_read_without_the_counter():
    # a program without the counter (the collapse's seconds alone), or a
    # call with no match stats: the metric is left out, nothing raises
    assert _read([{"wall": 3.0, "timings": {"match.collapse": 0.4}}]) is None
    assert _read([{"wall": 1.0, "timings": {}}]) is None
    assert _read([]) is None
