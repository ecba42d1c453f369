"""The ``esc_kernel_rows`` reader on hand-made window calls."""

from types import SimpleNamespace

import pytest

from portbench.lib.spec import HERE, load_module


def _read(calls):
    reader = load_module(HERE / "metrics" / "esc_kernel_rows.py", "metric")
    return reader.read(SimpleNamespace(calls=calls))


def test_mean_of_the_calls_counter():
    calls = [
        {"wall": 3.0, "timings": {"match.esc_kernel_rows": 26_000,
                                  "match.esc_rows_r1_kt4": 22_500,
                                  "match.esc_rows_r1_kt16": 3_500}},
        {"wall": 3.1, "timings": {"match.esc_kernel_rows": 26_200,
                                  "match.esc_rows_r1_kt4": 22_700}},
    ]
    assert _read(calls) == pytest.approx(26_100)


def test_zero_when_no_row_ran_on_the_kernel():
    calls = [{"wall": 1.0, "timings": {"match.esc_kernel_rows": 0,
                                       "match.esc_rows_r1_kt64": 40}}]
    assert _read(calls) == 0


def test_nothing_to_read_without_the_counter():
    # a program without the counter (the escalation counters alone), or a
    # call with no match stats: the metric is left out, nothing raises
    assert _read([{"wall": 5.0, "timings": {"match.esc_rows_r1_kt4": 23_000}}]) is None
    assert _read([{"wall": 1.0, "timings": {}}]) is None
    assert _read([]) is None
