"""The port's one span helper (``utils.profiling.span``, behind
``PhaseTimings.phase`` and every stage timer of the matcher and the
multi-process tiers), on the CPU.

* With no profiler recording, a span adds its seconds and enters no
  ``record_function``: neither alone nor anywhere in a fit and its frame.
* Under ``torch.profiler`` a self-join that escalates shows each span as
  an ``sg.<name>`` range: the calling thread's under ``sg.match``, the
  scoring and download workers' on their own threads.  Each ``timings``
  key equals the summed durations of its ranges, within 5 ms + 10%.
* A fit's ``timings`` keeps every key it had before the spans, and adds
  ``frame`` and ``match.rescore_wait``.
"""

import json
import re

import pandas as pd
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

import string_grouper_tpu_torch as sgt
from string_grouper_tpu_torch.utils import profiling as P
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

#: near-duplicate clusters: the collapse finds duplicates, and at 256-row
#: chunks the first pass leaves rows to escalate
NAMES = pd.Series(synthetic_company_names(3_000))
KW = dict(device="cpu", left_chunk=256, right_tile=256)
ESC_ROWS = re.compile(r"match\.esc_rows_r\d+_kt\d+")

#: ranges opened on the calling thread inside ``sg.match``, with the
#: ``timings`` key each adds into
MATCH_RANGES = {
    "sg.match.collapse": "match.collapse",
    "sg.match.p1_setup": "match.p1_setup",
    "sg.match.p1_wait": "match.p1_wait",
    "sg.match.esc_dispatch": "match.esc_wait",
    "sg.match.esc_finish": "match.esc_wait",
    "sg.match.rescore_wait": "match.rescore_wait",
    "sg.match.rescore": "match.rescore",
    "sg.match.select": "match.select",
    "sg.match.expand": "match.expand",
    "sg.match.fixups": "match.fixups",
}
#: calling-thread ranges outside ``sg.match`` (``sg.validate``, the
#: constructor's check of the inputs, marks the trace only)
TOP_RANGES = {"sg.encode": "encode", "sg.match": "match",
              "sg.assemble": "assemble", "sg.frame": "frame", "sg.validate": None}
#: the keys a self-join's ``timings`` had before the spans (besides the
#: per-rung ``match.esc_rows_r<round>_kt<k>`` counters)
KEYS_BEFORE = {
    "encode", "match", "assemble", "match.collapse", "match.p1_setup",
    "match.p1_wait", "match.esc_wait", "match.rescore", "match.select",
    "match.rounds", "match.pairs_scored", "match.expand", "match.fixups",
}


def _close(seconds, ranges_us):
    return abs(seconds - ranges_us / 1e6) <= 0.005 + 0.1 * seconds


def _traced(fn, tmp_path):
    """``fn()`` under a CPU profiler that records every thread; returns
    its result and the trace's ``sg.*`` ranges."""
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation" and e["name"].startswith("sg.")]
    return out, ranges


def _fit_and_frame(**kw):
    sg = sgt.StringGrouper(NAMES, **KW, **kw)
    sg.fit().get_matches()
    return sg


@pytest.fixture
def no_ranges(monkeypatch):
    """Any ``record_function`` entered from here on raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_span_adds_seconds_without_a_profiler(no_ranges):
    assert not autograd_profiler._is_profiler_enabled
    seconds = {"a": 1.0}
    with P.span("a", seconds):
        pass
    with P.span("stage", seconds, "b"):
        pass
    with P.span("range_only"):
        pass
    with pytest.raises(KeyError):  # the seconds still add when the block raises
        with P.span("c", seconds):
            raise KeyError("c")
    assert set(seconds) == {"a", "b", "c"}
    assert 1.0 <= seconds["a"] < 1.1
    assert 0.0 <= seconds["b"] < 0.1 and 0.0 <= seconds["c"] < 0.1
    t = P.PhaseTimings()
    with t.phase("encode"):
        pass
    with t.phase("encode"):
        pass
    assert list(t.seconds) == ["encode"] and 0.0 <= t.seconds["encode"] < 0.1


@pytest.mark.parametrize("tier", [None, True, "sharded"])
def test_fit_enters_no_range_without_a_profiler(no_ranges, tier):
    kw = {} if tier is None else dict(multihost=tier)
    sg = _fit_and_frame(**kw)
    assert sg.timings.seconds["frame"] > 0.0


def test_escalating_self_join_ranges_match_its_timings(tmp_path):
    sg, ranges = _traced(_fit_and_frame, tmp_path)
    secs = sg.timings.seconds
    assert any(ESC_ROWS.fullmatch(k) and v > 0 for k, v in secs.items()), secs
    (match,) = [r for r in ranges if r["name"] == "sg.match"]
    caller = match["tid"]
    mine = [r for r in ranges if r["tid"] == caller]
    workers = [r for r in ranges if r["tid"] != caller]
    names = {r["name"] for r in mine}
    assert set(MATCH_RANGES) | set(TOP_RANGES) <= names, names
    lo, hi = match["ts"], match["ts"] + match["dur"]
    for r in mine:  # the match's stages nest in sg.match (1 us of rounding)
        if r["name"] in MATCH_RANGES:
            assert lo - 1 <= r["ts"] and r["ts"] + r["dur"] <= hi + 1, r
    (validate,) = [r for r in mine if r["name"] == "sg.validate"]
    assert validate["ts"] + validate["dur"] <= min(
        r["ts"] for r in mine if r["name"] == "sg.encode")
    # the scoring worker's rescore and selection, and the escalation's
    # downloads, open their ranges on their own threads
    assert {"sg.match.rescore", "sg.match.select",
            "sg.match.esc_download"} <= {r["name"] for r in workers}
    assert not {r["name"] for r in workers} & {"sg.match.rescore_wait", "sg.match"}

    def summed(rs, key):
        return sum(r["dur"] for r in rs
                   if {**MATCH_RANGES, **TOP_RANGES}.get(r["name"]) == key)

    for key in (set(MATCH_RANGES.values()) | set(TOP_RANGES.values())) - {None}:
        # rescore and select add up both threads' time, as before
        rs = ranges if key in ("match.rescore", "match.select") else mine
        assert _close(secs[key], summed(rs, key)), (key, secs[key], summed(rs, key))


def test_timings_keys_before_the_spans_plus_frame_and_rescore_wait():
    secs = _fit_and_frame().timings.seconds
    rungs = {k for k in secs if ESC_ROWS.fullmatch(k)}
    assert rungs
    # and the count of escalated rows that ran on p1_fused_topk: none here;
    # and of the rows the native duplicate grouping grouped: all of them
    assert set(secs) - rungs == KEYS_BEFORE | {"frame", "match.rescore_wait",
                                               "match.esc_kernel_rows",
                                               "match.collapse_native_rows"}
    assert secs["match.esc_kernel_rows"] == 0
    assert secs["match.collapse_native_rows"] == len(NAMES)
    assert isinstance(secs["match.rounds"], int)
    assert isinstance(secs["match.pairs_scored"], int)


@pytest.mark.parametrize("tier", [True, "sharded"])
def test_multihost_stage_ranges_match_their_timings(tmp_path, tier):
    sg, ranges = _traced(lambda: sgt.StringGrouper(
        NAMES[:600], multihost=tier, **KW).fit(), tmp_path)
    secs = sg.timings.seconds
    (match,) = [r for r in ranges if r["name"] == "sg.match"]
    mine = [r for r in ranges if r["tid"] == match["tid"]]
    stages = {k for k in secs if re.fullmatch(r"match\.mh_(\w+_)?s", k)}
    assert "match.mh_match_s" in stages or "match.mh_p1_s" in stages, secs
    for key in stages:
        dur = sum(r["dur"] for r in mine if r["name"] == f"sg.{key}")
        assert _close(secs[key], dur), (key, secs[key], dur)
    if tier == "sharded":  # the device collectives' ranges
        assert {"sg.match.mh_replicate", "sg.match.mh_exchange"} <= {
            r["name"] for r in mine}


def test_the_ports_trace_records_the_workers_ranges(tmp_path):
    """``utils.profiling.trace`` records every thread: the trace file holds
    the scoring and download workers' ranges beside the calling thread's."""
    with P.trace(log_dir=str(tmp_path)):
        _fit_and_frame()
    (path,) = P.trace_files(str(tmp_path))
    ranges = [e for e in P.read_trace(path) if e.get("ph") == "X"
              and e.get("cat") == "user_annotation" and e["name"].startswith("sg.")]
    (match,) = [r for r in ranges if r["name"] == "sg.match"]
    assert {"sg.match.rescore", "sg.match.esc_download"} <= {
        r["name"] for r in ranges if r["tid"] != match["tid"]}
