"""The readers of the program's own ranges on hand-made events: the idle
stretches split by the calling thread's innermost ``sg.*`` range (another
thread's ranges do not count), the six splits adding up to the call's
idle seconds, the escalation's device time inside its ranges' device
extents, and what each reads with no spans, no device events or no trace."""

from types import SimpleNamespace

import pytest

from portbench.lib import spans
from portbench.lib import trace as tr
from portbench.lib.spec import HERE, load_module

IDLE = ("encode_idle_s", "p1_idle_s", "esc_idle_s", "rescore_idle_s", "tail_idle_s",
        "other_idle_s")


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", "metric")


def _ev(cat, name, ts, dur, tid):
    return {"cat": cat, "name": name, "ts": float(ts), "dur": float(dur), "tid": tid}


def _host(name, ts, dur, tid=1):
    return _ev("user_annotation", name, ts, dur, tid)


CALL = [_host("portbench.call", 0, 1_000_000)]
#: the calling thread's ranges (thread 1), times in microseconds
RANGES = [
    _host("sg.validate", 0, 40_000),
    _host("sg.encode", 40_000, 160_000),
    _host("sg.match", 200_000, 600_000),
    _host("sg.match.p1_wait", 200_000, 100_000),
    _host("sg.match.esc_dispatch", 300_000, 50_000),
    _host("sg.match.rescore_wait", 350_000, 50_000),
    _host("sg.match.esc_finish", 450_000, 150_000),
    _host("sg.match.fixups", 700_000, 50_000),
    _host("sg.frame", 850_000, 100_000),
    # a worker thread's ranges: they hold no idle of the calling thread
    _host("sg.match.rescore", 300_000, 400_000, tid=2),
    _host("sg.match.esc_download", 500_000, 60_000, tid=2),
]
DEVICE = [
    _ev("kernel", "hash", 50_000, 100_000, 7),              # under sg.encode
    _ev("kernel", "scan_kernel", 190_000, 90_000, 7),       # across encode / p1_wait
    _ev("kernel", "esc_scan", 320_000, 20_000, 7),          # the escalation's product
    _ev("kernel", "other_stream", 325_000, 10_000, 9),      # inside it in time only
    _ev("gpu_memcpy", "Memcpy DtoH", 520_000, 20_000, 8),   # the escalation's download
    _ev("kernel", "groups", 900_000, 20_000, 7),            # under sg.frame
]
EXTENTS = [
    _ev("gpu_user_annotation", "sg.match.p1_wait", 190_000, 90_000, 7),
    _ev("gpu_user_annotation", "sg.match.esc_dispatch", 320_000, 20_000, 7),
    _ev("gpu_user_annotation", "sg.match.esc_download", 520_000, 20_000, 8),
]
#: idle seconds per reader: busy 0.25 s of the 1 s window
WANT = {
    "encode_idle_s": 0.04 + 0.01 + 0.04,           # sg.validate, then sg.encode
    "p1_idle_s": 0.02,
    "esc_idle_s": 0.03 + 0.13,
    "rescore_idle_s": 0.05,
    "tail_idle_s": 0.05 + 0.08,
    # sg.match alone 0.40-0.45, 0.60-0.70, 0.75-0.80; no range 0.80-0.85, 0.95-1.0
    "other_idle_s": 0.05 + 0.10 + 0.05 + 0.05 + 0.05,
}


def _run(events, calls=({"wall": 1.0, "timings": {}},)):
    trace = tr.Trace(events=events, window=(0.0, 1_000_000.0), wall_s=1.0)
    return SimpleNamespace(calls=list(calls), trace=trace, trace_lib=tr)


def test_idle_split_by_the_calling_threads_innermost_range():
    run = _run(CALL + RANGES + DEVICE + EXTENTS)
    assert spans.calling_tid(run.trace) == 1
    got = {name: reader(name).read(run) for name in IDLE}
    assert got == pytest.approx(WANT)
    idle = (1.0 - tr.busy_s(run.trace) / run.trace.window_s) * run.trace.window_s
    assert tr.busy_s(run.trace) == pytest.approx(0.25)
    assert sum(got.values()) == pytest.approx(idle)


def test_escalation_busy_inside_its_extents_on_their_streams():
    run = _run(CALL + RANGES + DEVICE + EXTENTS)
    # the product (stream 7) and the download (stream 8); neither the scan
    # under p1_wait's extent nor stream 9's kernel inside it in time
    assert reader("esc_busy_s").read(run) == pytest.approx(0.04)
    assert reader("esc_busy_s").read(run) <= tr.busy_s(run.trace)
    # an extent that runs past the window counts inside the window only
    late = [_ev("kernel", "esc_scan", 990_000, 30_000, 7),
            _ev("gpu_user_annotation", "sg.match.esc_dispatch", 990_000, 30_000, 7)]
    assert reader("esc_busy_s").read(_run(CALL + late)) == pytest.approx(0.01)


def test_innermost_cuts_an_overrunning_child_at_its_parent():
    got = spans.innermost([(0, 10, "p"), (2, 5, "c"), (6, 12, "d"), (20, 30, "q")],
                          (0, 40))
    assert got == [(0, 2, "p"), (2, 5, "c"), (5, 6, "p"), (6, 10, "d"),
                   (10, 20, None), (20, 30, "q"), (30, 40, None)]
    assert spans.innermost([], (0, 5)) == [(0, 5, None)]


def test_no_spans_no_device_no_trace():
    bare = _run(CALL + DEVICE)       # a program without spans
    cpu = _run(CALL + RANGES)        # the CPU: no device event
    for name in IDLE + ("esc_busy_s",):
        assert reader(name).read(bare) == 0.0, name
        assert reader(name).read(cpu) == 0.0, name
        assert reader(name).read(SimpleNamespace(calls=bare.calls, trace=None)) is None
        assert reader(name).read(_run(CALL + RANGES + DEVICE, calls=())) is None


def test_span_timings_average_the_window_calls():
    calls = [{"wall": 2.0, "timings": {"assemble": 0.1, "frame": 0.5,
                                       "match.rescore_wait": 0.2}},
             {"wall": 2.0, "timings": {"assemble": 0.3, "frame": 0.3,
                                       "match.rescore_wait": 0.0}}]
    run = SimpleNamespace(calls=calls, trace=None)
    assert reader("frame_build_s").read(run) == pytest.approx(0.6)
    assert reader("rescore_wait_s").read(run) == pytest.approx(0.1)
    # a program whose timings lack the keys: nothing to read
    old = SimpleNamespace(calls=[{"wall": 1.0, "timings": {"assemble": 0.1}}], trace=None)
    assert reader("frame_build_s").read(old) is None
    assert reader("rescore_wait_s").read(old) is None
