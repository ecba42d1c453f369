"""Metric readers on hand-made runs: the roofline's counts from shapes,
the idle-share arithmetic and the breakdown on a hand-made event list."""

from types import SimpleNamespace

import pytest

from portbench.lib import machine
from portbench.lib import trace as tr
from portbench.lib.spec import HERE, load_module

H100 = machine.peaks("NVIDIA H100 80GB HBM3")


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", "metric")


def _ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": float(ts), "dur": float(dur), "tid": 1}


def _trace(events, window=(0.0, 1_000_000.0)):
    return tr.Trace(events=events, window=window, wall_s=(window[1] - window[0]) / 1e6)


def _run(trace=None, distinct=None, self_join=True, calls=()):
    return SimpleNamespace(calls=list(calls), setup_s=1.0, trace=trace, trace_lib=tr,
                           distinct=distinct or {"master": 1000}, self_join=self_join,
                           hash_dim=512, peaks=H100, window_peak_bytes=3 * 2**30)


def test_peaks_table():
    assert H100["bf16_dense_flop_per_s"] == 989.0e12
    assert machine.peaks("some other card") is None


def test_scan_roofline_counts_the_triangle_and_the_cross_product():
    # self-join of n distinct strings: n (n + 1) / 2 pairs x 512 x 2 flops
    n = 568_804
    least = n * (n + 1) / 2 * 512 * 2 / 989e12
    scan = [_ev("kernel", "void p1h::scan_kernel<0, 128, 0, false>(...)", 0, 400_000),
            _ev("kernel", "tri_fold_kernel", 500_000, 100_000),
            _ev("kernel", "device_hash_codes_kernel", 700_000, 50_000)]
    got = reader("scan_roofline").read(_run(_trace(scan), {"master": n}))
    assert got == pytest.approx(100 * least / 0.5)
    assert 30 < got < 35  # the square scan of 0.5 s reads about a third
    # cross-join: L x R pairs
    cross = reader("scan_roofline").read(
        _run(_trace(scan), {"master": 568_000, "new": 97_000}, self_join=False))
    assert cross == pytest.approx(100 * 568_000 * 97_000 * 1024 / 989e12 / 0.5)
    # no scan kernel, no trace, no peak: nothing to read
    assert reader("scan_roofline").read(_run(_trace(scan[2:]))) is None
    assert reader("scan_roofline").read(_run(None)) is None


def test_idle_share_and_breakdown_on_hand_made_events():
    ev = [
        _ev("kernel", "k_a", 100_000, 200_000),       # 0.10-0.30 s
        _ev("kernel", "k_b", 200_000, 200_000),       # 0.20-0.40, overlaps k_a
        _ev("gpu_memcpy", "Memcpy DtoH", 600_000, 100_000),   # 0.60-0.70
        _ev("gpu_memset", "Memset", 950_000, 100_000),         # runs past the window
        _ev("kernel", "k_a", -50_000, 20_000),        # before the window
        _ev("cpu_op", "aten::nonzero", 390_000, 250_000),     # covers the gap 0.4-0.6
        _ev("cpu_op", "aten::outer", 380_000, 300_000),       # covers it too, longer
        _ev("user_annotation", "portbench.call", 0, 1_000_000),
    ]
    t = _trace(ev)
    assert tr.busy_s(t) == pytest.approx(0.30 + 0.10 + 0.05)
    assert reader("device_idle").read(_run(t)) == pytest.approx(55.0)
    gaps = tr.idle_gaps(t)
    assert gaps == [(0.0, 100_000.0), (400_000.0, 600_000.0), (700_000.0, 950_000.0)]
    bd = tr.breakdown(t)
    assert bd["device_ops"][:2] == [["k_a", pytest.approx(0.2)], ["k_b", pytest.approx(0.2)]]
    assert [g[0] for g in bd["idle_gaps"]] == [
        "host code outside any profiled operation", "aten::nonzero",
        "host code outside any profiled operation"]
    assert [g[1] for g in bd["idle_gaps"]] == pytest.approx([0.25, 0.2, 0.1])


def test_host_readers_average_the_window_calls():
    calls = [
        {"wall": 5.0, "timings": {"encode": 0.4, "match": 4.0, "match.p1_wait": 0.3,
                                  "match.esc_wait": 2.5, "match.rescore": 0.7,
                                  "match.select": 0.2, "match.collapse": 0.4,
                                  "match.expand": 0.1, "match.fixups": 0.3,
                                  "match.pairs_scored": 8000,
                                  "match.esc_rows_r1_kt4": 20000,
                                  "match.esc_rows_r2_kt16": 3000}},
        {"wall": 6.0, "timings": {"encode": 0.6, "match": 4.4, "match.p1_wait": 0.5,
                                  "match.esc_wait": 2.7, "match.rescore": 0.9,
                                  "match.select": 0.2, "match.collapse": 0.5,
                                  "match.expand": 0.1, "match.pairs_scored": 8000,
                                  "match.esc_rows_r1_kt4": 22000}},
    ]
    run = _run(calls=calls)
    want = {"call_s": 5.5, "encode_s": 0.5, "p1_wait_s": 0.4, "esc_wait_s": 2.6,
            "esc_rows": 22500, "rescore_s": 1.0, "pairs_scored": 8000,
            "collapse_s": 0.7, "frame_s": 0.8, "setup_s": 1.0, "device_peak_gib": 3.0}
    for name, value in want.items():
        assert reader(name).read(run) == pytest.approx(value), name
    bare = _run(calls=[{"wall": 1.0, "timings": {}}])
    for name in ("encode_s", "esc_rows", "rescore_s", "frame_s", "device_idle"):
        assert reader(name).read(bare) is None, name
