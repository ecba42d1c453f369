"""``utils.profiling.trace`` (the port of string_grouper_tpu/utils/
profiling.py:53-65) and its trace readers, on the CPU: a traced self-join
writes a trace file under the given directory and returns the untraced
frame; a trace inside a trace raises; the readers find the device
intervals and kernel durations of a trace's events and measure their union
(what tools/trace_663k.py and chip_smoke.py read on the card)."""

import inspect

import pandas as pd
import pytest

import string_grouper_tpu_torch as sgt
from string_grouper_tpu.utils import profiling as JP
from string_grouper_tpu_torch.utils import profiling as P
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names


def test_traced_self_join_writes_a_trace_and_returns_the_untraced_frame(tmp_path):
    names = pd.Series(synthetic_company_names(2_000))
    want = sgt.match_strings(names, device="cpu")
    with P.trace(log_dir=str(tmp_path)):
        got = sgt.match_strings(names, device="cpu")
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    files = P.trace_files(str(tmp_path))
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = P.read_trace(files[0])
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert any(e["name"] == "aten::mm" for e in ops)  # the torch-op scan's products
    assert P.device_intervals(events) == []  # no device on the CPU


def test_nested_trace_raises_and_the_outer_one_still_writes(tmp_path):
    with P.trace(log_dir=str(tmp_path)):
        with pytest.raises(RuntimeError, match="already running"):
            with P.trace(log_dir=str(tmp_path / "inner")):
                pass
    assert len(P.trace_files(str(tmp_path))) == 1
    with P.trace(log_dir=str(tmp_path)):  # free again after the outer one
        pass
    assert len(P.trace_files(str(tmp_path))) == 2


def test_trace_signature_is_jax_s():
    assert inspect.signature(P.trace) == inspect.signature(JP.trace)


EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "k1", "ts": 5, "dur": 10},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 20, "dur": 5},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 40, "dur": 2},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100},
    {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 1},
]


def test_device_intervals_union_and_kernel_durations():
    iv = P.device_intervals(EVENTS)
    assert iv == [(0.0, 10.0), (5.0, 15.0), (20.0, 25.0), (40.0, 42.0)]
    assert P.union_us(iv) == 22.0  # the two kernels overlap for 5 us
    assert P.union_us(iv, window=(8.0, 41.0)) == 13.0
    assert P.union_us([]) == 0.0
    assert P.kernel_durations(EVENTS) == {"k1": [10.0, 10.0]}
    assert P.device_intervals(EVENTS, cats=("gpu_memcpy",)) == [(20.0, 25.0)]
