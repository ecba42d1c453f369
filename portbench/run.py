#!/usr/bin/env python3
"""The benchmark of string_grouper_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  A run loads the cell's pieces by name (``lib/spec.py``), generates
the mix's timed lists (``lib/traffic.py``: one corpus a mix, so that
every run does the same work), makes one warm call on the full inputs
(set-up ends there), then calls the configuration's entry back to back,
one caller, for ``--seconds`` (every call started before the end runs to
its end).  Each call gets its own permutation of the lists, drawn from
``--seed`` outside its wall.  With ``--trace 1`` one more call runs under
``torch.profiler`` after the window.  Then one check call runs on lists
of the same law and sizes drawn from ``--seed``.  The plain reference
(``reference/``) judges a sample of every window call's answers, drawn
from the seed, one whole answer, and a sample and the whole answer of the
check call.  The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error.

``--control f32`` runs the program with its own float32 path (the control
that has to come out not correct); ``--rehearse-cpu N`` (tests only) skips
the look for a card and runs the port's CPU path on lists cut to N names.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that may not be loaded by a run (names compared whole)
FORBIDDEN = {"jax", "jaxlib", "flax", "string_grouper_tpu", "string_grouper",
             "string_grouper_utils"}
SAMPLE_STREAM = 2_000_003
_DTYPES = {"float32", "float64"}


def _caches(root: Path) -> Path:
    """Fixed cache directories inside the checkout: the port's native
    library (its own default is under the user's cache), and Triton's and
    torch's extension caches should anything use them.  The port's CUDA
    kernels already build into ``build/torch_kernels/`` of the checkout."""
    base = root / "build" / "portbench"
    native = base / "native"
    native.mkdir(parents=True, exist_ok=True, mode=0o700)
    os.chmod(native, 0o700)
    os.environ["STRING_GROUPER_TPU_TORCH_NATIVE_CACHE"] = str(native)
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    return native


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("f32",), default=None)
    p.add_argument("--rehearse-cpu", type=int, default=0, metavar="N")
    return p.parse_args(argv)


def _say(msg: str) -> None:
    print(f"portbench: {msg}", flush=True)


def main(argv=None) -> int:
    args = _parse(argv)
    native_dir = _caches(ROOT)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import pandas as pd
    import torch

    from portbench.lib import machine, spec, traffic
    from portbench.lib import trace as tr
    from portbench.reference import tfidf

    cell = spec.Cell(args.workload, ROOT)
    on_card = not args.rehearse_cpu
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {n}", file=sys.stderr)
        return 2
    card = torch.cuda.get_device_name(0) if on_card else "cpu"
    _say(f"workload {args.workload}, seed {args.seed}, {args.seconds} s, "
         f"trace {args.trace}, control {args.control}")
    _say(f"card {card}; nvidia-smi: {machine.smi() if on_card else 'not asked'}")
    _say(f"host {machine.cpus()}; torch {torch.__version__} "
         f"(CUDA {torch.version.cuda}); python {sys.version.split()[0]}")

    t = time.perf_counter()
    import string_grouper_tpu_torch as sgt
    from string_grouper_tpu_torch.native import get_scorer_lib
    import_s = time.perf_counter() - t
    cached = set(native_dir.glob("*.so"))
    t = time.perf_counter()
    native_ok = get_scorer_lib() is not None
    native_s = time.perf_counter() - t
    native_built = bool(set(native_dir.glob("*.so")) - cached)
    _say(f"import {import_s:.3f} s; native library "
         f"{'built' if native_built else 'from the cache'} in "
         f"{native_s:.3f} s (loaded: {native_ok})")

    cfg = cell.config
    entry = cell.entry
    sizes = {k: int(v) for k, v in cfg["sizes"].items()}
    options = dict(cfg.get("options", {}))
    if args.control == "f32":
        options["tfidf_matrix_dtype"] = "float32"
    if args.rehearse_cpu:
        sizes = {k: min(v, args.rehearse_cpu) for k, v in sizes.items()}
        options["device"] = "cpu"
    for k, v in options.items():
        if k == "tfidf_matrix_dtype" and v in _DTYPES:
            options[k] = getattr(np, v)
    t = time.perf_counter()
    mix = traffic.Traffic(cell.traffic, sizes, args.seed)
    inputs_s = time.perf_counter() - t
    _say(f"inputs {sizes} generated in {inputs_s:.3f} s")

    def inputs(call: int):
        order = mix.order(call)
        return order, {k: pd.Series(mix.lists[k][order[k]]) for k in entry.LISTS}

    _, series = inputs(0)
    t = time.perf_counter()
    answer, grouper = entry.call(sgt, series, options)
    warm_s = time.perf_counter() - t
    del answer, grouper, series
    try:
        from string_grouper_tpu_torch.ops import _build
        nvcc = dict(_build.BUILD_SECONDS)
    except (ImportError, AttributeError):
        nvcc = {}
    setup_s = time.perf_counter() - T0
    # setup_s holds this run's builds (the first run in a checkout builds);
    # they are also reported apart, so a build is told from a slower set-up
    setup_parts = {
        "build_s": sum(nvcc.values()) + (native_s if native_built else 0.0),
        "import_s": import_s, "native_s": native_s, "inputs_s": inputs_s,
        "warm_call_s": warm_s,
    }
    _say(f"warm call {warm_s:.3f} s; nvcc seconds per kernel this run "
         f"(0: built before) { {k: round(v, 3) for k, v in nvcc.items()} }; "
         f"setup {setup_s:.3f} s, of which builds {setup_parts['build_s']:.3f} s")

    # ---------------------------------------------------------------- window
    sem = cfg["semantics"]
    eps = float(cfg["limits"]["sim_gap"])
    per_call = int(cfg["sample_per_call"])
    n_sampled = len(mix.lists[entry.SAMPLED])
    full_at = int(np.random.default_rng([args.seed, SAMPLE_STREAM]).integers(1, 3))
    calls, kept, full = [], [], None
    attempted = failed = malformed = 0
    setup_peak = 0
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    probe = machine.host_probe()
    k = 1
    t_end = time.perf_counter() + args.seconds
    while time.perf_counter() < t_end:
        order, series = inputs(k)
        attempted += 1
        ru = resource.getrusage(resource.RUSAGE_SELF)
        t = time.perf_counter()
        try:
            answer, grouper = entry.call(sgt, series, options)
        except Exception:  # a call that raises is counted, and the run goes on
            traceback.print_exc()
            failed += 1
            k += 1
            continue
        wall = time.perf_counter() - t
        calls.append({"wall": wall, "timings": dict(grouper.timings.seconds),
                      "cpu_per_wall": machine.cpu_per_wall(
                          ru, resource.getrusage(resource.RUSAGE_SELF), wall)})
        sample = np.sort(np.random.default_rng([args.seed, SAMPLE_STREAM, k]).choice(
            n_sampled, size=min(per_call, n_sampled), replace=False))
        try:  # an answer that cannot be read is a wrong answer, and the run goes on
            out = entry.readout(answer, grouper)
            kept.append({"order": order, "sample": sample, **entry.take(out, sample)})
            if full is None or k <= full_at:
                full = (order, out)
            del out
        except Exception:
            traceback.print_exc()
            malformed += 1
        del answer, grouper, series
        k += 1
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    _say(f"host probe {probe:.3f} s before the window, {machine.host_probe():.3f} s after")
    phases = ("encode", "match", "match.p1_wait", "match.esc_wait", "match.rescore",
              "match.collapse", "match.expand", "match.fixups", "assemble")
    _say("median phases (s): " + ", ".join(
        f"{p} {np.median([c['timings'].get(p, 0.0) for c in calls]):.3f}"
        for p in phases if calls))
    _say(f"host CPU seconds per wall second, per call: "
         f"{[round(c['cpu_per_wall'], 3) for c in calls]}")
    _say(f"window: {len(calls)} calls, walls {[round(c['wall'], 3) for c in calls]}, "
         f"escalated rows {[sum(v for n, v in c['timings'].items() if n.startswith('match.esc_rows_r')) for c in calls]}")

    trace = None
    if args.trace:
        _, series = inputs(k)
        t = time.perf_counter()
        (answer, grouper), trace = tr.capture(
            lambda: entry.call(sgt, series, options), on_card)
        del answer, grouper, series
        _say(f"profiled call {trace.wall_s:.3f} s; profiler, export and read "
             f"{time.perf_counter() - t:.3f} s in all, {len(trace.events)} events")

    # the check call: the entry on lists drawn from the seed, outside the
    # window, so that every run judges the program on a corpus of its own
    t = time.perf_counter()
    check_lists = mix.check_lists()
    check_order = {k: np.arange(len(v)) for k, v in check_lists.items()}
    check_sample = np.sort(np.random.default_rng([args.seed, SAMPLE_STREAM, 0]).choice(
        n_sampled, size=min(per_call, n_sampled), replace=False))
    check_out = None
    try:
        answer, grouper = entry.call(
            sgt, {k: pd.Series(check_lists[k]) for k in entry.LISTS}, options)
        check_wall = time.perf_counter() - t
        check_rows = sum(v for n, v in grouper.timings.seconds.items()
                         if n.startswith("match.esc_rows_r"))
        check_out = entry.readout(answer, grouper)
        del answer, grouper
        _say(f"check call on the seed's lists: {check_wall:.3f} s with their "
             f"generation, escalated rows {check_rows}")
    except Exception:
        traceback.print_exc()

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ----------------------------------------------------------- correctness
    t = time.perf_counter()
    corpus = tfidf.build({k: mix.lists[k] for k in entry.LISTS}, sem)
    t_corpus = time.perf_counter() - t
    if kept:
        numbers = entry.judge(corpus, mix.lists, kept, sem, eps,
                              "cuda" if on_card else "cpu")
    else:  # no answer to judge: every number past its limit
        numbers = {name: float(limit) + 1 for name, limit in cfg["limits"].items()}
    t_judge = time.perf_counter() - t - t_corpus
    frame_errs = malformed
    if full is not None:
        order, out = full
        frame_errs += entry.frame_errors(
            out, {k: mix.lists[k][order[k]] for k in entry.LISTS}, sem, eps)
    else:
        frame_errs += 1
    t_whole = time.perf_counter() - t - t_corpus - t_judge
    distinct = {k: int((corpus.mult[k] > 0).sum()) for k in entry.LISTS}
    del full, kept, corpus
    if check_out is None:  # the check call raised or could not be read
        failed_checks = 1
    else:
        failed_checks = 0
        check_corpus = tfidf.build({k: check_lists[k] for k in entry.LISTS}, sem)
        got = entry.judge(check_corpus, check_lists,
                          [{"order": check_order, "sample": check_sample,
                            **entry.take(check_out, check_sample)}],
                          sem, eps, "cuda" if on_card else "cpu")
        for name, v in got.items():
            numbers[name] = max(numbers[name], v) if name == "sim_gap" else numbers[name] + v
        frame_errs += entry.frame_errors(check_out, check_lists, sem, eps)
        del check_corpus, check_out
    numbers["frame_errors"] = frame_errs
    numbers["failed_calls"] = failed + failed_checks
    _say(f"reference and comparison {time.perf_counter() - t:.3f} s (corpus "
         f"{t_corpus:.3f}, sampled rows {t_judge:.3f}, whole answer {t_whole:.3f}, "
         f"the check call's {time.perf_counter() - t - t_corpus - t_judge - t_whole:.3f}), "
         f"{ {k: v for k, v in numbers.items() if k.endswith(('checked', 'matched'))} }")

    # --------------------------------------------------------------- metrics
    run = SimpleNamespace(
        calls=calls, setup_s=setup_s, trace=trace, trace_lib=tr,
        distinct=distinct, self_join=len(entry.LISTS) == 1,
        hash_dim=int(options.get("hash_dim", sem["hash_dim"])),
        peaks=machine.peaks(card), window_peak_bytes=window_peak,
    )
    metrics = {}
    for m in cell.metrics["per_layer" if args.trace else "end_to_end"]:
        value = cell.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device = {"platform": "gpu" if on_card else "cpu", "kind": card,
              "count": cell.chips if on_card else 1,
              "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": None, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = tr.busy_s(trace)
        device["window_s"] = trace.window_s
        result["breakdown"] = tr.breakdown(trace)
    result["setup_parts"] = setup_parts
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in cfg["limits"].items()}
    result["correct"] = bool(calls) and all(
        c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks

    found = forbidden_loaded()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"portbench check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
