#!/usr/bin/env python3
"""A/B of the fused phase-1 scan's epilogue on one NVIDIA GPU: the
counterpart of the JAX package's probe benchmarks/ab_p1_epilogue.py.

Run from the repository root:

    python tools/ab_p1_epilogue.py [--reps N]

At the probe's shape (A 32,768 x B 663,552 x 512, tile 4096, C 64), on two
inputs:

  a  the probe's own: |N(0,1)| * 0.04 in bf16 from a seeded
     torch.Generator (each of A and B its own draw), thr 0.78.  Its scores
     sit near 0.52: no score qualifies, so no row pays for the epilogue
     past its per-sub-block max.
  b  hash rows of synthetic_company_names(663_000) (as
     tools/ab_tri_column_side.py builds them): A the first 32,768 rows, B
     all 663,000 rows zero-padded to 663,552, at the default effective
     threshold -- what the main path scans.

Variants, in turns forward and back:

  closed2          p1_fused_closed2, the shipped kernel
  mm_floor         p1_mm_floor: the same product and the qualified count only
  variant_<R>_<T>  p1_closed2_variant at block rows R in (128, 64) and tie
                   rule T in (first, minidx)
  torch_mm         torch.mm bf16 over the same columns, in column blocks
                   into one preallocated output (the library yardstick)

For each: the CUDA-event mean of every turn; the kernel's own span, read
from a utils.profiling.trace of the same launches (kernels named
``scan_kernel`` for the hand kernels, every kernel for torch_mm; the mean
over the calls the trace holds); the
operations bound 2*m*n*d at 989 TF/s and the share bound / time; the
qualified count; and identical=, bitwise against p1_fused_closed2 (ship,
counts, tmax, bound; counts alone for mm_floor; null for torch_mm).  A
variant that is not identical fails the script.  The epilogue's share on
each input is (closed2 - mm_floor) / closed2 of the CUDA-event means.  The
last line is one JSON object.
"""

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from string_grouper_tpu_torch.config import StringGrouperConfig  # noqa: E402
from string_grouper_tpu_torch.corpus import TfidfEncoder  # noqa: E402
from string_grouper_tpu_torch.ops import kernels as K  # noqa: E402
from string_grouper_tpu_torch.ops import matcher as M  # noqa: E402
from string_grouper_tpu_torch.utils import profiling as P  # noqa: E402
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names  # noqa: E402

M_ROWS, N_COLS, D, TILE, C = 32_768, 663_552, 512, 4096, 64
N_CORPUS = 663_000
PEAK_BF16 = 989e12
MM_BLOCKS = 4  # torch.mm's column blocks: 32,768 x 165,888 bf16 = 10.9 GB each
TRACE_DIR = ROOT / "build" / "ab_p1_epilogue_trace"


def probe_inputs(dev):
    """Input (a): ``jnp.abs(normal).astype(bf16) * bf16(0.04)``, A and B
    each from its own seeded generator."""
    scale = torch.tensor(0.04, dtype=torch.bfloat16, device=dev)

    def draw(rows, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        x = torch.randn((rows, D), generator=g, device=dev)
        return x.abs().to(torch.bfloat16) * scale

    return draw(M_ROWS, 0), draw(N_COLS, 1), 0.78


def hash_inputs(dev):
    """Input (b): hash rows of the 663k corpus."""
    src = TfidfEncoder(StringGrouperConfig()).fit_transform(
        synthetic_company_names(N_CORPUS)).device_src
    h = M._build_hash_from_codes(src, N_CORPUS, D, dev)
    b = torch.zeros((N_COLS, D), dtype=torch.bfloat16, device=dev)
    b[:N_CORPUS] = h
    return h[:M_ROWS].contiguous(), b, float(M.effective_threshold(0.8))


def variants(a, b, thr):
    out = torch.empty((M_ROWS, N_COLS // MM_BLOCKS), dtype=torch.bfloat16,
                      device=a.device)
    step = N_COLS // MM_BLOCKS

    def mm():
        for lo in range(0, N_COLS, step):
            torch.mm(a, b[lo:lo + step].t(), out=out)

    runs = {
        "closed2": lambda: K.p1_fused_closed2(a, b, thr, TILE, C),
        "mm_floor": lambda: K.p1_mm_floor(a, b, thr),
    }
    for rows in K.VARIANT_BLOCK_ROWS:
        for tie in K.VARIANT_ARGMAX:
            runs[f"variant_{rows}_{tie}"] = (
                lambda rows=rows, tie=tie: K.p1_closed2_variant(a, b, thr, TILE, C, rows, tie))
    runs["torch_mm"] = mm
    return runs


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def trace_ms(name, fn, reps, per_call):
    """Mean per call of the device time of the call's kernels, read from a
    trace of ``reps`` calls, and the number of calls the trace holds:
    ``per_call`` kernels a call (torch_mm: its column blocks, every kernel
    counted), else the hand kernels' ``scan_kernel``, one a call.  The
    mean is over the calls found: a trace may miss the first launches
    after the profiler starts."""
    log_dir = TRACE_DIR / name
    shutil.rmtree(log_dir, ignore_errors=True)
    fn()
    torch.cuda.synchronize()
    with P.trace(log_dir=str(log_dir)):
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = P.kernel_durations(P.read_trace(P.trace_files(str(log_dir))[-1]))
    keep = [d for k, ds in durs.items() for d in ds
            if per_call > 1 or "scan_kernel" in k]
    calls = len(keep) / per_call
    assert calls >= 1, f"{name}: no call in its trace ({sorted(durs)})"
    return sum(keep) / calls / 1e3, calls


def run_input(label, a, b, thr, reps):
    runs = variants(a, b, thr)
    ref = [x.clone() for x in runs["closed2"]()[:4]]
    identical, qualified = {}, {}
    for name, fn in runs.items():
        if name == "torch_mm":
            identical[name] = None
            continue
        got = fn()
        torch.cuda.synchronize()
        if name == "mm_floor":
            identical[name] = bool(torch.equal(got, ref[1]))
            qualified[name] = int(got.sum())
        else:
            identical[name] = all(torch.equal(g, r) for g, r in zip(got[:4], ref))
            qualified[name] = int(got[1].sum())
    order = list(runs) + list(reversed(list(runs)))
    times = {name: [] for name in runs}
    for name in order:
        times[name].append(cuda_ms(runs[name], reps))
    spans = {name: trace_ms(f"{label}_{name}", fn, max(3, reps // 2),
                            MM_BLOCKS if name == "torch_mm" else 1)
             for name, fn in runs.items()}
    bound = 2.0 * M_ROWS * N_COLS * D / PEAK_BF16 * 1e3
    rows = {}
    for name in runs:
        ms = sum(times[name]) / len(times[name])
        span, calls = spans[name]
        rows[name] = dict(ms=times[name], ms_mean=ms, trace_ms=span, trace_calls=calls,
                          bound_ms=bound, share=bound / ms,
                          qualified=qualified.get(name), identical=identical[name])
        print(f"input {label} {name}: ms {times[name]} (mean {ms:.3f}), trace span "
              f"{span:.3f} ms over {calls:g} calls, bound {bound:.3f} ms, share {bound / ms:.3f}, "
              f"qualified {qualified.get(name)}, identical={identical[name]}", flush=True)
    share = (rows["closed2"]["ms_mean"] - rows["mm_floor"]["ms_mean"]) / rows["closed2"]["ms_mean"]
    print(f"input {label}: epilogue share (closed2 - mm_floor) / closed2 = {share:.4f}",
          flush=True)
    bad = [n for n, ok in identical.items() if ok is False]
    assert not bad, f"input {label}: not identical to p1_fused_closed2: {bad}"
    return dict(thr=thr, variants=rows, epilogue_share=share)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10, help="launches per turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_p1_epilogue: no CUDA GPU visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    result = {}
    for label, make in (("a", probe_inputs), ("b", hash_inputs)):
        a, b, thr = make(dev)
        result[label] = run_input(label, a, b, thr, args.reps)
        del a, b
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "shape": dict(m=M_ROWS, n=N_COLS, d=D, tile=TILE,
                                                   cand_c=C), "inputs": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
