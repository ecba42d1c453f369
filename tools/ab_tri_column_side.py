#!/usr/bin/env python3
"""A/B of ``p1_tri_fused``'s column side on one NVIDIA GPU.

Run from the repository root:

    python tools/ab_tri_column_side.py

At chip_smoke.py phase 3c's shape (segment 0: A 32,768 x B 131,072 hash
rows of the synthetic corpus, d 512, tile 4096, C 64, block_m 512, the
default threshold) it builds variants of csrc/p1_tri_fused.cu from textual
edits of csrc/p1_scan_sm90.cuh (into build/ab_tri/) and times one launch of
each (CUDA events, mean of 10 after a warm-up), in turns, forward and back:

  shipped         the kernel as it is
  no_column_side  kTri without the column side: the row side, plus the fold
                  over statistics left at zero
  no_max_atomics  the column side without its two max atomics (count and
                  row sum only)
  no_flush        the column side without the last-warp flush (nothing
                  written to the statistics)
  closed2         p1_fused_closed2 on the same A and B (the square's pass)

The three probes give wrong statistics; they only locate the time.  The
last line is one JSON object with every variant's times.
"""

import ctypes
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
from string_grouper_tpu_torch.ops import _build  # noqa: E402
from string_grouper_tpu_torch.ops import kernels as K  # noqa: E402
from string_grouper_tpu_torch.ops import matcher as M  # noqa: E402
from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names  # noqa: E402

CSRC = ROOT / "string_grouper_tpu_torch" / "csrc"
OUT = ROOT / "build" / "ab_tri"
N, SEG, TILE, C, BM, D = 131_072, 32_768, 4096, 64, 512, 512

EDITS = {
    "shipped": [],
    "no_column_side": [(
        "const bool col_side = MODE == kTri && col0 >= p.fut_start;",
        "const bool col_side = false;",
    )],
    "no_max_atomics": [(
        "  const unsigned long long old = atomicMax(&cs->key[col], k);\n"
        "  atomicMax(&cs->v2[col], old > k ? o : static_cast<uint32_t>(old >> 32));\n",
        "",
    )],
    "no_flush": [("  if (col_side) {\n    int* done", "  if (false) {\n    int* done")],
}


def build_variants():
    header = (CSRC / "p1_scan_sm90.cuh").read_text()
    procs = {}
    for name, edits in EDITS.items():
        text = header
        for old, new in edits:
            assert text.count(old) == 1, f"{name}: edit does not apply"
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "p1_scan_sm90.cuh").write_text(text)
        shutil.copy(CSRC / "p1_tri_fused.cu", d / "p1_tri_fused.cu")
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "p1_tri_fused.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log.decode(errors="replace")
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).p1_tri_fused
        fn.argtypes = _build._ARGTYPES["p1_tri_fused"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def cuda_ms(fn, reps=10):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_tri_column_side: no CUDA GPU visible", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    fns = build_variants()
    src = TfidfEncoder(StringGrouperConfig()).fit_transform(
        synthetic_company_names(N)).device_src
    h = M._build_hash_from_codes(src, N, D, dev)
    thr = float(M.effective_threshold(0.8))
    a, b = h[:SEG].contiguous(), h.contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    size = (SEG // 128) * (N - SEG)
    rv = torch.empty((SEG, C), device=dev)
    rc = torch.empty((SEG, C), dtype=torch.int32, device=dev)
    rm = torch.empty((SEG, 8), device=dev)
    fpack = K.tri_future_init(N, dev)
    st_i = torch.zeros((3, size), dtype=torch.int32, device=dev)
    st_f = torch.zeros((2, size), device=dev)

    def tri(fn):
        err = fn(a.data_ptr(), b.data_ptr(), thr, 0, SEG, N, D, TILE, C, BM,
                 rv.data_ptr(), rc.data_ptr(), rm.data_ptr(), fpack.data_ptr(),
                 st_i.data_ptr(), st_f.data_ptr(), stream)
        _build.check("p1_tri_fused", err)

    closed = _build.load("p1_fused_closed2").p1_fused_closed2
    out = [torch.empty((SEG, C), dtype=torch.int32, device=dev),
           torch.empty(SEG, dtype=torch.int32, device=dev),
           torch.empty(SEG, dtype=torch.int32, device=dev),
           torch.empty(SEG, device=dev), torch.empty((SEG, C), device=dev)]

    def closed2():
        err = closed(a.data_ptr(), b.data_ptr(), thr, SEG, N, D, TILE, C,
                     *[t.data_ptr() for t in out], stream)
        _build.check("p1_fused_closed2", err)

    runs = {name: (lambda fn=fn: tri(fn)) for name, fn in fns.items()}
    runs["closed2"] = closed2
    order = list(runs) + list(reversed(list(runs)))
    times = {name: [] for name in runs}
    for name in order:
        times[name].append(cuda_ms(runs[name]))
    for name, t in times.items():
        print(f"{name}: {t} ms")
    print(card)
    print(json.dumps({"card": card, "shape": dict(n=N, seg_rows=SEG, d=D, tile=TILE,
                                                   cand_c=C, block_m=BM),
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
