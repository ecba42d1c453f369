#!/usr/bin/env python3
"""The mesh tier over distinct GPUs of one host, against the single-GPU
path, on NVIDIA cards.

Run from the repository root on a machine with two or more GPUs:

    python tools/mesh_multi_gpu.py

Every visible GPU joins the mesh.  At 20,000 names ``match_strings`` under
``make_mesh(n, dp=dp)`` for every ``dp`` that divides the GPU count must
give the single-GPU frame, with ``p1_fused_closed2`` launched on every GPU
of the mesh (``ops.kernels.LAUNCHES_BY_DEVICE``, counted at each launch).
Then the 663,000-name self-join (the synthetic corpus of chip_smoke.py)
runs on one GPU, on a (2, n / 2) mesh of distinct
GPUs and on a (2, n / 2) virtual mesh over the first GPU, in that order:
rows, frame equality with the single-GPU run, wall, phases and launches
are printed.  The last line is one JSON object with every run's numbers
and the cards' names and power limits.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pandas as pd
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

N_FRAME = 20_000
N_FULL = 663_000
ROWS_FULL = 4_558_752


def log(*args):
    print(*args, flush=True)


def run(devices, n_frame: int, n_full: int, rows_full=None) -> dict:
    """The comparisons over ``devices`` (one per mesh slot, all of one
    type); returns the numbers of every run."""
    import string_grouper_tpu_torch as sgt
    from string_grouper_tpu_torch.ops import kernels as K
    from string_grouper_tpu_torch.parallel import Mesh
    from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

    kind = devices[0].type
    n = len(devices)

    def p1_per_device() -> dict:
        """``p1_fused_closed2`` launches per device since the last reset."""
        return {d: c for (k, d), c in sorted(K.LAUNCHES_BY_DEVICE.items())
                if k == "p1_fused_closed2"}

    out = dict(n_devices=n, frames={}, full={})
    s20 = pd.Series(synthetic_company_names(n_frame))
    want = sgt.match_strings(s20, device=kind)
    for dp in [d for d in range(1, n + 1) if n % d == 0]:
        mesh = Mesh([devices[i * (n // dp):(i + 1) * (n // dp)]
                     for i in range(dp)])
        K.reset_launches()
        t0 = time.perf_counter()
        got = sgt.match_strings(s20, device=kind, mesh=mesh)
        wall = time.perf_counter() - t0
        pd.testing.assert_frame_equal(got, want)
        per_device = p1_per_device()
        if kind == "cuda":
            missing = {str(d) for d in devices} - set(per_device)
            assert not missing, f"mesh {mesh.shape}: no kernel on {missing}"
        out["frames"][str(mesh.shape)] = dict(wall=wall, per_device=per_device)
        log(f"{n_frame} names, mesh {mesh.shape}: the single-device frame, "
            f"{len(got)} rows, {wall:.3f} s; p1_fused_closed2 per device "
            f"{per_device}")

    s_full = pd.Series(synthetic_company_names(n_full))
    half = n // 2
    runs = (
        ("one device", {}),
        (f"(2, {half}) mesh of distinct devices",
         dict(mesh=Mesh([devices[:half], devices[half:2 * half]]))),
        (f"(2, {half}) virtual mesh over {devices[0]}",
         dict(mesh=Mesh([[devices[0]] * half] * 2))),
    )
    base = None
    for label, kw in runs:
        K.reset_launches()
        if kind == "cuda":
            for d in devices:
                torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        grouper = sgt.StringGrouper(s_full, device=kind, **kw).fit()
        frame = grouper.get_matches()
        wall = time.perf_counter() - t0
        if base is None:
            base = frame
        else:
            pd.testing.assert_frame_equal(frame, base)
        if rows_full is not None:
            assert len(frame) == rows_full, f"{label}: {len(frame)} rows"
        assert np.isfinite(frame.similarity.to_numpy()).all()
        secs = dict(grouper.timings.seconds)
        out["full"][label] = dict(wall=wall, rows=len(frame),
                                  launches=dict(K.LAUNCHES),
                                  per_device=p1_per_device(), timings=secs)
        log(f"{n_full} names, {label}: {len(frame)} rows (frame equal to "
            f"the one-device run's), wall {wall:.3f} s, encode "
            f"{secs['encode']:.3f} s, match.p1_wait {secs['match.p1_wait']:.3f}"
            f" s, match.esc_wait {secs['match.esc_wait']:.3f} s; launches "
            f"{dict(K.LAUNCHES)}; p1_fused_closed2 per device {p1_per_device()}")
        del grouper, frame
    return out


def main() -> int:
    if torch.cuda.device_count() < 2:
        print("mesh_multi_gpu: needs two or more CUDA GPUs", file=sys.stderr)
        return 2
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(f"cards: {cards}; torch {torch.__version__} cuda {torch.version.cuda}")
    from string_grouper_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    log(f"nvcc build: {time.perf_counter() - t0:.1f} s")
    devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    out = run(devices, N_FRAME, N_FULL, ROWS_FULL)
    out["cards"] = cards
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
