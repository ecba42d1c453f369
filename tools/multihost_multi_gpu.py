#!/usr/bin/env python3
"""The sharded multi-process tier over distinct GPUs, against one GPU, on
NVIDIA cards, in two layouts of the same GPUs.

Run from the repository root on a machine with two or more GPUs:

    python tools/multihost_multi_gpu.py [--layouts 2x2,4x1,...]

A layout ``WxK`` is W ``torch.distributed`` ranks (fresh processes of this
script, gloo at tcp://127.0.0.1:<free port>), rank r driving GPUs
``r * K .. r * K + K - 1``: with K > 1 as its device slots (``mesh=``
beside ``multihost="sharded"``), with K = 1 as its one device (no mesh:
one rank per GPU).  The default is ``2x(G/2)`` then ``Gx1`` for G GPUs;
layouts run in the order given, so ``2x2,4x1,4x1,2x2`` times both twice.
At 20,000 names and at the 663,000-name synthetic corpus of
chip_smoke.py, each rank's self-join frame must equal the single-process
frame on the first GPU, with ``p1_fused_closed2`` launched on every GPU of
the rank (``ops.kernels.LAUNCHES_BY_DEVICE``).  Walls, the tier's stages
and the launches per GPU are printed; the last line is one JSON object
with every run's numbers and the cards' names and power limits.
"""

import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import pandas as pd
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N_FRAME = 20_000
N_FULL = 663_000
ROWS_FULL = 4_558_752
LIMIT_S = 900


def log(*args):
    print(*args, flush=True)


def rank_main(rank: int, world: int, k: int, port: str, out_dir: Path) -> int:
    import torch.distributed as dist

    import string_grouper_tpu_torch as sgt
    from string_grouper_tpu_torch.ops import kernels as K
    from string_grouper_tpu_torch.parallel import Mesh
    from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

    slots = [torch.device("cuda", rank * k + j) for j in range(k)]
    mesh = Mesh([slots]) if k > 1 else None
    torch.cuda.set_device(slots[0])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    threads = max(1, ((os.cpu_count() or 2) - 1) // world)
    rec = dict(rank=rank, layout=f"{world}x{k}", slots=[str(d) for d in slots],
               runs={})
    try:
        for label, n in (("frame", N_FRAME), ("full", N_FULL)):
            series = pd.Series(synthetic_company_names(n))
            K.reset_launches()
            for d in slots:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            sg = sgt.StringGrouper(series, multihost="sharded",
                                   mesh=mesh, device=slots[0],
                                   number_of_processes=threads).fit()
            frame = sg.get_matches()
            wall = time.perf_counter() - t0
            pd.testing.assert_frame_equal(
                frame, pd.read_pickle(out_dir / f"want_{label}.pkl"))
            per_gpu = {d: c for (name, d), c in sorted(K.LAUNCHES_BY_DEVICE.items())
                       if name == "p1_fused_closed2"}
            missing = {str(d) for d in slots} - set(per_gpu)
            assert not missing, f"{label}: no p1_fused_closed2 launch on {missing}"
            stages = {key: v for key, v in sg.timings.seconds.items()
                      if key.startswith("match.mh_")}
            rec["runs"][label] = dict(rows=len(frame), wall=wall, per_gpu=per_gpu,
                                      launches=dict(K.LAUNCHES), stages=stages)
            log(f"{world}x{k} rank {rank}, slots {rec['slots']}, {n} names: the one-GPU frame, "
                f"{len(frame)} rows, {wall:.3f} s; p1_fused_closed2 per GPU "
                f"{per_gpu}; stages {json.dumps(stages)}")
            del sg, frame
    finally:
        dist.destroy_process_group()
    (out_dir / f"rank_{world}x{k}_{rank}.json").write_text(json.dumps(rec))
    return 0


def run_layout(world: int, k: int, out_dir: Path) -> list:
    """``world`` ranks of ``k`` GPUs each; returns the ranks' records."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank",
                               str(r), str(world), str(k), port, str(out_dir)],
                              env=env)
             for r in range(world)]
    deadline = time.perf_counter() + LIMIT_S
    try:
        rcs = [p.wait(timeout=max(deadline - time.perf_counter(), 1)) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0] * world, f"{world}x{k}: ranks exited with {rcs}"
    return [json.loads((out_dir / f"rank_{world}x{k}_{r}.json").read_text())
            for r in range(world)]


def parse_layouts(argv: list, n_gpu: int) -> list:
    """``[(world, k), ...]`` from ``--layouts WxK,...`` (default 2x(G/2),Gx1)."""
    if argv[:1] == ["--layouts"]:
        layouts = [tuple(int(x) for x in item.split("x"))
                   for item in argv[1].split(",")]
    else:
        layouts = list(dict.fromkeys([(2, n_gpu // 2), (n_gpu, 1)]))
    for world, k in layouts:
        assert world >= 2 and k >= 1 and world * k <= n_gpu, \
            f"layout {world}x{k} needs {world * k} of the {n_gpu} GPUs"
    return layouts


def main(argv: list) -> int:
    n_gpu = torch.cuda.device_count()
    if n_gpu < 2:
        print("multihost_multi_gpu: needs two or more CUDA GPUs", file=sys.stderr)
        return 2
    layouts = parse_layouts(argv, n_gpu)
    import string_grouper_tpu_torch as sgt
    from string_grouper_tpu_torch.ops import _build
    from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(f"cards: {cards}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build()
    log(f"nvcc build: {time.perf_counter() - t0:.1f} s")
    out_dir = ROOT / "build" / "multihost_multi_gpu"
    out_dir.mkdir(parents=True, exist_ok=True)
    one_gpu = {}
    for label, n in (("frame", N_FRAME), ("full", N_FULL)):
        t0 = time.perf_counter()
        want = sgt.match_strings(pd.Series(synthetic_company_names(n)))
        one_gpu[label] = dict(rows=len(want), wall=time.perf_counter() - t0)
        if n == N_FULL:
            assert len(want) == ROWS_FULL, f"{len(want)} rows"
        want.to_pickle(out_dir / f"want_{label}.pkl")
        log(f"one GPU, {n} names: {len(want)} rows, {one_gpu[label]['wall']:.3f} s")
        del want

    runs = []
    for world, k in layouts:
        runs.append(dict(layout=f"{world}x{k}", ranks=run_layout(world, k, out_dir)))
    print(json.dumps(dict(cards=cards, one_gpu=one_gpu, layouts=runs)))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        a = sys.argv[2:]
        sys.exit(rank_main(int(a[0]), int(a[1]), int(a[2]), a[3], Path(a[4])))
    sys.exit(main(sys.argv[1:]))
