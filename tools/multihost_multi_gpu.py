#!/usr/bin/env python3
"""The sharded multi-process tier over distinct GPUs, against one GPU, on
NVIDIA cards, in layouts of the same GPUs and under each group backend.

Run from the repository root on a machine with two or more GPUs:

    python tools/multihost_multi_gpu.py [--layouts 2x2,4x1,...] [--backend B ...]

A layout ``WxK`` is W ``torch.distributed`` ranks (fresh processes of this
script at tcp://127.0.0.1:<free port>), rank r driving GPUs
``r * K .. r * K + K - 1``: with K > 1 as its device slots (``mesh=``
beside ``multihost="sharded"``), with K = 1 as its one device (no mesh:
one rank per GPU).  The default is ``2x(G/2)`` then ``Gx1`` for G GPUs.
``--backend`` names the group's backend: ``nccl`` (the default; the
sharded tier's device tensors take the direct route, NCCL on the cards),
``gloo`` (the host route) or ``cpu:gloo,cuda:nccl``; under a backend with
nccl each rank passes its first GPU as ``device_id``.  Repeat it to run
every layout under each backend in the order given, so ``--layouts
4x1,2x2 --backend nccl --backend gloo --backend gloo --backend nccl``
times both routes in turns.  At 20,000 names and at the 663,000-name
synthetic corpus of chip_smoke.py, each rank's self-join frame must equal
the single-process frame on the first GPU, with ``p1_fused_closed2``
launched on every GPU of the rank (``ops.kernels.LAUNCHES_BY_DEVICE``) and
the replication and exchanges on the backend's route alone
(``multihost.ROUTE_CALLS``).  Walls, the tier's stages, the launches per
GPU, the route calls and the replication and exchange times (host clock
and CUDA events, beside their bytes bound: NVLink 4 between the cards
where ``nvidia-smi topo -m`` shows NVLink, else PCIe; chip_smoke.py's
``spy_routes``), and each exchange split into its all-to-all's wait for
the last rank, the rest of the collective, and the packing before and
the merge and download after it, are printed; the last line is one JSON object with every
run's numbers, the cards' names and power limits and the topology.
"""

import argparse
import json
import os
import re
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


def rank_main(rank: int, world: int, k: int, port: str, out_dir: Path,
              backend: str, link: float) -> int:
    import torch.distributed as dist

    import string_grouper_tpu_torch as sgt
    from chip_smoke import spy_routes
    from string_grouper_tpu_torch.ops import kernels as K
    from string_grouper_tpu_torch.parallel import Mesh
    from string_grouper_tpu_torch.parallel import multihost as MH
    from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

    slots = [torch.device("cuda", rank * k + j) for j in range(k)]
    mesh = Mesh([slots]) if k > 1 else None
    torch.cuda.set_device(slots[0])
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600),
                            **({"device_id": slots[0]} if "nccl" in backend else {}))
    route = MH._route(slots[0])
    threads = max(1, ((os.cpu_count() or 2) - 1) // world)
    tag = f"{world}x{k} {backend}"
    rec = dict(rank=rank, layout=f"{world}x{k}", backend=backend, route=route,
               slots=[str(d) for d in slots], runs={})
    try:
        for label, n in (("frame", N_FRAME), ("full", N_FULL)):
            series = pd.Series(synthetic_company_names(n))
            K.reset_launches()
            MH.reset_route_calls()
            for d in slots:
                torch.cuda.synchronize(d)
            restore, report = spy_routes(MH, link)
            t0 = time.perf_counter()
            try:
                sg = sgt.StringGrouper(series, multihost="sharded",
                                       mesh=mesh, device=slots[0],
                                       number_of_processes=threads).fit()
                frame = sg.get_matches()
            finally:
                restore()
            wall = time.perf_counter() - t0
            pd.testing.assert_frame_equal(
                frame, pd.read_pickle(out_dir / f"want_{label}.pkl"))
            per_gpu = {d: c for (name, d), c in sorted(K.LAUNCHES_BY_DEVICE.items())
                       if name == "p1_fused_closed2"}
            missing = {str(d) for d in slots} - set(per_gpu)
            assert not missing, f"{label}: no p1_fused_closed2 launch on {missing}"
            calls = {f"{r} {op}": c for (r, op), c in MH.ROUTE_CALLS.items()}
            assert set(calls) == {f"{route} replicate", f"{route} exchange"}, calls
            stages = {key: v for key, v in sg.timings.seconds.items()
                      if key.startswith("match.mh_")}
            rec["runs"][label] = dict(rows=len(frame), wall=wall, per_gpu=per_gpu,
                                      launches=dict(K.LAUNCHES), stages=stages,
                                      route_calls=calls, routes=report())
            log(f"{tag} rank {rank}, slots {rec['slots']}, {n} names: the one-GPU "
                f"frame, {len(frame)} rows, {wall:.3f} s; p1_fused_closed2 per GPU "
                f"{per_gpu}; route calls {calls}; replication and exchanges "
                f"{json.dumps(rec['runs'][label]['routes'])}; stages {json.dumps(stages)}")
            del sg, frame
    finally:
        dist.destroy_process_group()
    (out_dir / f"rank_{world}x{k}_{backend}_{rank}.json").write_text(json.dumps(rec))
    return 0


def run_layout(world: int, k: int, backend: str, link: float, out_dir: Path) -> list:
    """``world`` ranks of ``k`` GPUs each; returns the ranks' records."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank",
                               str(r), str(world), str(k), port, str(out_dir),
                               backend, str(link)], env=env)
             for r in range(world)]
    deadline = time.perf_counter() + LIMIT_S
    try:
        rcs = [p.wait(timeout=max(deadline - time.perf_counter(), 1)) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0] * world, f"{world}x{k} {backend}: ranks exited with {rcs}"
    return [json.loads((out_dir / f"rank_{world}x{k}_{backend}_{r}.json").read_text())
            for r in range(world)]


def exchange_split(ranks: list, label: str) -> list:
    """Per exchange of run ``label``, per rank: the all-to-all's wait for
    the last peer to enter it (wall-clock entry instants, one host's
    clock), the collective's CUDA-event time, what remains of it past the
    wait, and the packing before and the merge and download after it."""
    each = [r["runs"][label]["routes"]["exchange"]["all_to_all_each"] for r in ranks]
    split = []
    for i in range(len(each[0])):
        last = max(e[i]["entered_at"] for e in each)
        split.append([dict(wait_ms=(last - e[i]["entered_at"]) * 1e3,
                           collective_ms=e[i]["collective_ms"],
                           past_wait_ms=e[i]["collective_ms"]
                           - (last - e[i]["entered_at"]) * 1e3,
                           before_ms=e[i]["before_ms"], after_ms=e[i]["after_ms"])
                      for e in each])
    return split


def parse_args(argv: list, n_gpu: int):
    """``([(world, k), ...], [backend, ...])``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--layouts", help="WxK,... (default 2x(G/2),Gx1)")
    ap.add_argument("--backend", action="append",
                    choices=("nccl", "gloo", "cpu:gloo,cuda:nccl"))
    args = ap.parse_args(argv)
    if args.layouts:
        layouts = [tuple(int(x) for x in item.split("x"))
                   for item in args.layouts.split(",")]
    else:
        layouts = list(dict.fromkeys([(2, n_gpu // 2), (n_gpu, 1)]))
    for world, k in layouts:
        assert world >= 2 and k >= 1 and world * k <= n_gpu, \
            f"layout {world}x{k} needs {world * k} of the {n_gpu} GPUs"
    return layouts, args.backend or ["nccl"]


def main(argv: list) -> int:
    n_gpu = torch.cuda.device_count()
    if n_gpu < 2:
        print("multihost_multi_gpu: needs two or more CUDA GPUs", file=sys.stderr)
        return 2
    layouts, backends = parse_args(argv, n_gpu)
    import string_grouper_tpu_torch as sgt
    from chip_smoke import PEAK_NVLINK, PEAK_PCIE
    from string_grouper_tpu_torch.ops import _build
    from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

    def smi(*args):
        out = subprocess.run(["nvidia-smi", *args], capture_output=True, text=True,
                             timeout=60)
        return (out.stdout + out.stderr).strip()

    cards = smi("--query-gpu=name,power.limit", "--format=csv,noheader").splitlines()
    # the links between the cards: the topology matrix, or where the
    # machine refuses it, the NVLink status
    topo = smi("topo", "-m") + "\n" + smi("nvlink", "--status")
    nvlink = re.search(r"\bNV\d+\b|Link \d+: [\d.]+ GB/s", topo)
    link = PEAK_NVLINK if nvlink else PEAK_PCIE
    log(f"cards: {cards}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi topo -m, nvlink --status:\n{topo}\n"
        f"link bound between the cards: {link / 1e9:.0f} GB/s")
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
    for backend in backends:
        for world, k in layouts:
            ranks = run_layout(world, k, backend, link, out_dir)
            split = {label: exchange_split(ranks, label) for label in ("frame", "full")}
            for label, exchanges in split.items():
                for i, per_rank in enumerate(exchanges):
                    log(f"{world}x{k} {backend}, {label}, exchange {i}, per rank: "
                        + json.dumps(per_rank))
            runs.append(dict(layout=f"{world}x{k}", backend=backend, ranks=ranks,
                             exchange_split=split))
    print(json.dumps(dict(cards=cards, topo=topo, link_bytes_per_s=link,
                          one_gpu=one_gpu, layouts=runs)))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        a = sys.argv[2:]
        sys.exit(rank_main(int(a[0]), int(a[1]), int(a[2]), a[3], Path(a[4]), a[5],
                           float(a[6])))
    sys.exit(main(sys.argv[1:]))
