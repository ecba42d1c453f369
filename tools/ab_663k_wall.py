#!/usr/bin/env python3
"""Wall time of the 663k default self-join, this checkout against another,
or this checkout at the default hash width against another ``hash_dim``,
in turns, on one NVIDIA GPU.

Run from the repository root:

    python tools/ab_663k_wall.py [--rounds N] OTHER_ROOT
    python tools/ab_663k_wall.py [--rounds N] --hash-dim D

OTHER_ROOT is the root of another checkout of the repository, for example
the parent commit unpacked with ``git archive`` into a directory that
.gitignore lists.  Each run is a fresh process that imports
string_grouper_tpu_torch from its own checkout (building that checkout's
kernels into its own build/torch_kernels/), warms up on the first 20,000
names, and then times ``StringGrouper(names).fit().get_matches()`` once on
the 663,000 synthetic names (``synthetic_company_names``), as chip_smoke.py
phase 5 does.  With ``--hash-dim D`` both sides are this checkout: "other"
at the default ``hash_dim``, "this" at ``hash_dim=D`` (its warm-up too).
The runs go in the order other, this, this, other, N times (default 1).
The last line is one JSON object with every run's wall, output rows, kernel
launches and phase timings, and the card's name and power limit.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_FULL = 663_000
N_WARM = 20_000


def run_one(root: str, hash_dim: int) -> dict:
    """One timed run in this process, from the checkout at ``root``, at
    ``hash_dim`` (0: the default)."""
    sys.path.insert(0, root)
    import pandas as pd
    import torch

    import string_grouper_tpu_torch as sgt
    from string_grouper_tpu_torch.ops import kernels as K
    from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

    pkg = Path(sgt.__file__).resolve()
    if Path(root).resolve() not in pkg.parents:
        raise RuntimeError(f"imported {pkg}, not the checkout at {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU visible")
    kw = dict(hash_dim=hash_dim) if hash_dim else {}
    names = pd.Series(synthetic_company_names(N_FULL))
    sgt.match_strings(names[:N_WARM], **kw)  # kernel build, CUDA start-up
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grouper = sgt.StringGrouper(names, **kw).fit()
    frame = grouper.get_matches()
    wall = time.perf_counter() - t0
    return dict(root=root, hash_dim=hash_dim, wall=wall, rows=len(frame),
                launches=dict(K.LAUNCHES), timings=grouper.timings.seconds)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print(json.dumps(run_one(sys.argv[2], int(sys.argv[3]))), flush=True)
        return 0
    args = sys.argv[1:]
    rounds = 1
    if args[:1] == ["--rounds"] and len(args) >= 2:
        rounds, args = int(args[1]), args[2:]
    if len(args) == 2 and args[0] == "--hash-dim":
        other, this = (str(ROOT), 0), (str(ROOT), int(args[1]))
    elif len(args) == 1:
        other, this = (str(Path(args[0]).resolve()), 0), (str(ROOT), 0)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    runs = []
    order = (("other", other), ("this", this), ("this", this), ("other", other))
    for label, (root, hash_dim) in order * rounds:
        out = subprocess.run(
            [sys.executable, __file__, "--one", root, str(hash_dim)],
            capture_output=True, text=True, check=True, timeout=600,
        ).stdout.strip().splitlines()[-1]
        res = dict(json.loads(out), label=label)
        print(f"{label} (hash_dim {hash_dim or 'default'}): wall {res['wall']:.3f} s, "
              f"{res['rows']} rows, "
              f"p1_wait {res['timings']['match.p1_wait']:.3f} s, "
              f"esc_wait {res['timings']['match.esc_wait']:.3f} s; "
              f"launches {res['launches']}", flush=True)
        runs.append(res)
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
