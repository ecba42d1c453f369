#!/usr/bin/env python3
"""Wall time of the 663k default self-join, this checkout against another,
in turns, on one NVIDIA GPU.

Run from the repository root:

    python tools/ab_663k_wall.py OTHER_ROOT

OTHER_ROOT is the root of another checkout of the repository, for example
the parent commit unpacked with ``git archive`` into a directory that
.gitignore lists.  Each run is a fresh process that imports
string_grouper_tpu_torch from its own checkout (building that checkout's
kernels into its own build/torch_kernels/), warms up on the first 20,000
names, and then times ``StringGrouper(names).fit().get_matches()`` once on
the 663,000 synthetic names (``synthetic_company_names``), as chip_smoke.py
phase 5 does.  The runs go in the order other, this, this, other.  The last
line is one JSON object with every run's wall, output rows, kernel launches
and phase timings, and the card's name and power limit.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_FULL = 663_000
N_WARM = 20_000


def run_one(root: str) -> dict:
    """One timed run in this process, from the checkout at ``root``."""
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
    names = pd.Series(synthetic_company_names(N_FULL))
    sgt.match_strings(names[:N_WARM])  # kernel build, CUDA start-up
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grouper = sgt.StringGrouper(names).fit()
    frame = grouper.get_matches()
    wall = time.perf_counter() - t0
    return dict(root=root, wall=wall, rows=len(frame),
                launches=dict(K.LAUNCHES), timings=grouper.timings.seconds)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(run_one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = str(Path(sys.argv[1]).resolve())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    runs = []
    for label, root in (("other", other), ("this", str(ROOT)),
                        ("this", str(ROOT)), ("other", other)):
        out = subprocess.run(
            [sys.executable, __file__, "--one", root], capture_output=True,
            text=True, check=True, timeout=600,
        ).stdout.strip().splitlines()[-1]
        res = dict(json.loads(out), label=label)
        print(f"{label}: wall {res['wall']:.3f} s, {res['rows']} rows, "
              f"p1_wait {res['timings']['match.p1_wait']:.3f} s, "
              f"esc_wait {res['timings']['match.esc_wait']:.3f} s; "
              f"launches {res['launches']}", flush=True)
        runs.append(res)
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
