"""One rank of the port's sharded tier on a seeded corpus, for
tests/test_torch_multihost_reference.py.

Run as: python torch_mh_reference_worker.py <rank> <world> <port> <out_dir> <case>

Joins a gloo group at tcp://127.0.0.1:<port>, makes the case's corpus
(:func:`corpus`), runs ``StringGrouper(names, multihost="sharded",
device="cpu").fit().get_matches()`` and writes the frame to
``<out_dir>/<case>_<rank>.pkl`` and the fit's ``match.mh_*`` timings and
the route calls to ``<out_dir>/<case>_<rank>.json``; then prints
'REF_OK <rank>'.  Imports the port and the benchmark's generator, no JAX.
"""

import json
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pandas as pd
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.lib import traffic  # noqa: E402
from string_grouper_tpu_torch import StringGrouper  # noqa: E402
from string_grouper_tpu_torch.parallel import multihost as MH  # noqa: E402

N = 3000
SEED = 20261018
#: a shift of the alphabet per quarter of the ``local`` corpus
SHIFT = 7


def _clustered(n: int, seed: int) -> list:
    params = json.loads((ROOT / "portbench/traffic/clustered.json").read_text())
    params = dict(params["lists"]["master"])
    gen = traffic.generator(params.pop("generator"))
    del params["corpus_seed"]
    return gen.generate(n, np.random.default_rng(seed), **params)


def _shifted(name: str, by: int) -> str:
    return "".join(chr((ord(c) - 97 + by) % 26 + 97) if "a" <= c <= "z" else c
                   for c in name.lower())


def corpus(case: str, world: int) -> pd.Series:
    """``clustered``: the benchmark's clustered names, near duplicates
    anywhere in the list.  ``local``: one quarter a rank's shard, each
    quarter's names on an alphabet shifted by its own amount, so that no
    pair crosses two shards."""
    if case == "clustered":
        return pd.Series(_clustered(N, SEED))
    per = N // world
    return pd.Series([_shifted(s, SHIFT * q) for q in range(world)
                      for s in _clustered(per, SEED + q)])


def main():
    rank, world, port, out_dir, case = (int(sys.argv[1]), int(sys.argv[2]),
                                        sys.argv[3], Path(sys.argv[4]), sys.argv[5])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        MH.reset_route_calls()
        sg = StringGrouper(corpus(case, world), multihost="sharded", device="cpu",
                           number_of_processes=1).fit()
        frame = sg.get_matches()
    finally:
        dist.destroy_process_group()
    frame.to_pickle(out_dir / f"{case}_{rank}.pkl")
    (out_dir / f"{case}_{rank}.json").write_text(json.dumps({
        "timings": {k: v for k, v in sg.timings.seconds.items() if k.startswith("match.mh_")},
        "route_calls": {f"{r} {op}": c for (r, op), c in MH.ROUTE_CALLS.items()},
    }))
    print(f"REF_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
