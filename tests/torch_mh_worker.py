"""One rank of the port's shard-local multi-process pipeline
(tests/test_torch_multihost.py; the port's form of tests/mh_worker.py).

Run as: python torch_mh_worker.py <rank> <world> <port> <out_dir>

Joins a gloo group at tcp://127.0.0.1:<port>.  Each rank feeds the pipeline
ONLY its shard of the corpus strings; the full corpus is regenerated
locally purely to build the verification oracle (the port's single-process
encoder and matcher).  Writes its encode block and pair lists to
``<out_dir>/shard_<rank>.npz`` for the test to hold against the JAX package,
and prints 'WORKER_ENCODE_OK <rank>', 'WORKER_OK <rank>' and
'WORKER_ESC_OK <rank>'.  ``MH_SLOTS=k`` gives each rank k cpu device slots
(``mesh=``).  Imports only the port.
"""

import os
import sys
from datetime import timedelta

import numpy as np
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from string_grouper_tpu_torch.config import StringGrouperConfig  # noqa: E402
from string_grouper_tpu_torch.corpus import TfidfEncoder  # noqa: E402
from string_grouper_tpu_torch.ops.matcher import (  # noqa: E402
    _pad_width,
    topn_cosine_matches,
)
from string_grouper_tpu_torch.parallel import make_mesh  # noqa: E402
from string_grouper_tpu_torch.parallel.multihost import (  # noqa: E402
    multihost_encode_shard,
    multihost_match_shard,
)

MIN_SIM, MAX_N = 0.5, 5


def corpus(n, seed=5):
    """tests/mh_worker.py's corpus, element for element."""
    rng = np.random.default_rng(seed)
    stems = ["hyper", "mega", "quantum", "global", "acme", "stellar",
             "apex", "vertex", "summit", "cascade"]
    kinds = ["industries", "holdings", "systems", "partners"]
    out = []
    for _ in range(n):
        s = f"{rng.choice(stems)} {rng.choice(stems)} {rng.choice(kinds)}"
        if rng.random() < 0.4:
            pos = int(rng.integers(0, len(s)))
            s = s[:pos] + s[pos + 1:]
        out.append(s)
    return out


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=timedelta(seconds=60),
    )
    try:
        run(rank, world, out_dir)
    finally:
        dist.destroy_process_group()


def run(rank, world, out_dir):
    full = corpus(int(os.environ.get("MH_N", "120")))
    n_total = len(full)
    per = -(-n_total // world)
    lo, hi = rank * per, min((rank + 1) * per, n_total)
    shard = full[lo:hi]  # the ONLY strings this rank feeds the pipeline

    # MH_NGRAM=9 forces the byte-key vocabulary path (8 bits x 9 > 64).
    config = StringGrouperConfig(
        min_similarity=MIN_SIM, ngram_size=int(os.environ.get("MH_NGRAM", "3")),
        device="cpu",
    )
    local_ell, idf, n_docs = multihost_encode_shard(shard, config)
    assert n_docs == n_total

    # the shard block bitwise against the port's single-process fit
    oracle_enc = TfidfEncoder(config)
    oracle_ell = oracle_enc.fit_transform(full).wait_ready()
    np.testing.assert_array_equal(idf, oracle_enc.idf_)
    w = max(local_ell.width, oracle_ell.width)
    lp, op = _pad_width(local_ell, w), _pad_width(oracle_ell, w)
    np.testing.assert_array_equal(lp.ids, op.ids[lo:hi])
    np.testing.assert_array_equal(lp.vals64, op.vals64[lo:hi])
    print(f"WORKER_ENCODE_OK {rank}", flush=True)

    slots = int(os.environ.get("MH_SLOTS", "1"))
    mesh = make_mesh(slots, device="cpu") if slots > 1 else None
    r_s, c_s, s_s = multihost_match_shard(
        local_ell, lo, n_total, MIN_SIM, MAX_N, hash_dim=128, tile=8,
        device="cpu", mesh=mesh,
    )
    ref = topn_cosine_matches(
        oracle_ell, None, MIN_SIM, MAX_N, force_symmetries=False,
        hash_dim=128, device="cpu",
    )
    ref_pairs = {
        (int(r), int(c)): s
        for r, c, s in zip(ref.rows, ref.cols, ref.sims) if lo <= r < hi
    }

    def check(r_a, c_a, s_a, label):
        got = {(int(r), int(c)): s for r, c, s in zip(r_a, c_a, s_a)}
        assert got == ref_pairs, (
            f"rank {rank} {label}: {len(set(ref_pairs) - set(got))} missing "
            f"{len(set(got) - set(ref_pairs))} extra"
        )

    check(r_s, c_s, s_s, "wide")
    print(f"WORKER_OK {rank}", flush=True)

    # force the union escalation: a tiny candidate width truncates the
    # dense rows' candidates, their drop bounds flag them, and the gathered
    # union re-match must restore the exact result
    r_e, c_e, s_e = multihost_match_shard(
        local_ell, lo, n_total, MIN_SIM, MAX_N, hash_dim=128, tile=8,
        cand_c0=2, device="cpu", mesh=mesh,
    )
    check(r_e, c_e, s_e, "escalated")
    print(f"WORKER_ESC_OK {rank}", flush=True)
    np.savez(
        os.path.join(out_dir, f"shard_{rank}.npz"),
        lo=lo, hi=hi, ids=local_ell.ids, vals64=local_ell.vals64, idf=idf,
        rows=r_s, cols=c_s, sims=s_s, rows_esc=r_e, cols_esc=c_e,
        sims_esc=s_e,
    )


if __name__ == "__main__":
    main()
