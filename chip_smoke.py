#!/usr/bin/env python3
"""Smoke run of string_grouper_tpu_torch on one NVIDIA GPU.

Run from the repository root with no arguments:

    python chip_smoke.py

Phases (any failure raises and the script exits non-zero without a result):

1. Device: the card's name and power limit; build the CUDA kernels from
   string_grouper_tpu_torch/csrc/ (one nvcc per source, all started
   together) and print the build time.
2. Kernel ``p1_fused_closed2`` against its plain PyTorch version on the
   card, on hash rows of the synthetic 663,000-name corpus (A 32,768 rows,
   B 131,072 rows, d 512, tile 4096, C 64, the default threshold): counts,
   tmax and ship sets equal, bounds within TOL, except rows with a score
   within TOL of the threshold or of another score (counted and printed).
3. Kernel ``device_hash_codes`` against its plain version on the whole
   663,000-row payload: every element within 1 bf16 ulp; repeated launches
   bitwise identical.
4. ``match_strings`` on the card frame-equal to ``device="cpu"`` at 20,000
   names, and equal to a brute-force fp64 cosine oracle at 5,000 names.
5. The full self-join at 663,000 names on the card: wall time, phases,
   escalation rungs, kernel launches, and the output row count.

Without a CUDA GPU, or without the repository beside it, it exits non-zero
and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import torch

N_FULL = 663_000
# Output rows of the default self-join at N_FULL: exact rescoring and
# deterministic selection make the count a property of the corpus (the JAX
# package's run at this size gave the same number).
ROWS_FULL = 4_558_752
N_FRAME = 20_000
N_ORACLE = 5_000
# Score tolerance between the kernel and its plain version: f32 sums of 512
# bf16 products in different orders differ by far less than this.
TOL = 1e-5
# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth).
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 2
def check_p1(K, h, thr, m=32_768, n=131_072):
    tile, cand_c = 4096, 64
    a = h[:m].contiguous()
    b = h[:n].contiguous()
    ship_k, cnt_k, tmax_k, bnd_k, _ = K.p1_fused_closed2(a, b, thr, tile, cand_c)
    ship_p, cnt_p, tmax_p, bnd_p, _ = K.p1_fused_closed2_plain(a, b, thr, tile, cand_c)
    torch.cuda.synchronize()
    valid = ship_k >= 0
    assert bool((valid[:, 1:] <= valid[:, :-1]).all()), "ship prefix invariant"
    assert int(cnt_k.sum()) > 0 and int((tmax_k > 2).sum()) > 0
    set_diff = (torch.sort(ship_k, 1).values != torch.sort(ship_p, 1).values).any(1)
    cnt_diff = (cnt_k != cnt_p) | (tmax_k != tmax_p)
    both_neg = torch.isneginf(bnd_k) & torch.isneginf(bnd_p)
    bnd_gap = torch.where(both_neg, torch.zeros_like(bnd_k), (bnd_k - bnd_p).abs())
    bnd_diff = ~(bnd_gap <= TOL)
    rows = torch.nonzero(set_diff | cnt_diff | bnd_diff).flatten().tolist()
    assert len(rows) <= 2000, f"p1: {len(rows)} rows differ"
    b64 = b.double()
    borderline = []
    for r in rows:
        s = b64 @ a[r].double()
        near_thr = bool(((s - thr).abs() <= TOL).any())
        q = torch.sort(s[s >= thr - TOL], descending=True).values
        near_tie = bool(((q[:-1] - q[1:]) <= TOL).any()) if len(q) > 1 else False
        assert near_thr or near_tie, (
            f"p1 row {r}: kernel and plain differ with no score near the "
            f"threshold or a tie (counts {int(cnt_k[r])}/{int(cnt_p[r])}, "
            f"bound {float(bnd_k[r])}/{float(bnd_p[r])})"
        )
        borderline.append(r)
    keep = torch.ones(m, dtype=torch.bool, device=a.device)
    if borderline:
        keep[torch.tensor(borderline, device=a.device)] = False
    max_err = float(bnd_gap[keep].max())
    log(f"p1_fused_closed2 vs plain: m={m} n={n} d=512 tile={tile} C={cand_c} "
        f"thr={thr!r}: {m - len(borderline)} rows equal, "
        f"{len(borderline)} borderline rows (score within {TOL} of thr or "
        f"of a tie), max |bound diff| {max_err}")

    ms = cuda_ms(lambda: K.p1_fused_closed2(a, b, thr, tile, cand_c), 5)
    plain_ms = cuda_ms(lambda: K.p1_fused_closed2_plain(a, b, thr, tile, cand_c), 2)
    lib_ms = cuda_ms(lambda: torch.mm(a, b.t()), 3)
    flops = 2.0 * m * n * 512
    nbytes = (m + n) * 512 * 2 + m * cand_c * 4 + m * 12
    bound_ms = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    log(f"p1_fused_closed2: kernel_ms={ms} plain_ms={plain_ms} "
        f"library_ms(torch.mm bf16)={lib_ms} bound_ms={bound_ms} "
        f"({flops / (ms * 1e-3) / 1e12} TFLOP/s)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="operations", library_ms=lib_ms)


# ------------------------------------------------------------------ phase 3
def check_hash(K, M, src, dev):
    n = len(src.inv_norm)
    lens = src.row_lengths()
    width = max(src.ngram, -(-int(lens.max()) // 40) * 40)
    codes = M._to_device(
        M._fill_code_rows6(src, np.arange(n, dtype=np.int32), width), dev
    )
    inv = M._to_device(src.inv_norm, dev)
    table = M._to_device(src.table_id, dev)
    idf = M._to_device(src.idf32, dev)
    args = (codes, inv, table, idf, 512, src.base, src.ngram)
    h_k = K.device_hash_codes(*args, width=width)
    h_k2 = K.device_hash_codes(*args, width=width)
    h_p = K.device_hash_codes_plain(*args, width=width)
    torch.cuda.synchronize()
    assert torch.equal(h_k, h_k2), "device_hash_codes is not deterministic"
    ulp = (h_k.view(torch.int16).int() - h_p.view(torch.int16).int()).abs()
    n_diff = int((ulp > 0).sum())
    assert int(ulp.max()) <= 1, f"device_hash_codes: {int(ulp.max())} bf16 ulp"
    max_err = float((h_k.float() - h_p.float()).abs().max())
    log(f"device_hash_codes vs plain: n={n} width={width} dim=512: max 1 bf16 "
        f"ulp; {n_diff} of {h_k.numel()} elements differ (max |diff| {max_err})")

    # library yardstick: the scatter core alone, one index_add_ over the
    # precomputed (row * dim + bucket, idf) window pairs of the whole corpus
    c = K._unpack_codes(codes, width)
    win = width - src.ngram + 1
    key = torch.zeros((n, win), dtype=torch.int64, device=dev)
    for j in range(src.ngram):
        key = key * src.base + c[:, j:j + win]
    ids = table.long()[key]
    ok = ids >= 0
    shift = 32 - (512).bit_length() + 1
    flat = (torch.arange(n, device=dev)[:, None] * 512
            + (((ids * K._KNUTH) & 0xFFFFFFFF) >> shift))[ok]
    vals = idf[ids.clamp(min=0)][ok]
    del key, ids, c
    acc = torch.zeros(n * 512, dtype=torch.float32, device=dev)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, flat, vals), 5)
    ms = cuda_ms(lambda: K.device_hash_codes(*args, width=width), 10)
    plain_ms = cuda_ms(lambda: K.device_hash_codes_plain(*args, width=width), 2)
    nbytes = (codes.numel() * 4 + n * 4 + table.numel() * 4 + idf.numel() * 4
              + n * 512 * 2)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    log(f"device_hash_codes: kernel_ms={ms} plain_ms={plain_ms} "
        f"library_ms(index_add_ of {len(vals)} window values)={lib_ms} "
        f"bound_ms={bound_ms} ({nbytes / (ms * 1e-3) / 1e9} GB/s)")
    return h_k, dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms)


# ------------------------------------------------------------------ phase 4
def oracle_frame_check(sgt, TfidfEncoder, StringGrouperConfig, names):
    """Brute-force fp64 cosine oracle (dense TF-IDF of unique rows, all
    pairs) with the reference's semantics: threshold 0.8, per-row top 20 by
    (similarity desc, column asc), symmetric closure, exact-1 diagonal."""
    got = sgt.match_strings(pd.Series(names))
    ell = TfidfEncoder(StringGrouperConfig()).fit_transform(names)
    dense = ell.to_dense()
    uniq, inv = np.unique(dense, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    sims_u = uniq @ uniq.T
    sims = sims_u[inv][:, inv]  # identical rows -> identical similarities
    keyed = np.round(sims, 12)
    pairs = {}
    n = len(names)
    for i in range(n):
        cand = np.flatnonzero((sims[i] >= 0.8) & (sims[i] > 0))
        order = cand[np.lexsort((cand, -keyed[i, cand]))][:20]
        for c in order:
            if c != i:
                pairs[(i, int(c))] = sims[i, c]
                pairs[(int(c), i)] = sims[i, c]
    for i in range(n):
        pairs[(i, i)] = 1.0
    got_pairs = {
        (int(r), int(c)): s for r, c, s in
        zip(got.left_index, got.right_index, got.similarity)
    }
    assert set(got_pairs) == set(pairs), (
        f"oracle: {len(set(pairs) - set(got_pairs))} missing, "
        f"{len(set(got_pairs) - set(pairs))} extra"
    )
    err = max(abs(got_pairs[k] - v) for k, v in pairs.items())
    assert err <= 1e-12, f"oracle: similarity differs by {err}"
    log(f"oracle ({n} names): {len(pairs)} pairs equal, max |sim diff| {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 2
    import string_grouper_tpu_torch as sgt
    from string_grouper_tpu_torch.config import StringGrouperConfig
    from string_grouper_tpu_torch.corpus import TfidfEncoder
    from string_grouper_tpu_torch.ops import _build
    from string_grouper_tpu_torch.ops import kernels as K
    from string_grouper_tpu_torch.ops import matcher as M
    from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

    dev = torch.device("cuda")
    card = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"nvcc build: {time.perf_counter() - t0:.1f} s wall for "
        f"{len(secs)} kernels in parallel ({secs})")

    # ---- phases 2-3: kernels against their plain versions -----------------
    t0 = time.perf_counter()
    names_full = synthetic_company_names(N_FULL)
    ell_full = TfidfEncoder(StringGrouperConfig()).fit_transform(names_full)
    log(f"corpus: {N_FULL} names generated + encoded in "
        f"{time.perf_counter() - t0:.1f} s ({ell_full.n_terms} terms)")
    if ell_full.device_src is None:
        from string_grouper_tpu_torch.native.build import BUILD_ERROR

        raise RuntimeError(f"no byte-level payload (native build: {BUILD_ERROR})")
    h, res_hash = check_hash(K, M, ell_full.device_src, dev)
    res_p1 = check_p1(K, h, float(M.effective_threshold(0.8)))
    del h, ell_full
    torch.cuda.empty_cache()

    # ---- phase 4: card vs CPU, oracle -------------------------------------
    s20 = pd.Series(synthetic_company_names(N_FRAME))
    K.reset_launches()
    t0 = time.perf_counter()
    card_df = sgt.match_strings(s20)
    t_card = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    assert all(v > 0 for v in launches.values()), f"20k launches {launches}"
    t0 = time.perf_counter()
    cpu_df = sgt.match_strings(s20, device="cpu")
    t_cpu = time.perf_counter() - t0
    pd.testing.assert_frame_equal(card_df, cpu_df)
    log(f"frames ({N_FRAME} names): card == cpu, {len(card_df)} rows; card "
        f"{t_card:.2f} s, cpu {t_cpu:.2f} s; launches {launches}")
    K.reset_launches()
    oracle_frame_check(sgt, TfidfEncoder, StringGrouperConfig,
                       synthetic_company_names(N_ORACLE))
    assert all(v > 0 for v in K.LAUNCHES.values()), f"5k launches {K.LAUNCHES}"

    # ---- phase 5: the full self-join --------------------------------------
    s_full = pd.Series(names_full)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grouper = sgt.StringGrouper(s_full).fit()
    out = grouper.get_matches()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(f"full self-join: n={N_FULL} wall {wall:.3f} s, {len(out)} rows; "
        f"launches {launches}")
    log("timings: " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in grouper.timings.seconds.items()}))
    assert all(v > 0 for v in launches.values()), f"663k launches {launches}"
    assert len(out) == ROWS_FULL, f"{len(out)} output rows, expected {ROWS_FULL}"
    assert np.isfinite(out.similarity.to_numpy()).all()

    src = "string_grouper_tpu_torch/csrc/{}.cu"
    kernels = [
        dict(name="p1_fused_closed2", route="cuda",
             source=src.format("p1_fused_closed2"),
             replaces="string_grouper_tpu/ops/pallas_kernels.py:117",
             launches=launches["p1_fused_closed2"], **res_p1),
        dict(name="device_hash_codes", route="cuda",
             source=src.format("device_hash_codes"),
             replaces="string_grouper_tpu/ops/matcher.py:398",
             launches=launches["device_hash_codes"], **res_hash),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
