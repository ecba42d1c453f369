#!/usr/bin/env python3
"""Smoke run of string_grouper_tpu_torch on one NVIDIA GPU.

Run from the repository root with no arguments:

    python chip_smoke.py

Phases (any failure raises and the script exits non-zero without a result):

1. Device: the card's name and power limit; build the CUDA kernels from
   string_grouper_tpu_torch/csrc/ (one nvcc per source, all started
   together) and print the build time, and beside it ``nvcc -Xptxas -v``'s
   registers, shared memory and spills for the three kernels on the
   TMA/wgmma scan (no stack, no spills and no serialized wgmma, or the
   phase fails).
2. Kernel ``p1_fused_closed2`` against its plain PyTorch version on the
   card, on hash rows of the synthetic 663,000-name corpus (A 32,768 rows,
   B 131,072 rows, d 512, tile 4096, C 64, the default threshold): counts,
   tmax and ship sets equal, bounds within TOL, except rows with a score
   within TOL of the threshold or of another score (counted and printed).
2b. Both scan kernels (``p1_fused_closed2``, ``p1_fused_chain``) against
   their plain versions over the rest of their domain: m = 256 and 300
   (ragged), d = 128, 256, 384 (the hash's first d columns, renormalised)
   and 512, C = 8 and 256; the chained passes bitwise one closed pass.
3. Kernel ``device_hash_codes`` against its plain version on the whole
   663,000-row payload: every element within 1 bf16 ulp; repeated launches
   bitwise identical; and against the plain version run on the CPU over the
   first 20,000 rows (both sum each bucket in window order: the count of
   elements that differ is printed, 1 bf16 ulp allowed).
3b. Kernel ``p1_fused_chain`` at the chunked pipeline's shape (A 73,728
   rows, two chunks of 294,912 rows): each pass against its plain version
   (the rule of phase 2), and the chained kernel passes BITWISE one
   ``p1_fused_closed2`` kernel pass over the concatenated chunks.
3c. Kernel ``p1_tri_fused`` over the segment loop at n = 131,072 (segments
   of 32,768 rows, block_m 512): row side and packed future state against
   the plain version after every segment (the rule of phase 2), and the
   candidate completeness check against the scores of all 131,072 rows.
3d. A/B at the 663k scan's own shape (its unique rows, zero-padded to
   589,824 = 8 segments of 73,728): the full triangular scan (all
   segments through ``p1_tri_fused``) against the square scan (all through
   ``p1_fused_closed2``), in the order square, tri, tri, square; per-row
   qualified counts of the two equal, except rows with a score within TOL
   of the threshold (the triangle counts a row's earlier columns from the
   transposed products; counted, printed).
3e. Kernel ``p1_tri_fused`` against its plain version over the rest of its
   domain at n = 16,384 (segments of one 4096-row tile, all in order, the
   last with no future columns): d = 128, 384 (the hash's first d columns,
   renormalised) and 512, block_m 128 and 4096, C = 8 and 256; row sides
   after every segment and the future state at the end, by phase 2's rule.
4. ``match_strings`` on the card frame-equal to ``device="cpu"`` at 20,000
   names, and equal to a brute-force fp64 cosine oracle at 5,000 names.
5. The full self-join at 663,000 names on the card: wall time, phases,
   escalation rungs, kernel launches, and the output row count; then the
   same with the column-chunked pipeline (SG_TPU_CHUNKED_P1=1) at G = 2
   and G = 3 chunks: the same frame, with p1_wait and wall printed.

Without a CUDA GPU, or without the repository beside it, it exits non-zero
and prints no result.
"""

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# Kernels each path launches: the default self-join (and its kt=2
# escalation), and the column-chunked one (its escalation may add
# p1_fused_closed2).
DEFAULT_PATH = ("p1_fused_closed2", "device_hash_codes")
CHUNKED_PATH = ("p1_fused_chain", "device_hash_codes")
# The three kernels on the TMA/wgmma scan (csrc/p1_scan_sm90.cuh).
SCAN_KERNELS = ("p1_fused_closed2", "p1_fused_chain", "p1_tri_fused")
# Rows of the 663k payload that phase 3 also hashes with the plain version
# on the CPU.
N_HASH_CPU = 20_000
# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth).
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after one warm-up
    launch unless ``warmup`` is False."""
    if warmup:
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
def compare_scan(what, got, want, a, b, thr):
    """Hold a phase-1 scan's kernel outputs ``got`` against its plain
    version's ``want``, each ``(ship, counts, tmax, bound[, values])`` per
    row of ``a`` (ship: column where the value is finite, else -1): ship
    sets, counts and tmax equal, bounds and values within TOL -- except
    rows with a score (against the columns ``b``) within TOL of the
    threshold or of another score, whose f32 sums may round across either.
    Returns ``(max |diff| over the other rows, borderline rows)``."""
    m = a.shape[0]
    ship_k, cnt_k, tmax_k, bnd_k = got[:4]
    ship_p, cnt_p, tmax_p, bnd_p = want[:4]
    set_diff = (torch.sort(ship_k, 1).values != torch.sort(ship_p, 1).values).any(1)
    cnt_diff = (cnt_k != cnt_p) | (tmax_k != tmax_p)
    gaps = [(bnd_k, bnd_p)] + ([(got[4], want[4])] if len(got) > 4 else [])
    gap = torch.zeros(m, dtype=torch.float32, device=a.device)
    for x, y in gaps:
        both_neg = torch.isneginf(x) & torch.isneginf(y)
        g = torch.where(both_neg, torch.zeros_like(x), (x - y).abs())
        gap = torch.maximum(gap, g.reshape(m, -1).max(1).values.nan_to_num(float("inf")))
    rows = torch.nonzero(set_diff | cnt_diff | ~(gap <= TOL)).flatten().tolist()
    assert len(rows) <= 2000, f"{what}: {len(rows)} rows differ"
    b64 = b.double()
    for r in rows:
        s = b64 @ a[r].double()
        near_thr = bool(((s - thr).abs() <= TOL).any())
        q = torch.sort(s[s >= thr - TOL], descending=True).values
        near_tie = bool(((q[:-1] - q[1:]) <= TOL).any()) if len(q) > 1 else False
        assert near_thr or near_tie, (
            f"{what} row {r}: kernel and plain differ with no score near the "
            f"threshold or a tie (counts {cnt_k[r].item()}/{cnt_p[r].item()}, "
            f"bound {float(bnd_k[r])}/{float(bnd_p[r])})"
        )
    keep = torch.ones(m, dtype=torch.bool, device=a.device)
    if rows:
        keep[torch.tensor(rows, device=a.device)] = False
    return float(gap[keep].max()), len(rows)


def check_p1(K, h, thr, m=32_768, n=131_072):
    tile, cand_c = 4096, 64
    a = h[:m].contiguous()
    b = h[:n].contiguous()
    got = K.p1_fused_closed2(a, b, thr, tile, cand_c)
    want = K.p1_fused_closed2_plain(a, b, thr, tile, cand_c)
    torch.cuda.synchronize()
    ship_k, cnt_k, tmax_k = got[:3]
    valid = ship_k >= 0
    assert bool((valid[:, 1:] <= valid[:, :-1]).all()), "ship prefix invariant"
    assert int(cnt_k.sum()) > 0 and int((tmax_k > 2).sum()) > 0
    max_err, n_border = compare_scan("p1_fused_closed2", got[:4], want[:4],
                                     a, b, thr)
    log(f"p1_fused_closed2 vs plain: m={m} n={n} d=512 tile={tile} C={cand_c} "
        f"thr={thr!r}: {m - n_border} rows equal, "
        f"{n_border} borderline rows (score within {TOL} of thr or "
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
    r = min(N_HASH_CPU, n)
    h_c = K.device_hash_codes_plain(codes[:r].cpu(), inv[:r].cpu(), table.cpu(),
                                    idf.cpu(), 512, src.base, src.ngram, width=width)
    ulp = (h_k[:r].cpu().view(torch.int16).int() - h_c.view(torch.int16).int()).abs()
    assert int(ulp.max()) <= 1, f"device_hash_codes vs CPU: {int(ulp.max())} bf16 ulp"
    log(f"device_hash_codes vs plain on the CPU: first {r} rows: "
        f"{int((ulp > 0).sum())} of {h_c.numel()} elements differ (1 bf16 ulp "
        f"allowed; both sum each bucket in window order)")

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


# ----------------------------------------------------------------- phase 2b
def check_p1_domain(K, h, thr, n=16_384, chunk=8_192, tile=4_096):
    """Both TMA/wgmma scan kernels against their plain versions over the
    rest of the domain ``p1_fused_supported`` admits: m = 256 and m = 300
    (a ragged row block; the kt=2 escalation's small-m case), d = 128, 256,
    384 (the hash's first d columns, renormalised) and 512, C = 8 and 256.
    ``p1_fused_chain`` runs as two chained passes, each held against its
    plain version, and the chained passes BITWISE one closed pass."""
    n_cases, n_border, max_err = 0, 0, 0.0
    for d in (128, 256, 384, 512):
        hd = h[:n, :d].float()
        hd = (hd / hd.norm(dim=1, keepdim=True).clamp_min(1e-12)).to(torch.bfloat16)
        for m in (256, 300):
            a = hd[:m].contiguous()
            for cand_c in (8, 256):
                what = f"m={m} d={d} C={cand_c}"
                got = K.p1_fused_closed2(a, hd, thr, tile, cand_c)
                want = K.p1_fused_closed2_plain(a, hd, thr, tile, cand_c)
                err, nb = compare_scan(f"p1_fused_closed2 {what}", got[:4],
                                       want[:4], a, hd, thr)
                max_err, n_border = max(max_err, err), n_border + nb
                st_k = K.p1_chain_init(m, cand_c, a.device)
                st_p = K.p1_chain_init(m, cand_c, a.device)
                for lo in range(0, n, chunk):
                    bc = hd[lo:lo + chunk]
                    ck = K.p1_fused_chain(a, bc, thr, lo, st_k, tile, cand_c)
                    cp = K.p1_fused_chain_plain(a, bc, thr, lo, st_p, tile, cand_c)
                    err, nb = compare_scan(f"p1_fused_chain {what} col {lo}",
                                           ck[:4], cp[:4], a, hd[:lo + chunk], thr)
                    max_err, n_border = max(max_err, err), n_border + nb
                torch.cuda.synchronize()
                for name, g, w in zip(("ship", "counts", "tmax", "bound", "max_cnt"),
                                      ck, got):
                    assert torch.equal(g, w), f"{what}: chained != one pass: {name}"
                assert int(got[1].sum()) > 0, f"{what}: nothing qualified"
                n_cases += 1
    log(f"scan kernels vs plain over the domain: {n_cases} cases (m 256/300, "
        f"d 128/256/384/512, C 8/256; n={n}, tile={tile}, chain in 2 chunks): "
        f"equal but {n_border} borderline rows, max |bound diff| {max_err}; "
        f"chained == one pass (bitwise) in every case")
    return max_err


# ----------------------------------------------------------------- phase 3b
def check_chain(K, h, thr, m=73_728, chunk=294_912):
    """``p1_fused_chain`` at the 663k chunked pipeline's shape: a segment of
    73,728 rows against its first chunk at G = 2 (4 segments) and one more
    of the same width."""
    tile, cand_c = 4096, 64
    a = h[:m].contiguous()
    b = h[:2 * chunk].contiguous()
    st_k = K.p1_chain_init(m, cand_c, a.device)
    st_p = K.p1_chain_init(m, cand_c, a.device)
    max_err, n_border, plain_ms = 0.0, 0, None
    for lo in (0, chunk):
        bc = b[lo:lo + chunk]
        got = K.p1_fused_chain(a, bc, thr, lo, st_k, tile, cand_c)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        want = K.p1_fused_chain_plain(a, bc, thr, lo, st_p, tile, cand_c)
        t1.record()
        torch.cuda.synchronize()
        if lo == 0:  # the plain version is timed on the pass timed below
            plain_ms = t0.elapsed_time(t1)
        err, nb = compare_scan(f"p1_fused_chain pass at col {lo}", got[:4],
                               want[:4], a, b[:lo + chunk], thr)
        max_err, n_border = max(max_err, err), n_border + nb
    one = K.p1_fused_closed2(a, b, thr, tile, cand_c)
    torch.cuda.synchronize()
    for name, g, w in zip(("ship", "counts", "tmax", "bound", "max_cnt"), got, one):
        assert torch.equal(g, w), f"chained passes != one pass: {name}"
    log(f"p1_fused_chain vs plain: m={m} chunks 2 x {chunk} d=512: every pass "
        f"equal but {n_border} borderline rows, max |bound diff| {max_err}; "
        f"2 chained kernel passes == one p1_fused_closed2 pass over "
        f"{2 * chunk} columns (bitwise)")

    st = K.p1_chain_init(m, cand_c, a.device)
    bc = b[:chunk]
    ms = cuda_ms(lambda: K.p1_fused_chain(a, bc, thr, 0, st, tile, cand_c), 3)
    lib_ms = cuda_ms(lambda: torch.mm(a, bc.t()), 2)
    flops = 2.0 * m * chunk * 512
    nbytes = (m + chunk) * 512 * 2 + m * cand_c * 12 + m * 28
    bound_ms = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    log(f"p1_fused_chain (one pass, A {m} x chunk {chunk}): kernel_ms={ms} "
        f"plain_ms={plain_ms} library_ms(torch.mm bf16)={lib_ms} "
        f"bound_ms={bound_ms} ({flops / (ms * 1e-3) / 1e12} TFLOP/s)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="operations", library_ms=lib_ms)


# ----------------------------------------------------------------- phase 3c
def _tri_rows(v, c, meta):
    """A packed row side as compare_scan's (ship, counts, tmax, bound,
    values)."""
    return (torch.where(v > float("-inf"), c, -1), meta[:, 0], meta[:, 1],
            meta[:, 2], v)


def tri_completeness(K, b, thr, rows_side, fpack, cand_c, tile):
    """Every row's row side (rows_side = (rv, rc, rmeta) of all rows) plus
    its future state must count every qualified column, hold the largest
    per-tile count, and cover every qualified column or bound it (each
    side's own top-C truncation, the drop bounds) -- against torch's f32
    scores, rows with a score within TOL of the threshold excepted."""
    n = b.shape[0]
    nt = n // tile
    rv, rc, rm = rows_side
    fv, fc, fm = K.tri_future_unpack(fpack)
    bf = b.float()
    neg = torch.tensor(float("-inf"), device=b.device)
    bad, near_rows, qual_total = 0, 0, 0
    for lo in range(0, n, 4096):
        hi = lo + 4096
        S = bf[lo:hi] @ bf.t()
        qual = S >= thr
        near = ((S - thr).abs() <= TOL).any(1)
        cnt = qual.sum(1).float()
        per_tile = qual.view(hi - lo, nt, tile).sum(2).max(1).values.float()
        vs = torch.cat([rv[lo:hi], fv[lo:hi]], 1)
        cs = torch.cat([rc[lo:hi], fc[lo:hi]], 1).long()
        fin = vs > neg
        covered = torch.zeros_like(qual)
        flat = (torch.arange(hi - lo, device=b.device)[:, None] * n + cs)[fin]
        covered.view(-1)[flat] = True
        trunc_r = torch.where(rm[lo:hi, 3] > cand_c, rv[lo:hi, cand_c - 1], neg)
        trunc_f = torch.where(fm[lo:hi, 3] > K.TRI_FUT_C, fv[lo:hi, -1], neg)
        bound = torch.stack([rm[lo:hi, 2], fm[lo:hi, 2], trunc_r, trunc_f]).max(0).values
        miss = (qual & ~covered & (S > bound[:, None] + TOL)).any(1)
        ok = ((rm[lo:hi, 0] + fm[lo:hi, 0] == cnt)
              & (torch.maximum(rm[lo:hi, 1], fm[lo:hi, 1]) == per_tile) & ~miss)
        bad += int((~ok & ~near).sum())
        near_rows += int((~ok & near).sum())
        qual_total += int(cnt.sum())
    assert bad == 0, f"p1_tri_fused: {bad} rows incomplete"
    return qual_total, near_rows


def check_tri(K, h, thr, n=131_072, seg_rows=32_768):
    """The segment loop of the triangular scan at n = 131,072."""
    tile, cand_c, bm = 4096, 64, 512
    b = h[:n].contiguous()
    cpg = seg_rows // tile
    f_k = K.tri_future_init(n, b.device)
    f_p = K.tri_future_init(n, b.device)
    rows_k = []
    max_err, n_border = 0.0, 0
    for s in range(n // seg_rows):
        a = b[s * seg_rows:(s + 1) * seg_rows]
        rv, rc, rm, _ = K.p1_tri_fused(a, b, f_k, s * cpg, thr, tile, cand_c, bm)
        pv, pc, pm, _ = K.p1_tri_fused_plain(a, b, f_p, s * cpg, thr, tile, cand_c, bm)
        rows_k.append((rv, rc, rm))
        err, nb = compare_scan(f"p1_tri_fused segment {s} rows",
                               _tri_rows(rv, rc, rm), _tri_rows(pv, pc, pm), a, b, thr)
        max_err, n_border = max(max_err, err), n_border + nb
    err, nb = compare_scan("p1_tri_fused future state",
                           _tri_rows(*K.tri_future_unpack(f_k)),
                           _tri_rows(*K.tri_future_unpack(f_p)), b, b, thr)
    max_err, n_border = max(max_err, err), n_border + nb
    rows_side = tuple(torch.cat(x) for x in zip(*rows_k))
    qual_total, near = tri_completeness(K, b, thr, rows_side, f_k, cand_c, tile)
    log(f"p1_tri_fused vs plain: n={n} segments of {seg_rows} block_m={bm} "
        f"C={cand_c}: row sides and future state equal but {n_border} "
        f"borderline rows, max |diff| {max_err}; complete: {qual_total} "
        f"qualified pairs counted and covered ({near} rows near thr excepted)")

    # one launch with a column side: segment 0 (A 32,768 x all 131,072 columns)
    a = b[:seg_rows]
    fk = K.tri_future_init(n, b.device)
    ms = cuda_ms(lambda: K.p1_tri_fused(a, b, fk, 0, thr, tile, cand_c, bm), 3)
    fp = K.tri_future_init(n, b.device)
    plain_ms = cuda_ms(
        lambda: K.p1_tri_fused_plain(a, b, fp, 0, thr, tile, cand_c, bm), 1,
        warmup=False)
    lib_ms = cuda_ms(lambda: torch.mm(a, b.t()), 3)
    flops = 2.0 * seg_rows * n * 512
    n_fut = n - seg_rows
    nbytes = (seg_rows + n) * 512 * 2 + n_fut * 512 * 2 + seg_rows * (cand_c * 8 + 32)
    bound_ms = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    log(f"p1_tri_fused (segment 0: A {seg_rows} x {n} columns, {n_fut} future): "
        f"kernel_ms={ms} plain_ms={plain_ms} library_ms(torch.mm bf16 over "
        f"the same tile pairs)={lib_ms} bound_ms={bound_ms} "
        f"({flops / (ms * 1e-3) / 1e12} TFLOP/s)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="operations", library_ms=lib_ms)


# ----------------------------------------------------------------- phase 3e
def check_tri_domain(K, h, thr, n=16_384, tile=4_096):
    """``p1_tri_fused`` against its plain version over the rest of the
    domain ``p1_tri_supported`` admits: d = 128, 384 (the hash's first d
    columns, renormalised) and 512, block_m 128 and = tile, C = 8 and 256;
    every segment of one tile in order (the last has no future columns),
    row sides after each segment and the future state at the end."""
    n_cases, n_border, max_err = 0, 0, 0.0
    for d in (128, 384, 512):
        hd = h[:n, :d].float()
        hd = (hd / hd.norm(dim=1, keepdim=True).clamp_min(1e-12)).to(torch.bfloat16)
        for bm in (128, tile):
            for cand_c in (8, 256):
                what = f"d={d} block_m={bm} C={cand_c}"
                f_k = K.tri_future_init(n, hd.device)
                f_p = K.tri_future_init(n, hd.device)
                for s in range(n // tile):
                    a = hd[s * tile:(s + 1) * tile]
                    got = K.p1_tri_fused(a, hd, f_k, s, thr, tile, cand_c, bm)
                    want = K.p1_tri_fused_plain(a, hd, f_p, s, thr, tile, cand_c, bm)
                    err, nb = compare_scan(f"p1_tri_fused {what} segment {s}",
                                           _tri_rows(*got[:3]), _tri_rows(*want[:3]),
                                           a, hd, thr)
                    max_err, n_border = max(max_err, err), n_border + nb
                err, nb = compare_scan(f"p1_tri_fused {what} future state",
                                       _tri_rows(*K.tri_future_unpack(f_k)),
                                       _tri_rows(*K.tri_future_unpack(f_p)), hd, hd, thr)
                max_err, n_border = max(max_err, err), n_border + nb
                assert float(K.tri_future_unpack(f_k)[2][:, 0].sum()) > 0, \
                    f"{what}: nothing qualified"
                n_cases += 1
    log(f"p1_tri_fused vs plain over the domain: {n_cases} cases (d 128/384/512, "
        f"block_m 128/{tile}, C 8/256; n={n}, {n // tile} segments each): equal "
        f"but {n_border} borderline rows, max |diff| {max_err}")
    return max_err


# ----------------------------------------------------------------- phase 3d
def tri_square_ab(K, M, h, src, thr, seg_rows=73_728, n_pad=589_824):
    """Full triangular scan against the full square scan at the 663k scan's
    shape: the unique rows the matcher scans (first row of each
    clean-equality group), zero-padded to whole segments."""
    tile, cand_c, bm = 4096, 64, 512
    codes = M._clean_codes(src)
    _, first = np.unique(codes, return_index=True)
    first = np.sort(first)
    n_u = len(first)
    assert n_u <= n_pad
    b = torch.zeros((n_pad, 512), dtype=torch.bfloat16, device=h.device)
    b[:n_u] = h[torch.from_numpy(first).to(h.device)]
    n_seg, cpg = n_pad // seg_rows, seg_rows // tile

    def square():
        return [K.p1_fused_closed2(b[s * seg_rows:(s + 1) * seg_rows], b, thr,
                                   tile, cand_c)[1] for s in range(n_seg)]

    def tri():
        f = K.tri_future_init(n_pad, b.device)
        rm = [K.p1_tri_fused(b[s * seg_rows:(s + 1) * seg_rows], b, f, s * cpg,
                             thr, tile, cand_c, bm)[2] for s in range(n_seg)]
        return rm, f

    def timed(fn):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        out = fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1), out

    sq1, counts = timed(square)
    K.reset_launches()
    tr1, (rm, f) = timed(tri)
    tri_launches = K.LAUNCHES["p1_tri_fused"]
    assert tri_launches == n_seg, K.LAUNCHES
    tr2, _ = timed(tri)
    sq2, _ = timed(square)
    sq_counts = torch.cat(counts).float()
    tri_counts = torch.cat(rm)[:, 0] + K.tri_future_unpack(f)[2][:, 0]
    # Both run the TMA/wgmma scan, but the triangle counts a row's earlier
    # columns from the transposed products (the row as a right column), an
    # f32 sum that may round otherwise: a row may count a score within TOL
    # of the threshold on one side only.  Any other difference fails.
    rows = torch.nonzero(sq_counts != tri_counts).flatten().tolist()
    assert len(rows) <= 2000, f"tri/square: {len(rows)} rows count differently"
    if rows:
        b64 = b.double()
        for r in rows:
            near = bool((((b64 @ b64[r]) - thr).abs() <= TOL).any())
            assert near, (f"tri/square row {r}: counts {float(sq_counts[r])} / "
                          f"{float(tri_counts[r])} with no score near thr")
        del b64
    log(f"tri/square A/B: {n_u} unique rows padded to {n_pad}, {n_seg} segments "
        f"of {seg_rows}, d=512, tile={tile}, block_m={bm}: square scan "
        f"{sq1} / {sq2} ms, triangular scan {tr1} / {tr2} ms (order square, "
        f"tri, tri, square); {int(sq_counts.sum())} qualified pairs; "
        f"{len(rows)} borderline rows count differently (a score within "
        f"{TOL} of thr), every other row equal")
    return tri_launches


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
    with ThreadPoolExecutor(1) as pool:  # ptxas report beside the build
        report = pool.submit(_build.ptxas_report, SCAN_KERNELS)
        secs = _build.build()
        report = report.result()
    log(f"nvcc build: {time.perf_counter() - t0:.1f} s wall for "
        f"{len(secs)} kernels in parallel ({secs}), with the ptxas report")
    for name, text in report.items():
        log(f"nvcc -Xptxas -v, csrc/{name}.cu:\n{text}")
        assert "serialized" not in text and not re.search(
            r"[1-9]\d* bytes (spill|stack|cumulative stack)", text), \
            f"csrc/{name}.cu: stack, spills or serialized wgmma"

    # ---- phases 2-3: kernels against their plain versions -----------------
    t0 = time.perf_counter()
    names_full = synthetic_company_names(N_FULL)
    ell_full = TfidfEncoder(StringGrouperConfig()).fit_transform(names_full)
    log(f"corpus: {N_FULL} names generated + encoded in "
        f"{time.perf_counter() - t0:.1f} s ({ell_full.n_terms} terms)")
    if ell_full.device_src is None:
        from string_grouper_tpu_torch.native.build import BUILD_ERROR

        raise RuntimeError(f"no byte-level payload (native build: {BUILD_ERROR})")
    thr = float(M.effective_threshold(0.8))
    h, res_hash = check_hash(K, M, ell_full.device_src, dev)
    res_p1 = check_p1(K, h, thr)
    dom_err = check_p1_domain(K, h, thr)
    res_p1["max_abs_err"] = max(res_p1["max_abs_err"], dom_err)
    torch.cuda.empty_cache()
    res_chain = check_chain(K, h, thr)
    res_chain["max_abs_err"] = max(res_chain["max_abs_err"], dom_err)
    torch.cuda.empty_cache()
    res_tri = check_tri(K, h, thr)
    res_tri["max_abs_err"] = max(res_tri["max_abs_err"], check_tri_domain(K, h, thr))
    torch.cuda.empty_cache()
    tri_launches = tri_square_ab(K, M, h, ell_full.device_src, thr)
    del h, ell_full
    torch.cuda.empty_cache()

    # ---- phase 4: card vs CPU, oracle -------------------------------------
    s20 = pd.Series(synthetic_company_names(N_FRAME))
    K.reset_launches()
    t0 = time.perf_counter()
    card_df = sgt.match_strings(s20)
    t_card = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    assert all(launches[k] > 0 for k in DEFAULT_PATH), f"20k launches {launches}"
    t0 = time.perf_counter()
    cpu_df = sgt.match_strings(s20, device="cpu")
    t_cpu = time.perf_counter() - t0
    pd.testing.assert_frame_equal(card_df, cpu_df)
    log(f"frames ({N_FRAME} names): card == cpu, {len(card_df)} rows; card "
        f"{t_card:.2f} s, cpu {t_cpu:.2f} s; launches {launches}")
    K.reset_launches()
    oracle_frame_check(sgt, TfidfEncoder, StringGrouperConfig,
                       synthetic_company_names(N_ORACLE))
    assert all(K.LAUNCHES[k] > 0 for k in DEFAULT_PATH), f"5k launches {K.LAUNCHES}"

    # ---- phase 5: the full self-join, default and chunked ------------------
    s_full = pd.Series(names_full)

    def self_join(label, path):
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grouper = sgt.StringGrouper(s_full).fit()
        frame = grouper.get_matches()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        secs = grouper.timings.seconds
        log(f"full self-join ({label}): n={N_FULL} wall {wall:.3f} s, "
            f"match.p1_wait {secs['match.p1_wait']:.3f} s, {len(frame)} rows; "
            f"launches {launches}")
        log("timings: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in secs.items()}))
        assert all(launches[k] > 0 for k in path), f"663k launches {launches}"
        assert len(frame) == ROWS_FULL, f"{len(frame)} output rows, expected {ROWS_FULL}"
        assert np.isfinite(frame.similarity.to_numpy()).all()
        return frame, launches

    out, launches = self_join("default", DEFAULT_PATH)
    os.environ["SG_TPU_CHUNKED_P1"] = "1"
    chain_launches = None
    for groups in ("2", "3"):
        os.environ["SG_TPU_CHUNKED_P1_GROUPS"] = groups
        frame, l_chunked = self_join(f"SG_TPU_CHUNKED_P1=1, G={groups}", CHUNKED_PATH)
        pd.testing.assert_frame_equal(frame, out)
        chain_launches = chain_launches or l_chunked["p1_fused_chain"]
        del frame
    del os.environ["SG_TPU_CHUNKED_P1"], os.environ["SG_TPU_CHUNKED_P1_GROUPS"]
    log("chunked self-joins: frames equal to the default run's")

    src = "string_grouper_tpu_torch/csrc/{}.cu"
    pk = "string_grouper_tpu/ops/pallas_kernels.py:{}"
    kernels = [
        dict(name="p1_fused_closed2", route="cuda",
             source=src.format("p1_fused_closed2"), replaces=pk.format(117),
             launches=launches["p1_fused_closed2"], **res_p1),
        dict(name="p1_fused_chain", route="cuda",
             source=src.format("p1_fused_chain"), replaces=pk.format(275),
             launches=chain_launches, **res_chain),
        dict(name="p1_tri_fused", route="cuda",
             source=src.format("p1_tri_fused"), replaces=pk.format(626),
             launches=tri_launches, **res_tri),
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
