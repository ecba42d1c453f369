#!/usr/bin/env python3
"""Smoke run of string_grouper_tpu_torch on one NVIDIA GPU.

Run from the repository root with no arguments:

    python chip_smoke.py

Phases (any failure raises and the script exits non-zero without a result):

1. Device: the card's name and power limit;
   build the CUDA kernels from string_grouper_tpu_torch/csrc/ (one nvcc per
   source, all started together) and print the build time, and beside it
   ``nvcc -Xptxas -v``'s registers, shared memory and spills for the five
   kernels on the TMA/wgmma scan (no stack, no spills and no serialized
   wgmma, and ``p1_fused_closed2`` at its 168 registers, or the phase
   fails).
2. Kernel ``p1_fused_closed2`` against its plain PyTorch version on the
   card, on hash rows of the synthetic 663,000-name corpus (A 32,768 rows,
   B 131,072 rows, d 512, tile 4096, C 64, the default threshold): counts,
   tmax and ship sets equal, bounds within TOL, except rows with a score
   within TOL of the threshold or of another score (counted and printed).
2c. The epilogue A/B kernels on phase 2's inputs: ``p1_mm_floor``'s counts
   bitwise ``p1_fused_closed2``'s, and ``p1_closed2_variant`` under each of
   its four switch pairs (block rows 128 / 64, argmax first / minidx)
   bitwise ``p1_fused_closed2``'s outputs; each against its plain version
   by phase 2's rule (rows with a score within TOL of thr excepted); then,
   with the counts set to 0, each timed (CUDA events) beside its bound,
   ``p1_fused_closed2`` and ``torch.mm``.  No path of the matcher launches
   either: every main-path run below must count 0 of both.
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
3f. The packed-slot torch op ``_device_hash`` (not a hand kernel) on the
   663k corpus's ``pack_hash_inputs`` at its full ELL width: on the card
   bitwise equal to the same op on the CPU over the first 20,000 rows (the
   count of differing elements is printed), timed beside its bytes bound
   and an ``index_add_`` yardstick.
4. ``match_strings`` on the card frame-equal to ``device="cpu"`` at 20,000
   names, and equal to a brute-force fp64 cosine oracle at 5,000 names;
   then three payload-less fits on the packed-slot hash, each card == CPU
   with ``p1_fused_closed2`` launched and ``device_hash_codes`` not: the
   float32 and the custom-regex self-joins at 20,000 names, and a float32
   cross-join of them against 5,000 names.  Then the other entry points,
   card == CPU (exactly): ``group_similar_strings`` at 20,000 names with
   ``group_rep`` centroid and first and ``match_most_similar`` of them
   against 5,000 names (both with ``p1_fused_closed2`` and
   ``device_hash_codes`` launched), and ``compute_pairwise_similarities``
   on 5,000 pairs (a host encode and row dot).  Then the 20,000-name
   self-join under ``SG_TPU_FUSED=0``: the same frame with no
   ``p1_fused_closed2`` launch (the torch-op body everywhere); and the
   torch op ``hashed_projection`` (ops/hashing.py, off the main path) on
   the card over the 20,000-name ELL, bitwise its CPU result, timed beside
   its bytes bound and an ``index_add_`` yardstick.  Last, the 20,000-name
   self-join under ``utils.profiling.trace``: the phase-4 frame, and a trace
   file (under build/) holding CUDA kernel events of ``p1_fused_closed2``'s
   library (``scan_kernel``).
5. The full self-join at 663,000 names on the card: wall time, phases,
   escalation rungs, kernel launches, and the output row count.  On that
   run's grouper, with no refit: ``get_groups()`` (time, group count), and
   the torch op ``_cc_labels`` on the card over its matches list, equal to
   the native union-find's labels, each timed (the op beside its bytes
   bound).  Then the same self-join with the column-chunked pipeline
   (SG_TPU_CHUNKED_P1=1) at G = 2 and G = 3 chunks, and on the packed-slot
   path (SG_TPU_DEVICE_ENCODE=0: no ``device_hash_codes`` launch): the same
   frame, with p1_wait and wall printed.  Last, ``match_most_similar`` of
   the 663,000 names against 100,000 others: wall, phases, launches,
   100,000 output rows, and the verbatim check of
   ``check_verbatim_duplicates``.  The whole phase runs with
   ``torch.backends.cuda.matmul.allow_tf32`` set to True, and after it the
   flag and ``torch.get_float32_matmul_precision()`` must still read what
   was set (the matcher restores the caller's setting).
6. The mesh tier (``mesh=``: the host encode, then phase 1 per
   (segment, shard) on each shard's device).  At 20,000 names
   ``match_strings`` under ``make_mesh()`` (every visible GPU) and under
   virtual meshes over one card at (1, 2), (2, 2), (1, 4) and (4, 1), each
   equal to phase 4's card frame with ``p1_fused_closed2`` and
   ``device_hash_codes`` launched; ``group_similar_strings`` on a (2, 2)
   mesh, the float32 self-join on a (2, 2) mesh (the packed-slot hash: no
   ``device_hash_codes`` launch) and ``compute_pairwise_similarities`` on
   a (2, 4) mesh, each equal to phase 4's frame.  Then the 663,000-name
   self-join on a (2, 2) virtual mesh: 4,558,752 rows, the frame of
   phase 5's default run, wall, phases and launches printed, and
   ``p1_fused_closed2`` launched once per (segment, shard); the mesh's
   collectives (``_dist_match`` less its ``_local_block`` launches, and
   ``_sort_compact``) timed by CUDA events beside their bytes bound.
7. The multi-process tiers (``multihost=``): two ``torch.distributed``
   ranks, fresh processes of this script (``--rank``), joined by gloo at
   tcp://127.0.0.1:<free port>, both on ``cuda:0``, each with
   ``number_of_processes`` = (cores - 1) // 2.  At 20,000 names, the
   replicated self-join (auto-selected from the group), the sharded
   self-join, a cross-join with ids against 5,000 names,
   ``group_similar_strings``, ``match_most_similar`` and the float32
   self-join: each rank's frame equal to the single-process card frame of
   the same call (phase 4's, or one made here).  Then the 663,000-name
   self-join on the replicated tier (4,558,752 rows, phase 5's default
   frame on both ranks, ``p1_fused_closed2`` and ``device_hash_codes``
   launched on each) and ``synthetic_company_names(100_000)`` on the
   sharded tier (the single-process card frame; stages, escalated rows,
   the ladder's rows and walls, the memory keys and launches printed; the
   memory bounds of tests/mh_engine_worker.py asserted).  Its per-rank
   scan (``_local_block``, CUDA events) and exchange (``_exchange_rows``,
   host clock) are timed beside their bounds.  Then the sharded tier with
   2 device slots per rank (``mesh=`` a (1, 2) virtual mesh over the card,
   so 4 devices in all): the 20,000-name self-join (phase 4's frame) and
   the 663,000-name self-join (4,558,752 rows, phase 5's default frame;
   stages, escalated rows, ladder rows and walls, memory keys and launches
   printed; each slot's first-pass launch timed by CUDA events beside its
   operations bound), each with ``p1_fused_closed2`` launched once per
   slot on every kt = 2 pass.  A rank that fails or overruns its limit
   fails the phase.

Without a CUDA GPU, or without the repository beside it, it exits non-zero
and prints no result.  ``python chip_smoke.py --rank R WORLD PORT DIR`` is
phase 7's rank R (started by the script itself).
"""

import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from pathlib import Path

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
# Duplicates matched against the full corpus by match_most_similar.
N_NEAREST = 100_000
# Score tolerance between the kernel and its plain version: f32 sums of 512
# bf16 products in different orders differ by far less than this.
TOL = 1e-5
# Kernels each path launches: the default self-join (and its kt=2
# escalation), and the column-chunked one (its escalation may add
# p1_fused_closed2).
DEFAULT_PATH = ("p1_fused_closed2", "device_hash_codes")
CHUNKED_PATH = ("p1_fused_chain", "device_hash_codes")
# ... and the packed-slot path (payload-less corpora, SG_TPU_DEVICE_ENCODE=0),
# whose hash is the torch op ``_device_hash``: device_hash_codes must stay 0.
PACKED_PATH = ("p1_fused_closed2",)
CUSTOM_REGEX = r"[,-./#&]|\s"
# The five kernels on the TMA/wgmma scan (csrc/p1_scan_sm90.cuh).
SCAN_KERNELS = ("p1_fused_closed2", "p1_fused_chain", "p1_tri_fused",
                "p1_mm_floor", "p1_closed2_variant")
# p1_fused_closed2's registers a thread (ptxas; 65,536 / 384 threads).
CLOSED2_REGISTERS = 168
# The epilogue's A/B kernels: no path of the matcher launches them.
AB_KERNELS = ("p1_mm_floor", "p1_closed2_variant")
# Rows of the 663k payload that phase 3 also hashes with the plain version
# on the CPU.
N_HASH_CPU = 20_000
# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth).
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# Its host link, PCIe Gen5 x16, one direction (published): the floor of
# what a rank's exchange moves from the card to the host.
PEAK_PCIE = 64e9
# Phase 7: ranks on the one card, the sharded run's corpus, and the wall
# limit of the ranks together.
WORLD = 2
N_SHARDED = 100_000
RANK_LIMIT_S = 480
# Device slots per rank in phase 7's sharded runs over a virtual mesh.
SLOTS = 2


START = time.perf_counter()


def log(*args):
    print(*args, flush=True)


def stamp(what: str) -> None:
    """Seconds since the script started, at the start of a phase."""
    log(f"[{time.perf_counter() - START:.1f} s] {what}")


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


def assert_off_path(launches, label):
    """A main-path run launched neither of the epilogue's A/B kernels."""
    assert all(launches[k] == 0 for k in AB_KERNELS), f"{label}: launches {launches}"


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


# ----------------------------------------------------------------- phase 2c
def compare_counts(what, got, want, a, b, thr):
    """Per-row qualified counts of a kernel ``got`` against its plain
    version's ``want``: equal, except rows with a score (against the
    columns ``b``) within TOL of the threshold.  Returns the number of
    those borderline rows."""
    rows = torch.nonzero(got != want).flatten().tolist()
    assert len(rows) <= 2000, f"{what}: {len(rows)} rows differ"
    b64 = b.double()
    for r in rows:
        near = bool((((b64 @ a[r].double()) - thr).abs() <= TOL).any())
        assert near, f"{what} row {r}: counts {int(got[r])} / {int(want[r])} with no score near thr"
    return len(rows)


def check_epilogue_ab(K, h, thr, m=32_768, n=131_072):
    """Phase 2c: ``p1_mm_floor`` and ``p1_closed2_variant`` on phase 2's
    inputs, bitwise ``p1_fused_closed2`` and against their plain versions;
    then their A/B run (launches counted from 0), each timed beside its
    bound, ``p1_fused_closed2`` and ``torch.mm``.  Returns their kernel
    rows."""
    tile, cand_c = 4096, 64
    a = h[:m].contiguous()
    b = h[:n].contiguous()
    ref = K.p1_fused_closed2(a, b, thr, tile, cand_c)
    floor = K.p1_mm_floor(a, b, thr)
    torch.cuda.synchronize()
    assert torch.equal(floor, ref[1]), "p1_mm_floor != p1_fused_closed2's counts"
    nb_f = compare_counts("p1_mm_floor", floor, K.p1_mm_floor_plain(a, b, thr), a, b, thr)
    err_v, nb_v = 0.0, 0
    switches = [(r, t) for r in K.VARIANT_BLOCK_ROWS for t in K.VARIANT_ARGMAX]
    for rows, tie in switches:
        got = K.p1_closed2_variant(a, b, thr, tile, cand_c, rows, tie)
        torch.cuda.synchronize()
        for name, g, w in zip(("ship", "counts", "tmax", "bound", "max_cnt"), got, ref):
            assert torch.equal(g, w), f"p1_closed2_variant {rows}/{tie} != p1_fused_closed2: {name}"
        want = K.p1_closed2_variant_plain(a, b, thr, tile, cand_c, rows, tie)
        err, nb = compare_scan(f"p1_closed2_variant {rows}/{tie}", got[:4], want[:4],
                               a, b, thr)
        err_v, nb_v = max(err_v, err), max(nb_v, nb)
    log(f"epilogue A/B kernels vs p1_fused_closed2 (A {m} x B {n} x 512, tile {tile}, "
        f"C {cand_c}): p1_mm_floor's counts bitwise its counts ({int(floor.sum())} "
        f"qualified), p1_closed2_variant bitwise under {switches}; vs plain: "
        f"p1_mm_floor {m - nb_f} rows equal, {nb_f} borderline; p1_closed2_variant "
        f"equal but {nb_v} borderline rows, max |bound diff| {err_v}")

    # the A/B run: the kernels' own path, counted from 0
    K.reset_launches()
    closed_ms = cuda_ms(lambda: K.p1_fused_closed2(a, b, thr, tile, cand_c), 5)
    floor_ms = cuda_ms(lambda: K.p1_mm_floor(a, b, thr), 5)
    var_ms = {f"{r}/{t}": cuda_ms(lambda r=r, t=t: K.p1_closed2_variant(
        a, b, thr, tile, cand_c, r, t), 5) for r, t in switches}
    launches = dict(K.LAUNCHES)
    floor_plain_ms = cuda_ms(lambda: K.p1_mm_floor_plain(a, b, thr), 2)
    var_plain_ms = cuda_ms(lambda: K.p1_closed2_variant_plain(
        a, b, thr, tile, cand_c, 128, "minidx"), 2)
    lib_ms = cuda_ms(lambda: torch.mm(a, b.t()), 3)
    flops = 2.0 * m * n * 512
    floor_bound = max(flops / PEAK_BF16, ((m + n) * 512 * 2 + m * 4) / PEAK_BYTES) * 1e3
    var_bound = max(flops / PEAK_BF16,
                    ((m + n) * 512 * 2 + m * cand_c * 4 + m * 12) / PEAK_BYTES) * 1e3
    log(f"epilogue A/B (CUDA events, A {m} x B {n}): p1_fused_closed2 {closed_ms} ms, "
        f"p1_mm_floor {floor_ms} ms (epilogue share {(closed_ms - floor_ms) / closed_ms}), "
        f"p1_closed2_variant by block rows/argmax {json.dumps(var_ms)} ms; bound "
        f"{var_bound} ms (operations); torch.mm bf16 {lib_ms} ms; plain p1_mm_floor "
        f"{floor_plain_ms} ms, plain variant (128/minidx) {var_plain_ms} ms; launches {launches}")
    assert launches["p1_mm_floor"] > 0 and launches["p1_closed2_variant"] > 0, launches
    return (
        # the other rows' counts are equal: no error to report
        dict(launches=launches["p1_mm_floor"], max_abs_err=0.0, ms=floor_ms,
             plain_ms=floor_plain_ms, bound_ms=floor_bound, bound_by="operations",
             library_ms=lib_ms),
        dict(launches=launches["p1_closed2_variant"], max_abs_err=err_v,
             ms=var_ms["128/first"], plain_ms=var_plain_ms, bound_ms=var_bound,
             bound_by="operations", library_ms=lib_ms, ms_by_switch=var_ms),
    )


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


# ----------------------------------------------------------------- phase 3f
def check_packed_hash(M, ell, dev):
    """The packed-slot torch op ``_device_hash`` (not a hand kernel) on the
    663k corpus at its full ELL width: on the card against the same op on
    the CPU over the first N_HASH_CPU rows (both sum each bucket in slot
    order: bitwise), timed beside its bytes bound and an ``index_add_``
    yardstick over the same (row, bucket, value) slots."""
    t0 = time.perf_counter()
    packed_h = M.pack_hash_inputs(ell, ell.n_rows, 512)
    pack_s = time.perf_counter() - t0
    packed = M._to_device(packed_h, dev)
    n, w = packed.shape
    h = M._device_hash(packed, 512)
    assert torch.equal(h, M._device_hash(packed, 512)), "_device_hash not repeatable"
    r = min(N_HASH_CPU, n)
    h_c = M._device_hash(packed[:r].cpu(), 512)
    n_diff = int((h[:r].cpu().view(torch.int16) != h_c.view(torch.int16)).sum())
    log(f"_device_hash (torch op) on the card vs on the CPU: first {r} rows: "
        f"{n_diff} of {h_c.numel()} elements differ (bitwise required)")
    assert n_diff == 0, f"_device_hash: {n_diff} elements differ from the CPU"
    assert int((h.float().abs().sum(1) > 0).sum()) > 0.99 * n

    x = packed.long()
    ok = x != 0
    flat = (torch.arange(n, device=dev)[:, None] * 512 + (x >> 16))[ok]
    vals = ((x & 0xFFFF).float() * (1.0 / 65535.0))[ok]
    del x, ok
    acc = torch.zeros(n * 512, dtype=torch.float32, device=dev)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, flat, vals), 5)
    ms = cuda_ms(lambda: M._device_hash(packed, 512), 3)
    nbytes = n * w * 4 + n * 512 * 2
    bound_ms = nbytes / PEAK_BYTES * 1e3
    log(f"_device_hash (torch op): n={n} W={w} dim=512: ms={ms} "
        f"bound_ms={bound_ms} (bytes: n*W*4 read + n*512*2 written) "
        f"library_ms(index_add_ of {len(vals)} slot values)={lib_ms}; "
        f"host pack_hash_inputs {pack_s:.3f} s")


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


def assert_same(got, want):
    """Card and CPU outputs of an entry point: equal, exactly."""
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    else:
        pd.testing.assert_series_equal(got, want, check_exact=True)


def check_hashed_projection(TH, ell, dev, dim=512):
    """The torch op ``hashed_projection`` (ops/hashing.py, off the main
    path) on the card over an ELL: bitwise its CPU result (one
    ``scatter_add_`` per slot column, so each bucket sums in slot order on
    both), timed beside its bytes bound and one ``index_add_`` of the same
    (row * dim + bucket, value) pairs."""
    ids = torch.from_numpy(ell.ids)
    vals = torch.from_numpy(ell.vals64.astype(np.float32))
    want = TH.hashed_projection(ids, vals, dim)
    ids_d, vals_d = ids.to(dev), vals.to(dev)
    got = TH.hashed_projection(ids_d, vals_d, dim).cpu()
    n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    assert n_diff == 0, f"hashed_projection: {n_diff} elements differ from the CPU"
    ms = cuda_ms(lambda: TH.hashed_projection(ids_d, vals_d, dim), 3)
    n, w = ell.ids.shape
    nbytes = n * w * 8 + n * dim * 4  # ids + values read once, f32 out written once
    valid = ids_d >= 0
    flat = (torch.arange(n, device=dev)[:, None] * dim
            + TH.bucket_of(ids_d, dim).long())[valid]
    v = vals_d[valid]
    lib_ms = cuda_ms(lambda: torch.zeros(n * dim, device=dev).index_add_(0, flat, v), 3)
    log(f"hashed_projection (torch op, off the main path) on the card: {n} x {w} slots "
        f"-> ({n}, {dim}) f32; 0 of {got.numel()} elements differ from the CPU; "
        f"ms={ms} bound_ms={nbytes / PEAK_BYTES * 1e3} (bytes) library_ms(index_add_ of "
        f"{int(valid.sum())} values)={lib_ms}")


# ------------------------------------------------------------------ phase 5
def check_cc_labels(CC, matches, n, dev):
    """The torch op ``_cc_labels`` on the card over a matches list's edges
    against the native union-find (the grouping path whenever the host
    library builds): labels equal, both timed.  The op syncs with the host
    once per round (its loop ends on the first round that changes no
    label), so its CUDA-event time spans those waits too."""
    a_h = np.ascontiguousarray(matches.master_side.to_numpy(), dtype=np.int64)
    b_h = np.ascontiguousarray(matches.dupe_side.to_numpy(), dtype=np.int64)
    native_s = []
    for _ in range(2):  # the first call also loads the library
        t0 = time.perf_counter()
        want = CC.connected_components(a_h, b_h, n, dev)
        native_s.append(time.perf_counter() - t0)
    a = torch.tensor(a_h, device=dev)
    b = torch.tensor(b_h, device=dev)
    got = CC._cc_labels(a, b, n).cpu().numpy()
    n_diff = int((got != want).sum())
    assert n_diff == 0, f"_cc_labels: {n_diff} of {n} labels differ from the union-find"
    ms = cuda_ms(lambda: CC._cc_labels(a, b, n), 3)
    nbytes = 2 * len(a_h) * 8 + n * 8  # both edge ends read once, labels written once
    bound_ms = nbytes / PEAK_BYTES * 1e3
    log(f"_cc_labels (torch op) on the card: n={n} nodes, {len(a_h)} edges, "
        f"{len(np.unique(want))} components; labels equal to the native "
        f"union-find's (0 of {n} differ); ms={ms} bound_ms={bound_ms} (bytes: "
        f"2*E*8 read + n*8 written); native union-find {native_s[1] * 1e3} ms "
        f"on the host (first call {native_s[0] * 1e3} ms)")


def check_verbatim_duplicates(master, dupes, matches):
    """``match_most_similar``'s matches list (max_n_matches=1): every
    duplicate whose string is present verbatim in the master matched at
    similarity >= 1 - 1e-12, except a repeat whose master copies each kept
    another duplicate at that similarity.  The cap is per master row (the
    reference's), so a repeated duplicate string is left to a weaker match
    or to itself, as in the JAX package.  Returns (verbatim, matched at 1,
    repeats)."""
    one = 1.0 - 1e-12
    best = (matches.groupby("dupe_side").similarity.max()
            .reindex(range(len(dupes))).to_numpy())
    verbatim = dupes.isin(set(master)).to_numpy()
    short = np.flatnonzero(verbatim & ~(best >= one))
    if len(short):
        top1 = matches.set_index("master_side")
        assert top1.index.is_unique, "more than one match kept for a master row"
        need = dupes.to_numpy()[short]
        m_idx = np.flatnonzero(master.isin(set(need)).to_numpy())
        copies = pd.Series(m_idx, index=master.to_numpy()[m_idx])
        for d, text in zip(short, need):
            kept = top1.reindex(np.atleast_1d(copies.loc[text]))
            assert not kept.similarity.isna().any() and (kept.similarity >= one).all() \
                and (kept.dupe_side != d).all(), \
                f"duplicate {d} ({text!r}) is in the master but matched nothing at 1"
    return int(verbatim.sum()), int(verbatim.sum() - len(short)), len(short)


# ------------------------------------------------------------------ phase 6
def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _nbytes(out) -> int:
    return sum(t.nbytes for t in out if torch.is_tensor(t))


def spy_mesh_collectives(D):
    """Wrap the mesh tier's ``_dist_match``, ``_local_block`` and
    ``_sort_compact`` (module attributes of ``D``, looked up at each call)
    with CUDA events.  Returns ``(restore, report)``: ``report()`` gives the
    collectives' device time -- each ``_dist_match`` less the
    ``_local_block`` launches inside it (the moves onto ``devices[0, 0]``,
    the width ``cat``, the ``amax`` and the row reorder) -- and
    ``_sort_compact``'s, each beside its bytes (inputs read once, outputs
    written once)."""
    names = ("_dist_match", "_local_block", "_sort_compact")
    real = {n: getattr(D, n) for n in names}
    blocks, dists, sorts = [], [], []

    def local_block(*a, **k):
        e0, e1 = _events()
        e0.record()
        out = real["_local_block"](*a, **k)
        e1.record()
        blocks.append((e0, e1, _nbytes(out)))
        return out

    def dist_match(*a, **k):
        e0, e1 = _events()
        n0 = len(blocks)
        e0.record()
        out = real["_dist_match"](*a, **k)
        e1.record()
        dists.append((e0, e1, blocks[n0:], _nbytes(out)))
        return out

    def sort_compact(cols, budget):
        e0, e1 = _events()
        e0.record()
        out = real["_sort_compact"](cols, budget)
        e1.record()
        sorts.append((e0, e1, cols.nbytes + _nbytes(out)))
        return out

    for n, f in zip(names, (dist_match, local_block, sort_compact)):
        setattr(D, n, f)

    def restore():
        for n in names:
            setattr(D, n, real[n])

    def report():
        torch.cuda.synchronize()
        coll_ms = sum(e0.elapsed_time(e1) - sum(b0.elapsed_time(b1) for b0, b1, _ in bl)
                      for e0, e1, bl, _ in dists)
        coll_bytes = sum(sum(nb for _, _, nb in bl) + out_b for _, _, bl, out_b in dists)
        sort_ms = sum(e0.elapsed_time(e1) for e0, e1, _ in sorts)
        sort_bytes = sum(nb for _, _, nb in sorts)
        return dict(
            dist_calls=len(dists), collectives_ms=coll_ms, collectives_bytes=coll_bytes,
            collectives_bound_ms=coll_bytes / PEAK_BYTES * 1e3,
            sort_calls=len(sorts), sort_compact_ms=sort_ms, sort_bytes=sort_bytes,
            sort_bound_ms=sort_bytes / PEAK_BYTES * 1e3,
        )

    return restore, report


# ------------------------------------------------------------------ phase 7
def spy_rank_scan(MH, slots=1):
    """Wrap the multi-process tiers' ``_local_block`` (CUDA events; one
    call per slot per scan pass) and ``_exchange_rows`` (host clock, after
    a synchronize so the scan's own device time stays out of it).  Returns
    ``(restore, report)``; ``report()`` gives each slot's scan beside its
    operations bound -- the first pass's ``slots`` calls also on their own
    -- and the exchanges beside their bytes bound (what the card must send
    to the host, at the host link's rate), and the first slot's
    ``torch.mm`` of the same operands (in row blocks of at most 16 GiB of
    product) as its library yardstick."""
    real_block, real_exchange = MH._local_block, MH._exchange_rows
    scans, exchanges, first = [], [], []

    def local_block(a_rows, b_loc, thr, col_off, *a, **k):
        e0, e1 = _events()
        e0.record()
        out = real_block(a_rows, b_loc, thr, col_off, *a, **k)
        e1.record()
        if not first:
            first.extend((a_rows, b_loc))
        scans.append(dict(rows=a_rows.shape[0], cols=b_loc.shape[0], d=b_loc.shape[1],
                          col_off=col_off, device=str(b_loc.device),
                          k_tile=k["k_tile"], cand_c=k["cand_c"], fused=k["fused"],
                          ev=(e0, e1)))
        return out

    def exchange(cols, bound, tmax, starts, counts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_exchange(cols, bound, tmax, starts, counts)
        exchanges.append(dict(s=time.perf_counter() - t0,
                              bytes=cols.nbytes + bound.nbytes + tmax.nbytes,
                              rows_out=len(out[0])))
        return out

    MH._local_block, MH._exchange_rows = local_block, exchange

    def restore():
        MH._local_block, MH._exchange_rows = real_block, real_exchange

    def report():
        torch.cuda.synchronize()
        passes = []
        for sc in scans:
            e0, e1 = sc.pop("ev")
            ops = 2 * sc["rows"] * sc["cols"] * sc["d"]
            passes.append(dict(sc, ms=e0.elapsed_time(e1), bound_ms=ops / PEAK_BF16 * 1e3))
        # the yardstick in row blocks whose bf16 product fits 16 GiB (the
        # 663k slot's whole product would need 207 GiB)
        a, b = first
        blk = max(1, (16 << 30) // (b.shape[0] * a.element_size()))

        def mm_blocks():
            for i in range(0, a.shape[0], blk):
                torch.mm(a[i:i + blk], b.T)  # each product freed at once

        lib_ms = cuda_ms(mm_blocks, 3)
        first.clear()
        torch.cuda.empty_cache()
        ex_bytes = sum(e["bytes"] for e in exchanges)
        return dict(
            scan_passes=passes, first_scan_ms=passes[0]["ms"],
            first_scan_bound_ms=passes[0]["bound_ms"], first_scan_library_ms=lib_ms,
            first_pass_slots=[dict(col_off=p["col_off"], ms=p["ms"], bound_ms=p["bound_ms"],
                                   fused=p["fused"]) for p in passes[:slots]],
            fused_calls=sum(p["fused"] for p in passes),
            kt2_calls=sum(p["k_tile"] == 2 for p in passes),
            all_scans_ms=sum(p["ms"] for p in passes),
            all_scans_bound_ms=sum(p["bound_ms"] for p in passes),
            exchanges=len(exchanges), exchange_ms=sum(e["s"] for e in exchanges) * 1e3,
            exchange_bytes=ex_bytes, exchange_bound_ms=ex_bytes / PEAK_PCIE * 1e3,
        )

    return restore, report


def _free_port() -> str:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return str(sock.getsockname()[1])


def run_ranks(out_dir: Path) -> list:
    """Phase 7's ranks: WORLD fresh processes of this script, to their end
    within RANK_LIMIT_S together.  A rank that fails or overruns fails the
    phase (every rank is killed first).  Returns their result records."""
    port = _free_port()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    logs = [open(out_dir / f"rank_{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r), str(WORLD),
         port, str(out_dir)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    deadline = time.perf_counter() + RANK_LIMIT_S
    failed = None
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                failed = f"rank {r} overran the phase's {RANK_LIMIT_S} s limit"
                break
            if rc != 0:
                failed = f"rank {r} exited with {rc}"
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r in range(WORLD):
        for line in (out_dir / f"rank_{r}.log").read_text().splitlines():
            log(f"  [rank {r}] {line}")
    if failed:
        raise RuntimeError(f"phase 7: {failed}")
    return [json.loads((out_dir / f"rank_{r}.json").read_text()) for r in range(WORLD)]


def rank_main(args) -> int:
    """One rank of phase 7 (``--rank R WORLD PORT DIR``): joins the gloo
    group, runs the phase's calls on ``cuda:0`` and holds each frame
    against the parent's single-process frame pickled in DIR; writes its
    record to DIR/rank_R.json."""
    rank, world, port, out_dir = int(args[0]), int(args[1]), args[2], Path(args[3])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 2
    import torch.distributed as dist

    import string_grouper_tpu_torch as sgt
    from string_grouper_tpu_torch.ops import kernels as K
    from string_grouper_tpu_torch.parallel import Mesh
    from string_grouper_tpu_torch.parallel import multihost as MH
    from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=300))
    threads = max(1, ((os.cpu_count() or 2) - 1) // world)
    log(f"rank {rank} of {world} on {torch.cuda.get_device_name(0)} (cuda:0), "
        f"number_of_processes={threads}")
    rec = dict(rank=rank, launches={}, stages={})

    def check(label, got, want, path, wall, sg=None):
        launches = dict(K.LAUNCHES)
        assert_same(got, pd.read_pickle(out_dir / f"want_{want}.pkl"))
        assert all(launches[k] > 0 for k in path), f"{label}: launches {launches}"
        if path == PACKED_PATH:
            assert launches["device_hash_codes"] == 0, f"{label}: launches {launches}"
        rec["launches"][label] = launches
        tier = ""
        if sg is not None:
            rec["stages"][label] = {k: v for k, v in sg.timings.seconds.items()
                                    if k.startswith("match.mh_")}
            tier = f", tier {sg.timings.labels['multihost_tier']}"
        log(f"{label}: equal to the single-process card frame, {len(got)} rows; "
            f"{wall:.3f} s{tier}; launches {launches}")

    def fit(series, other=None, **kw):
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sg = sgt.StringGrouper(series, other, number_of_processes=threads, **kw).fit()
        frame = sg.get_matches()
        return frame, sg, time.perf_counter() - t0

    def call(fn, *args, **kw):
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, number_of_processes=threads, **kw)
        return out, time.perf_counter() - t0

    def check_memory(st):
        """tests/mh_engine_worker.py's memory bounds of the sharded tier."""
        local_b = st["match.mh_mem_local_ell_bytes"]
        full_b = st["match.mh_mem_replicated_ell_bytes"]
        visit_b = st["match.mh_mem_peak_visit_bytes"]
        assert local_b * world <= full_b * 1.5, (local_b, full_b, world)
        assert visit_b <= full_b * 1.5 / world + 1, (visit_b, full_b, world)

    # the sharded tier over SLOTS device slots per rank: a (1, SLOTS)
    # virtual mesh over the card, WORLD x SLOTS devices in all
    slot_mesh = Mesh([[torch.device("cuda", 0)] * SLOTS])

    def sharded_slots(label, series, want):
        """A sharded fit over the rank's slots: the single-process frame,
        and ``p1_fused_closed2`` launched once per slot on every kt = 2
        pass (the ladder's wider rungs run the torch-op body)."""
        restore, report = spy_rank_scan(MH, SLOTS)
        try:
            frame, sg, wall = fit(series, multihost="sharded", mesh=slot_mesh)
        finally:
            restore()
        check(label, frame, want, DEFAULT_PATH, wall, sg)
        sc = report()
        n_fused = rec["launches"][label]["p1_fused_closed2"]
        assert sc["kt2_calls"] >= SLOTS and sc["kt2_calls"] % SLOTS == 0, sc["kt2_calls"]
        assert sc["fused_calls"] == sc["kt2_calls"] == n_fused, (sc["fused_calls"], n_fused)
        assert [p["col_off"] for p in sc["first_pass_slots"]] == [
            (rank * SLOTS + j) * sc["scan_passes"][0]["cols"] for j in range(SLOTS)]
        log(f"{label}: p1_fused_closed2 launched {n_fused} times, once per slot on each "
            f"of {sc['kt2_calls'] // SLOTS} kt=2 pass(es); first pass per slot: "
            + json.dumps(sc["first_pass_slots"]))
        return frame, sg, sc

    try:
        s20 = pd.Series(synthetic_company_names(N_FRAME))
        dupes5 = pd.Series(synthetic_company_names(N_ORACLE, seed=7))
        ids20 = pd.Series([f"m{i}" for i in range(N_FRAME)])
        ids5 = pd.Series([f"d{i}" for i in range(N_ORACLE)])
        frame, sg, wall = fit(s20)
        assert sg.timings.labels["multihost_tier"] == "replicated"
        check(f"self-join {N_FRAME} (auto)", frame, "self", DEFAULT_PATH, wall, sg)
        frame, sg, wall = fit(s20, multihost="sharded")
        check(f"self-join {N_FRAME} sharded", frame, "self", DEFAULT_PATH, wall, sg)
        out, wall = call(sgt.match_strings, s20, dupes5, ids20, ids5)
        check(f"cross-join with ids {N_FRAME} x {N_ORACLE}", out, "cross_ids",
              DEFAULT_PATH, wall)
        out, wall = call(sgt.group_similar_strings, s20)
        check(f"group_similar_strings {N_FRAME}", out, "groups", DEFAULT_PATH, wall)
        out, wall = call(sgt.match_most_similar, s20, dupes5)
        check(f"match_most_similar {N_FRAME} x {N_ORACLE}", out, "nearest",
              DEFAULT_PATH, wall)
        frame, sg, wall = fit(s20, tfidf_matrix_dtype=np.float32)
        check(f"float32 self-join {N_FRAME}", frame, "f32", PACKED_PATH, wall, sg)
        sharded_slots(f"self-join {N_FRAME} sharded, {SLOTS} slots", s20, "self")

        s_full = pd.Series(synthetic_company_names(N_FULL))
        frame, sg, wall = fit(s_full)
        assert sg.timings.labels["multihost_tier"] == "replicated"
        assert len(frame) == ROWS_FULL, f"{len(frame)} output rows, expected {ROWS_FULL}"
        check(f"self-join {N_FULL} replicated", frame, "full", DEFAULT_PATH, wall, sg)
        log("stages: " + json.dumps(rec["stages"][f"self-join {N_FULL} replicated"]))
        del frame, sg

        s_sh = pd.Series(synthetic_company_names(N_SHARDED))
        restore, report = spy_rank_scan(MH)
        try:
            frame, sg, wall = fit(s_sh, multihost="sharded")
        finally:
            restore()
        label = f"self-join {N_SHARDED} sharded"
        check(label, frame, "sharded_100k", DEFAULT_PATH, wall, sg)
        st = rec["stages"][label]
        check_memory(st)
        log("stages: " + json.dumps(st))
        rec["scan"] = report()
        log("scan and exchange: " + json.dumps(rec["scan"]))
        del frame, sg, s_sh

        label = f"self-join {N_FULL} sharded, {SLOTS} slots"
        frame, sg, sc = sharded_slots(label, s_full, "full")
        assert len(frame) == ROWS_FULL, f"{len(frame)} output rows, expected {ROWS_FULL}"
        st = rec["stages"][label]
        check_memory(st)
        log("stages: " + json.dumps(st))
        rec["scan_slots"] = sc
        log("scan and exchange: " + json.dumps(
            {k: v for k, v in sc.items() if k != "scan_passes"}))
        log("scan passes (one entry per slot): " + json.dumps(sc["scan_passes"]))
        del frame, sg, s_full
    finally:
        dist.destroy_process_group()
    (out_dir / f"rank_{rank}.json").write_text(json.dumps(rec))
    return 0


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
    from string_grouper_tpu_torch.ops import connected_components as CC
    from string_grouper_tpu_torch.utils.synthetic import synthetic_company_names

    from string_grouper_tpu_torch.parallel import Mesh, make_mesh
    from string_grouper_tpu_torch.parallel import distributed as D

    from string_grouper_tpu_torch.ops import hashing as TH
    from string_grouper_tpu_torch.utils import profiling as PR

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
    regs = re.findall(r"Used (\d+) registers", report["p1_fused_closed2"])
    assert regs == [str(CLOSED2_REGISTERS)], f"p1_fused_closed2 registers {regs}"

    # ---- phases 2-3: kernels against their plain versions -----------------
    stamp("phases 2-3e: kernels against their plain versions")
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
    stamp("phase 2c: the epilogue A/B kernels")
    res_floor, res_variant = check_epilogue_ab(K, h, thr)
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
    del h
    torch.cuda.empty_cache()
    stamp("phase 3f: the packed-slot torch op")
    check_packed_hash(M, ell_full, dev)
    del ell_full
    torch.cuda.empty_cache()

    # ---- phase 4: card vs CPU, oracle -------------------------------------
    stamp("phase 4: card vs CPU frames, oracle")
    s20 = pd.Series(synthetic_company_names(N_FRAME))
    K.reset_launches()
    t0 = time.perf_counter()
    card_df = sgt.match_strings(s20)
    t_card = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    assert all(launches[k] > 0 for k in DEFAULT_PATH), f"20k launches {launches}"
    assert_off_path(launches, "20k default")
    t0 = time.perf_counter()
    cpu_df = sgt.match_strings(s20, device="cpu")
    t_cpu = time.perf_counter() - t0
    pd.testing.assert_frame_equal(card_df, cpu_df)
    frames4 = {"default": card_df}  # phase 4's card frames, for phase 6
    log(f"frames ({N_FRAME} names): card == cpu, {len(card_df)} rows; card "
        f"{t_card:.2f} s, cpu {t_cpu:.2f} s; launches {launches}")
    K.reset_launches()
    oracle_frame_check(sgt, TfidfEncoder, StringGrouperConfig,
                       synthetic_company_names(N_ORACLE))
    assert all(K.LAUNCHES[k] > 0 for k in DEFAULT_PATH), f"5k launches {K.LAUNCHES}"
    # payload-less corpora: the packed-slot hash feeds the fused kernel
    stamp("phase 4: payload-less fits, card vs CPU")
    dupes5 = pd.Series(synthetic_company_names(N_ORACLE, seed=7))
    for label, args, kw in (
        ("float32 self-join", (s20,), dict(tfidf_matrix_dtype=np.float32)),
        ("custom-regex self-join", (s20,), dict(regex=CUSTOM_REGEX)),
        (f"float32 cross-join vs {N_ORACLE}", (s20, dupes5),
         dict(tfidf_matrix_dtype=np.float32, min_similarity=0.7)),
    ):
        K.reset_launches()
        t0 = time.perf_counter()
        card_df = sgt.match_strings(*args, **kw)
        t_card = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        assert all(launches[k] > 0 for k in PACKED_PATH), f"{label}: {launches}"
        assert_off_path(launches, label)
        assert launches["device_hash_codes"] == 0, f"{label}: {launches}"
        t0 = time.perf_counter()
        cpu_df = sgt.match_strings(*args, device="cpu", **kw)
        t_cpu = time.perf_counter() - t0
        pd.testing.assert_frame_equal(card_df, cpu_df)
        assert len(card_df) > 0
        frames4[label] = card_df
        log(f"frames ({label}, {N_FRAME} names, packed-slot hash): card == "
            f"cpu, {len(card_df)} rows; card {t_card:.2f} s, cpu {t_cpu:.2f} s; "
            f"launches {launches}")

    # the other entry points: grouping (self-join + connected components),
    # nearest match (cross-join at max_n_matches=1) and the pairwise dot
    stamp("phase 4: group_similar_strings, match_most_similar, "
          "compute_pairwise_similarities, card vs CPU")
    for label, fn, args, kw in (
        ("group_similar_strings, centroid", sgt.group_similar_strings, (s20,), {}),
        ("group_similar_strings, first", sgt.group_similar_strings, (s20,),
         dict(group_rep="first")),
        (f"match_most_similar vs {N_ORACLE}", sgt.match_most_similar,
         (s20, dupes5), {}),
    ):
        K.reset_launches()
        t0 = time.perf_counter()
        card_out = fn(*args, **kw)
        t_card = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        assert all(launches[k] > 0 for k in DEFAULT_PATH), f"{label}: {launches}"
        assert_off_path(launches, label)
        t0 = time.perf_counter()
        cpu_out = fn(*args, device="cpu", **kw)
        t_cpu = time.perf_counter() - t0
        assert_same(card_out, cpu_out)
        assert len(card_out) == len(args[-1])
        frames4[label] = card_out
        log(f"{label} ({N_FRAME} names): card == cpu, {len(card_out)} rows, "
            f"{card_out.iloc[:, 0].nunique()} distinct first-column values; "
            f"card {t_card:.2f} s, cpu {t_cpu:.2f} s; launches {launches}")
    s5 = s20[:N_ORACLE]
    t0 = time.perf_counter()
    card_sims = sgt.compute_pairwise_similarities(s5, dupes5)
    t_card = time.perf_counter() - t0
    cpu_sims = sgt.compute_pairwise_similarities(s5, dupes5, device="cpu")
    assert_same(card_sims, cpu_sims)
    frames4["pairwise"] = card_sims
    sims = card_sims.to_numpy()
    assert len(sims) == N_ORACLE and np.isfinite(sims).all()
    assert ((sims >= 0) & (sims <= 1 + 1e-12)).all()
    log(f"compute_pairwise_similarities ({N_ORACLE} pairs): card == cpu, "
        f"{int((sims > 0).sum())} non-zero, max {sims.max()}; {t_card:.2f} s")

    # the switch: the torch-op tile body everywhere, the kernel nowhere
    stamp("phase 4: SG_TPU_FUSED=0 and the torch op hashed_projection")
    K.reset_launches()
    os.environ["SG_TPU_FUSED"] = "0"
    try:
        t0 = time.perf_counter()
        off_df = sgt.match_strings(s20)
        t_off = time.perf_counter() - t0
    finally:
        del os.environ["SG_TPU_FUSED"]
    l_off = dict(K.LAUNCHES)
    assert l_off["p1_fused_closed2"] == 0, f"SG_TPU_FUSED=0 launches {l_off}"
    assert l_off["device_hash_codes"] > 0, f"SG_TPU_FUSED=0 launches {l_off}"
    pd.testing.assert_frame_equal(off_df, frames4["default"])
    log(f"SG_TPU_FUSED=0 self-join ({N_FRAME} names): equal to the card frame, "
        f"{len(off_df)} rows, {t_off:.2f} s; launches {l_off}")
    del off_df
    check_hashed_projection(TH, TfidfEncoder(StringGrouperConfig()).fit_transform(
        list(s20)).wait_ready(), dev)

    # the trace: one 20k self-join under utils.profiling.trace
    stamp("phase 4: a traced 20k self-join")
    trace_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    K.reset_launches()
    t0 = time.perf_counter()
    with PR.trace(log_dir=str(trace_dir)):
        traced_df = sgt.match_strings(s20)
    t_traced = time.perf_counter() - t0
    pd.testing.assert_frame_equal(traced_df, frames4["default"])
    trace_file = PR.trace_files(str(trace_dir))[-1]
    events = PR.read_trace(trace_file)
    scan = {k: v for k, v in PR.kernel_durations(events).items() if "scan_kernel" in k}
    assert scan, "the trace holds no kernel event of p1_fused_closed2's library"
    assert sum(len(v) for v in scan.values()) == K.LAUNCHES["p1_fused_closed2"], \
        (scan.keys(), K.LAUNCHES)
    busy = PR.union_us(PR.device_intervals(events)) / 1e6
    log(f"traced self-join ({N_FRAME} names): equal to the card frame, {t_traced:.2f} s "
        f"traced; {trace_file.name} ({trace_file.stat().st_size} bytes, {len(events)} "
        f"events): {sum(len(v) for v in scan.values())} scan_kernel events "
        f"({sum(map(sum, scan.values())) / 1e3:.3f} ms), device busy {busy:.3f} s")
    del traced_df, events
    shutil.rmtree(trace_dir, ignore_errors=True)

    # ---- phase 5: the full self-join, default, chunked and packed ----------
    stamp("phase 5: the 663k self-joins")
    s_full = pd.Series(names_full)
    # the caller's TF32 setting: on through the phase, still on after it
    tf32_before = (torch.backends.cuda.matmul.allow_tf32,
                   torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32_set = (True, torch.get_float32_matmul_precision())

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
        assert_off_path(launches, f"663k {label}")
        assert len(frame) == ROWS_FULL, f"{len(frame)} output rows, expected {ROWS_FULL}"
        assert np.isfinite(frame.similarity.to_numpy()).all()
        return frame, launches, grouper

    out, launches, grouper = self_join("default", DEFAULT_PATH)
    stamp("phase 5: get_groups() and the torch op _cc_labels on the 663k matches")
    t0 = time.perf_counter()
    groups = grouper.get_groups()
    t_groups = time.perf_counter() - t0
    n_groups = groups["group_rep_index"].nunique()
    assert len(groups) == N_FULL and 0 < n_groups < N_FULL
    log(f"get_groups() on the default run's grouper (no refit): {t_groups:.3f} s, "
        f"{n_groups} groups of {N_FULL} names")
    check_cc_labels(CC, grouper._matches_list, N_FULL, dev)
    del grouper, groups
    os.environ["SG_TPU_CHUNKED_P1"] = "1"
    chain_launches = None
    for groups in ("2", "3"):
        os.environ["SG_TPU_CHUNKED_P1_GROUPS"] = groups
        frame, l_chunked, _ = self_join(f"SG_TPU_CHUNKED_P1=1, G={groups}", CHUNKED_PATH)
        pd.testing.assert_frame_equal(frame, out)
        chain_launches = chain_launches or l_chunked["p1_fused_chain"]
        del frame
    del os.environ["SG_TPU_CHUNKED_P1"], os.environ["SG_TPU_CHUNKED_P1_GROUPS"]
    log("chunked self-joins: frames equal to the default run's")

    # the packed-slot path on the payload corpus: no clean-equality
    # collapse, no prefetch; each call of the torch op is counted and its
    # span on the calling stream timed with CUDA events
    stamp("phase 5: the 663k self-join on the packed-slot path")
    hash_calls = []
    real_hash = M._device_hash

    def timed_hash(packed, *a, **k):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        h = real_hash(packed, *a, **k)
        t1.record()
        hash_calls.append((tuple(packed.shape), t0, t1))
        return h

    M._device_hash = timed_hash
    os.environ["SG_TPU_DEVICE_ENCODE"] = "0"
    try:
        frame, l_packed, _ = self_join("SG_TPU_DEVICE_ENCODE=0", PACKED_PATH)
    finally:
        del os.environ["SG_TPU_DEVICE_ENCODE"]
        M._device_hash = real_hash
    assert l_packed["device_hash_codes"] == 0, f"packed 663k launches {l_packed}"
    assert hash_calls, "the packed 663k run built no packed-slot hash"
    pd.testing.assert_frame_equal(frame, out)
    del frame
    torch.cuda.synchronize()
    spans = [(shape, t0.elapsed_time(t1)) for shape, t0, t1 in hash_calls]
    log(f"packed self-join: frame equal to the default run's; _device_hash "
        f"calls {len(spans)} (packed shape, ms): {spans}")

    # the API function as a user calls it; its grouper is caught on its way
    # through get_groups() for the phase timings and the matches list
    stamp(f"phase 5: match_most_similar, {N_FULL} names against {N_NEAREST}")
    dupes_n = pd.Series(synthetic_company_names(N_NEAREST, seed=7))
    seen = []
    real_get_groups = sgt.StringGrouper.get_groups

    def spy_get_groups(self, *a, **k):
        seen.append(self)
        return real_get_groups(self, *a, **k)

    sgt.StringGrouper.get_groups = spy_get_groups
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        nearest = sgt.match_most_similar(s_full, dupes_n)
    finally:
        sgt.StringGrouper.get_groups = real_get_groups
    wall = time.perf_counter() - t0
    l_nearest = dict(K.LAUNCHES)
    assert len(seen) == 1
    secs = seen[0].timings.seconds
    assert all(l_nearest[k] > 0 for k in DEFAULT_PATH), f"nearest launches {l_nearest}"
    assert len(nearest) == N_NEAREST, f"{len(nearest)} rows, expected {N_NEAREST}"
    assert nearest.index.equals(dupes_n.index)
    n_verb, n_one, n_rep = check_verbatim_duplicates(
        s_full, dupes_n, seen[0]._matches_list)
    log(f"match_most_similar ({N_FULL} x {N_NEAREST}): wall {wall:.3f} s "
        f"(fit {sum(secs[k] for k in ('encode', 'match', 'assemble')):.3f} s), "
        f"{len(nearest)} rows, {int(nearest.iloc[:, 0].notna().sum())} matched; "
        f"{n_verb} duplicates present verbatim in the master: {n_one} matched at "
        f"similarity >= 1 - 1e-12, {n_rep} repeats whose master copies each kept "
        f"another duplicate at that similarity; launches {l_nearest}")
    log("timings: " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v) for k, v in secs.items()}))
    del seen, nearest
    assert_off_path(l_nearest, "663k match_most_similar")
    tf32_after = (torch.backends.cuda.matmul.allow_tf32,
                  torch.get_float32_matmul_precision())
    assert tf32_after == tf32_set, f"TF32 setting {tf32_set} became {tf32_after}"
    log(f"TF32: set to {tf32_set} (allow_tf32, precision) before the 663k calls, "
        f"{tf32_after} after them: unchanged")
    torch.set_float32_matmul_precision(tf32_before[1])

    # ---- phase 6: the mesh tier -------------------------------------------
    stamp("phase 6: the mesh tier at 20,000 names")

    def virtual(dp, mp):
        """A (dp, mp) mesh whose slots all name the one card."""
        return Mesh([[dev] * mp for _ in range(dp)])

    def on_mesh(label, fn, args, kw, want, path):
        K.reset_launches()
        t0 = time.perf_counter()
        got = fn(*args, **kw)
        t_mesh = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        assert all(launches[k] > 0 for k in path), f"{label}: {launches}"
        assert_off_path(launches, label)
        assert_same(got, want)
        log(f"{label}: equal to phase 4's card frame, {len(got)} rows; "
            f"{t_mesh:.2f} s; launches {launches}")
        return launches

    for label, mesh in (("make_mesh()", make_mesh()), ("(1, 2)", virtual(1, 2)),
                        ("(2, 2)", virtual(2, 2)), ("(1, 4)", virtual(1, 4)),
                        ("(4, 1)", virtual(4, 1))):
        on_mesh(f"match_strings, mesh {label} = {mesh.shape}", sgt.match_strings,
                (s20,), dict(mesh=mesh), frames4["default"], DEFAULT_PATH)
    on_mesh("group_similar_strings, mesh (2, 2)", sgt.group_similar_strings,
            (s20,), dict(mesh=virtual(2, 2)),
            frames4["group_similar_strings, centroid"], DEFAULT_PATH)
    l_f32 = on_mesh("float32 self-join, mesh (2, 2)", sgt.match_strings, (s20,),
                    dict(mesh=virtual(2, 2), tfidf_matrix_dtype=np.float32),
                    frames4["float32 self-join"], PACKED_PATH)
    assert l_f32["device_hash_codes"] == 0, f"float32 mesh launches {l_f32}"
    on_mesh(f"compute_pairwise_similarities ({N_ORACLE} pairs), mesh (2, 4)",
            sgt.compute_pairwise_similarities, (s5, dupes5),
            dict(mesh=virtual(2, 4)), frames4["pairwise"], ())

    stamp(f"phase 6: the {N_FULL}-name self-join on a (2, 2) mesh")
    dp, mp = 2, 2
    # 568,804 unique cleaned rows in super-chunks of 2 x 4,096 rows: 8
    # segments, each one launch per shard.
    want_p1 = 8 * dp * mp
    restore, coll_report = spy_mesh_collectives(D)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        grouper = sgt.StringGrouper(s_full, mesh=virtual(dp, mp)).fit()
        frame = grouper.get_matches()
    finally:
        restore()
    wall = time.perf_counter() - t0
    l_mesh = dict(K.LAUNCHES)
    secs = grouper.timings.seconds
    log(f"full self-join (mesh (2, 2) on one card): n={N_FULL} wall {wall:.3f} s, "
        f"encode {secs['encode']:.3f} s, match.p1_wait {secs['match.p1_wait']:.3f} s, match.esc_wait "
        f"{secs['match.esc_wait']:.3f} s, {len(frame)} rows; launches {l_mesh} "
        f"(p1_fused_closed2 expected {want_p1}: one per (segment, shard))")
    log("timings: " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v) for k, v in secs.items()}))
    assert all(l_mesh[k] > 0 for k in DEFAULT_PATH), f"mesh 663k launches {l_mesh}"
    assert l_mesh["p1_fused_closed2"] == want_p1, f"mesh 663k launches {l_mesh}"
    assert_off_path(l_mesh, "663k mesh")
    assert len(frame) == ROWS_FULL, f"{len(frame)} output rows, expected {ROWS_FULL}"
    pd.testing.assert_frame_equal(frame, out)
    log("mesh self-join: frame equal to the default run's")
    log("mesh collectives (CUDA events): " + json.dumps(coll_report()))
    del grouper, frame

    # ---- phase 7: two torch.distributed ranks on the one card --------------
    stamp(f"phase 7: {WORLD} ranks on one card (multihost=)")
    p7 = Path(__file__).resolve().parent / "build" / "chip_smoke_phase7"
    shutil.rmtree(p7, ignore_errors=True)
    p7.mkdir(parents=True)
    ids20 = pd.Series([f"m{i}" for i in range(N_FRAME)])
    ids5 = pd.Series([f"d{i}" for i in range(N_ORACLE)])
    t0 = time.perf_counter()
    want_cross = sgt.match_strings(s20, dupes5, ids20, ids5)
    s_sh = pd.Series(synthetic_company_names(N_SHARDED))
    want_sh = sgt.match_strings(s_sh)
    log(f"single-process card frames for phase 7: cross-join with ids "
        f"{len(want_cross)} rows, {N_SHARDED} names {len(want_sh)} rows "
        f"({time.perf_counter() - t0:.2f} s)")
    wants = {"self": frames4["default"], "cross_ids": want_cross,
             "groups": frames4["group_similar_strings, centroid"],
             "nearest": frames4[f"match_most_similar vs {N_ORACLE}"],
             "f32": frames4["float32 self-join"], "full": out,
             "sharded_100k": want_sh}
    t0 = time.perf_counter()
    for k, v in wants.items():
        v.to_pickle(p7 / f"want_{k}.pkl")
    log(f"frames pickled for the ranks in {time.perf_counter() - t0:.2f} s")
    del wants, want_cross, want_sh, out
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = run_ranks(p7)
    log(f"{WORLD} ranks: {time.perf_counter() - t0:.1f} s wall, both passed")
    for rec in recs:
        for label, l_rank in rec["launches"].items():
            assert l_rank["p1_fused_closed2"] > 0, (rec["rank"], label, l_rank)
            assert_off_path(l_rank, f"rank {rec['rank']} {label}")
        full = rec["launches"][f"self-join {N_FULL} replicated"]
        assert full["device_hash_codes"] > 0, (rec["rank"], full)
        sc = rec["scan"]
        log(f"kernel row (_make_phase1_scan: _local_block + _exchange_rows), rank "
            f"{rec['rank']}: " + json.dumps(dict(
                first_scan_ms=sc["first_scan_ms"], bound_ms=sc["first_scan_bound_ms"],
                bound_by="operations", library_ms=sc["first_scan_library_ms"],
                launches_p1_fused_closed2=rec["launches"][
                    f"self-join {N_SHARDED} sharded"]["p1_fused_closed2"],
                all_scans_ms=sc["all_scans_ms"], all_scans_bound_ms=sc["all_scans_bound_ms"],
                exchange_ms=sc["exchange_ms"], exchange_bound_ms=sc["exchange_bound_ms"],
                exchange_bound_by="bytes (card to host, PCIe Gen5 x16)",
                exchange_bytes=sc["exchange_bytes"])))
        sl = rec["scan_slots"]
        log(f"kernel row ({SLOTS} slots per rank, {N_FULL} sharded), rank {rec['rank']}: "
            + json.dumps(dict(
                first_pass_slots=sl["first_pass_slots"], bound_by="operations",
                library_ms=sl["first_scan_library_ms"],
                launches_p1_fused_closed2=rec["launches"][
                    f"self-join {N_FULL} sharded, {SLOTS} slots"]["p1_fused_closed2"],
                all_scans_ms=sl["all_scans_ms"], all_scans_bound_ms=sl["all_scans_bound_ms"],
                exchanges=sl["exchanges"], exchange_ms=sl["exchange_ms"],
                exchange_bound_ms=sl["exchange_bound_ms"],
                exchange_bytes=sl["exchange_bytes"])))
    # rank 0's launches on the sharded tier over its slots (663k)
    l_slots = recs[0]["launches"][f"self-join {N_FULL} sharded, {SLOTS} slots"]
    shutil.rmtree(p7, ignore_errors=True)
    stamp("all phases passed")

    src = "string_grouper_tpu_torch/csrc/{}.cu"
    pk = "string_grouper_tpu/ops/pallas_kernels.py:{}"
    kernels = [
        dict(name="p1_fused_closed2", route="cuda",
             source=src.format("p1_fused_closed2"), replaces=pk.format(117),
             launches=launches["p1_fused_closed2"] + l_mesh["p1_fused_closed2"]
             + l_slots["p1_fused_closed2"],
             **res_p1),
        dict(name="p1_fused_chain", route="cuda",
             source=src.format("p1_fused_chain"), replaces=pk.format(275),
             launches=chain_launches, **res_chain),
        dict(name="p1_tri_fused", route="cuda",
             source=src.format("p1_tri_fused"), replaces=pk.format(626),
             launches=tri_launches, **res_tri),
        dict(name="device_hash_codes", route="cuda",
             source=src.format("device_hash_codes"),
             replaces="string_grouper_tpu/ops/matcher.py:398",
             launches=launches["device_hash_codes"] + l_mesh["device_hash_codes"]
             + l_slots["device_hash_codes"],
             **res_hash),
        dict(name="p1_mm_floor", route="cuda", source=src.format("p1_mm_floor"),
             replaces="benchmarks/ab_p1_epilogue.py:66", **res_floor),
        dict(name="p1_closed2_variant", route="cuda",
             source=src.format("p1_closed2_variant"),
             replaces="benchmarks/ab_p1_epilogue.py:161", **res_variant),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
