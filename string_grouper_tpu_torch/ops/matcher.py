"""Top-n cosine matcher on the card: the PyTorch/CUDA counterpart of
``string_grouper_tpu.ops.matcher`` (same pipeline, same names).

  duplicate collapse (host): strings with equal CLEANED content share one
      matcher row (the payload's per-row hashes, byte-verified); results
      expand back exactly (``_expand_dedup``; ``match_with_collapse``).
  upload + device hash: the unique rows ship as 6-bit-packed cleaned
      character codes in two width tiers, and the hashed upper-bound
      projection (n, hash_dim) bf16 is built on the card by the CUDA kernel
      ``device_hash_codes`` (ops/kernels.py), on a worker thread at encode
      completion (``prefetch_corpus_hash``).  A corpus without the byte
      payload (float32, a custom regex, n-grams > 3, rows over 4096
      characters, non-ASCII kept as is), or any corpus under
      ``SG_TPU_DEVICE_ENCODE=0``, ships its ELL rows as packed (bucket,
      value) slots instead, expanded on the device by the torch op
      ``_device_hash``.
  phase 1 (device): hashed upper-bound scores ``A_hash @ B_hash.T``; TF-IDF
      values are non-negative, so the hashed scores bound the exact cosine
      from above and the threshold drops no true match.  On CUDA the default
      (k_tile=2, thresholded) pass is the fused kernel ``p1_fused_closed2``
      (matmul + threshold + closed-form top-2 + running top-C), and
      escalation's re-matches at k_tile 4-32 run its top-kt form
      ``p1_fused_topk`` (``use_fused_topk``); the torch-op tile body
      ``_ub_topk_scan`` serves the CPU, wider escalation widths,
      thresholdless runs, and every run under ``SG_TPU_FUSED=0``
      (``fused_enabled``).
  download: candidate column ids only (ragged-prefix-compacted, 20-bit
      packed, one transfer per segment, on a copy stream that waits on the
      segment's event) plus per-row metadata with an upper bound on every
      DROPPED candidate.
  phase 2 (host, native C++/OpenMP): exact rescoring of the shipped
      candidates, threshold + per-row top-n with deterministic ties, and the
      self-join fix-ups.

Exactness: the adaptive driver re-matches every row whose drop bound could
still qualify and beat the row's exact top-n cut, so no qualifying pair is
dropped; reported similarities are exact in the configured matrix dtype.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..corpus.tfidf import EllMatrix
from ..utils.profiling import span
from ..validation import resolve_device
from .kernels import (
    _KNUTH,
    device_hash_codes,
    ieee_f32_matmul,
    p1_fused_closed2,
    p1_fused_supported,
    p1_fused_topk,
    p1_fused_topk_supported,
)
from .rescore import rescore_pairs_fp64

logger = logging.getLogger("string_grouper_tpu_torch")

#: the stats of the most recent matcher fit in this process -- a mirror of
#: ``MatchPairs.stats`` (rebound per fit; under concurrent fits read
#: ``pairs.stats``), which the engine reads when a result carries none.
LAST_STATS: dict = {}


def _publish_stats(stats: dict) -> None:
    global LAST_STATS
    LAST_STATS = stats

# Relative slack applied to the phase-1 upper-bound threshold to absorb
# reduced-precision arithmetic (bf16 matmul inputs): bf16 rounding can shrink
# the bound by <= ~0.8%, which this slack covers.
_UB_REL_SLACK = 0.02
_UB_ABS_SLACK = 1e-4
# Upper-adjustment factor for shipped upper bounds when used to bound
# dropped candidates: true_ub <= computed_ub * _UB_ADJ + _UB_ABS_SLACK.
_UB_ADJ = 1.01

def escalation_unsafe(
    bound: np.ndarray,
    kept_q: np.ndarray,
    row_cut: np.ndarray,
    qual_low: float,
    max_n_eff: int,
) -> np.ndarray:
    """THE safety predicate of the adaptive driver: True for rows whose device-reported drop bound
    could still qualify AND beat the row's exact top-n cut.

    Dropped candidates are bounded by the device-reported drop bound.
    Cosine of L2-normalized rows never exceeds 1, so the adjusted bound
    clamps at 1.  The cut comparison is >= (not >): a dropped candidate
    tied with the cut usually IS a structural clone of a kept one, but a
    bf16-shrunk bound near the slack limit could make a genuinely tied
    reference match sit exactly at the cut, so the few extra escalated
    rows are the safe trade.  The exact fp64 rescore can round a true-1.0
    similarity slightly ABOVE 1 (e.g. 1.0000000000000002 for identical
    strings), so the cut clamps like the bound -- otherwise a row whose
    top-n cut rounds above 1 is wrongly deemed safe while its dropped
    candidates carry the same above-1 exact score."""
    adj = np.minimum(bound * _UB_ADJ + _UB_ABS_SLACK, 1.0)
    cut = np.minimum(row_cut, 1.0)
    return (
        (bound > -np.inf)
        & (adj >= qual_low)
        & ((kept_q < max_n_eff) | (adj >= cut))
    )

# Download budget of the ragged-prefix compaction, in candidate slots per
# left row (averaged over a segment).  Segments whose total valid count
# exceeds it fall back to the full-width ship.
_SHIP_BUDGET_ROWS = 16
# Minimum escalated-ship size (slots) before the escalation download is
# compacted too; tiny re-matches are cheaper shipped whole.
_ROWS_COMPACT_MIN = 1 << 20
# Minimum rows for a standalone escalation kt-bucket: the re-match pads to
# whole device chunks, so a smaller bucket merges into the next wider one.
_ESC_MIN_JOB_ROWS = 4096
_NEG = float("-inf")


@dataclass
class MatchPairs:
    """Long-format match list (positional indices), reference
    ``_matches_list`` equivalent (string_grouper.py:755-763).

    ``stats``, when attached by the matcher entry points, is THIS fit's
    wall-time/volume breakdown."""

    rows: np.ndarray  # int64
    cols: np.ndarray  # int64
    sims: np.ndarray  # float64
    true_max_n_matches: int
    stats: Optional[dict] = None


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _pad_width(ell: EllMatrix, width: int) -> EllMatrix:
    if ell.width == width:
        return ell
    ell.wait_ready()  # np.pad copies: the deferred fill must be complete
    pad = width - ell.width
    ids = np.pad(ell.ids, ((0, 0), (0, pad)), constant_values=-1)
    vals = np.pad(ell.vals64, ((0, 0), (0, pad)))
    return EllMatrix(ids=ids, vals64=vals, n_terms=ell.n_terms,
                     device_src=ell.device_src)


def effective_threshold(min_similarity: float) -> np.float32:
    """Device-side UB threshold with reduced-precision slack (-inf when no
    threshold).  A min_similarity so small that the slack pushes the
    device threshold to <= 0 is ALSO -inf: a non-positive device threshold
    qualifies every column anyway, and the thresholdless path (full-width
    extraction, no drop bounds) handles that shape gracefully where the
    kt=2 path would escalate the whole corpus at full width."""
    if min_similarity > 0:
        thr = min_similarity * (1 - _UB_REL_SLACK) - _UB_ABS_SLACK
        if thr > 0:
            return np.float32(thr)
    return np.float32(-np.inf)


def initial_k_tile(min_similarity: float, tile: int, c0: int) -> int:
    """Per-tile extraction width.  Small and constant: rows whose tiles
    overflow it are detected via the device drop bound and re-matched
    individually (adaptive_topn), so the global passes stay cheap.

    2 selects the closed-form reduction-only extraction (the fused kernel
    and the tile body's kt=2 branch: no iterated argmax/mask passes); rows
    with more qualified columns in a tile escalate.  The policy is the JAX
    package's, so both packages escalate the same rows."""
    if effective_threshold(min_similarity) <= 0:  # thresholdless shape
        return min(tile, c0)
    return 2


def initial_cand_c(min_similarity: float, max_n: int, n_right: int, cap: int) -> int:
    if effective_threshold(min_similarity) > 0:
        return min(cap, max(64, _next_pow2(min(max_n, n_right) + 8)))
    return cap


def _p1_geometry(n_left: int, n_right: int, left_chunk: int, right_tile: int):
    """Phase-1 shapes: ``(tile, n_right_p, chunk, n_left_p, n_seg, cpg,
    n_chunks, seg_rows)``.  Segments let host-side exact scoring of one
    segment overlap the device matching of the next."""
    tile = min(right_tile, _next_pow2(max(n_right, 8)))
    n_right_p = -(-n_right // tile) * tile
    chunk = min(left_chunk, _next_pow2(max(n_left, 8)))
    n_left_p = -(-n_left // chunk) * chunk
    n_chunks0 = n_left_p // chunk
    n_seg = min(8, max(1, n_chunks0 // 8))
    cpg = -(-n_chunks0 // n_seg)  # chunks per segment
    n_chunks = -(-n_chunks0 // cpg) * cpg
    n_seg = n_chunks // cpg
    return (tile, n_right_p, chunk, n_left_p, n_seg, cpg, n_chunks,
            cpg * chunk)


def fused_enabled() -> bool:
    """Whether the fused phase-1 kernels run on the card, read per call:
    ``p1_fused_closed2`` for the default (k_tile = 2, thresholded)
    configuration, ``p1_fused_topk`` for escalation's re-matches at k_tile
    4-32.  ``SG_TPU_FUSED=0`` forces the torch-op tile body everywhere (the
    JAX package's knob): the single-device scan and its escalation, the
    mesh tier and the multi-process tiers' scan.  The two give the same pairs;
    the kernels are the faster."""
    return os.environ.get("SG_TPU_FUSED", "1") != "0"


def _on_card(device: torch.device) -> bool:
    """The fused kernels run on the card only (where the JAX package tests
    ``on_tpu``); the CPU takes the torch-op body."""
    return device.type == "cuda"


def use_fused(device: torch.device, k_tile: int, thr: float, m: int, n: int,
              d: int, tile: int, cand_c: int) -> bool:
    """Whether a phase-1 pass of ``m`` left rows against ``n`` right rows
    on ``device`` runs the kernel ``p1_fused_closed2``: on the card, switch
    on, the default ``k_tile = 2`` with a threshold, and a shape the kernel
    takes.  The one rule of every site (the single-device scan and its
    escalation, the mesh tier's shards, the multi-process scan's slots);
    the torch-op body runs otherwise."""
    return (
        _on_card(device)
        and fused_enabled()
        and k_tile == 2
        and thr > 0
        and p1_fused_supported(m, n, d, tile, cand_c)
    )


def use_fused_topk(device: torch.device, k_tile: int, thr: float, m: int,
                   n: int, d: int, tile: int, cand_c: int) -> bool:
    """Whether an escalation re-match of ``m`` left rows (padded) against
    ``n`` right rows on ``device`` runs the kernel ``p1_fused_topk``: on
    the card, switch on, ``k_tile`` 4-32 with a threshold, and a shape the
    kernel takes.  The rule of the single-device escalation (``run_rows``);
    k_tile = 2 is ``use_fused``'s, and the torch-op body runs otherwise."""
    return (
        _on_card(device)
        and fused_enabled()
        and 4 <= k_tile <= 32
        and thr > 0
        and p1_fused_topk_supported(m, n, d, tile, cand_c, k_tile)
    )


def _clean_codes(src):
    """A payload's clean-equality grouping, computed once (cached on it for
    the collapse layer): ``(groups, native)``, where ``groups`` is
    ``_group_positions``' tuple ``(codes, first, perm, starts, counts)``
    (None without row hashes) and ``native`` says whether the native pass
    made it.  With the native library loaded one pass
    (``clean_group_positions``) emits the canonical form directly; without
    it the numpy chain ``_group_positions(_clean_refined_codes(src))``
    gives the same bits."""
    cached = getattr(src, "_clean_codes", None)
    if cached is None:
        from ..native import get_scorer_lib

        lib = get_scorer_lib()
        if src.row_hash is None:
            cached = (None, False)
        elif lib is not None:
            cached = (_native_clean_groups(lib, src), True)
        else:
            cached = (_group_positions(_clean_refined_codes(src)), False)
        object.__setattr__(src, "_clean_codes", cached)
    return cached


def _native_clean_groups(lib, src):
    """``clean_group_positions`` of a payload: ``_group_positions``' tuple,
    bit for bit that of the numpy chain."""
    h = np.ascontiguousarray(src.row_hash, dtype=np.uint64)
    coff = np.ascontiguousarray(src.coff, dtype=np.int64)
    flat = np.ascontiguousarray(src.flat_codes, dtype=np.uint8)
    n = len(h)
    if len(coff) != n + 1 or (n and coff[-1] > len(flat)):
        raise ValueError(
            f"payload of {n} rows has {len(coff)} offsets over {len(flat)} bytes"
        )
    codes = np.empty(n, dtype=np.int64)
    first = np.empty(n, dtype=np.int32)
    perm = np.empty(n, dtype=np.int64)
    starts = np.empty(n, dtype=np.int64)
    counts = np.empty(n, dtype=np.int64)
    u = lib.clean_group_positions(
        flat, coff, h, n, codes, first, perm, starts, counts
    )
    return codes, first[:u], perm, starts[:u], counts[:u]


# ------------------------------------------------------- upload + device hash
def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device`` (uint32 travels as its int32 bit
    pattern; torch has no general uint32 arithmetic)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def pack_hash_inputs(ell: EllMatrix, n_pad: int, dim: int) -> np.ndarray:
    """Quantize an ELL matrix into wire-minimal packed int32 slots:
    ``(bucket << 16) | qval``, (n_pad, ell.width), for ``_to_device``.

    bucket = Knuth multiplicative hash of the term id into [0, dim)
    (requires dim <= 2^15); qval = ceil(value * 65535) in uint16 -- an
    UPWARD quantization, preserving the upper-bound property while keeping
    quantization inflation of the bound below ~2e-4.  Padding slots and
    padding rows carry qval 0."""
    if dim > (1 << 15):
        raise ValueError("hash_dim must be <= 32768")
    ell.wait_ready()  # the engine's deferred value fill may still be running
    packed = _pack_rows_ordered(
        ell.ids, ell.vals64,
        np.arange(ell.n_rows, dtype=np.int32), ell.width, dim,
    )
    if n_pad > ell.n_rows:
        packed = np.pad(packed, ((0, n_pad - ell.n_rows), (0, 0)))
    return packed


def _pack_rows(ids: np.ndarray, vals64: np.ndarray, dim: int) -> np.ndarray:
    u = (ids.astype(np.int64) * _KNUTH) % (1 << 32)
    b = (u >> (32 - int(dim).bit_length() + 1)).astype(np.int64)
    q = np.ceil(vals64 * 65535.0).clip(0, 65535).astype(np.int64)
    return np.where(ids >= 0, (b << 16) | q, 0).astype(np.int32)


def _pack_rows_ordered(
    ids: np.ndarray,
    vals64: np.ndarray,
    order: np.ndarray,
    out_width: int,
    dim: int,
) -> np.ndarray:
    """``_pack_rows(ids[order][:, :out_width], ...)`` without materializing
    the reordered ELL copies: the native kernel walks ``order`` directly
    in one pass; numpy (several corpus-sized int64 temporaries) when the
    native library is not built."""
    from ..native import get_scorer_lib

    order = np.ascontiguousarray(order, dtype=np.int32)
    lib = get_scorer_lib()
    if lib is not None:
        out = np.empty((len(order), out_width), dtype=np.int32)
        lib.pack_hash_rows(
            np.ascontiguousarray(ids),
            np.ascontiguousarray(vals64),
            ids.shape[1],
            order,
            len(order),
            out_width,
            int(dim).bit_length() - 1,
            out,
        )
        return out
    return _pack_rows(ids[order][:, :out_width], vals64[order][:, :out_width], dim)


def _device_hash(packed: torch.Tensor, dim: int,
                 row_tile: int = 4096) -> torch.Tensor:
    """Expand packed ``(bucket << 16) | qval16`` int32 slots (n, W) into the
    dense (n, dim) bf16 hashed projection, value qval / 65535, on the
    tensor's device (the torch-op form of the JAX package's XLA
    ``_device_hash``).

    Row tile by row tile, one ``scatter_add_`` per slot column into an f32
    buffer: no two adds of one call land on the same element, so every
    bucket sums in slot order on the CPU and on the card alike (one
    ``index_add_`` over all slots would leave the order to float atomics).
    Padding slots (qval 0) add 0."""
    n, w = packed.shape
    dev = packed.device
    out = torch.empty((n, dim), dtype=torch.bfloat16, device=dev)
    # A multiply by the f32 reciprocal, as JAX computes it (a division
    # rounds differently).
    scale = torch.tensor(1.0 / 65535.0, dtype=torch.float32, device=dev)
    for lo in range(0, n, row_tile):
        x = packed[lo:lo + row_tile]
        bucket = ((x >> 16) & 0xFFFF).long()  # int32 >> is arithmetic
        val = (x & 0xFFFF).float() * scale
        h = torch.zeros((x.shape[0], dim), dtype=torch.float32, device=dev)
        for j in range(w):
            h.scatter_add_(1, bucket[:, j:j + 1], val[:, j:j + 1])
        out[lo:lo + row_tile] = h
    return out


def _pack_codes6(codes: np.ndarray) -> np.ndarray:
    """Pack (n, W) uint8 codes < 64 into 6-bit fields, 5 per uint32 word:
    the payload upload is the largest host->device transfer, so 8 bits/char
    -> 6.4 bits/char.  numpy
    fallback of the fused native gather+pack (``_fill_code_rows6``)."""
    n, w = codes.shape
    wp = -(-w // 5) * 5
    if wp > w:
        codes = np.pad(codes, ((0, 0), (0, wp - w)))
    c = codes.astype(np.uint32).reshape(n, wp // 5, 5)
    out = (
        c[:, :, 0]
        | (c[:, :, 1] << 6)
        | (c[:, :, 2] << 12)
        | (c[:, :, 3] << 18)
        | (c[:, :, 4] << 24)
    )
    return out


def _fill_code_rows6(src, order: np.ndarray, width: int) -> np.ndarray:
    """Gather + 6-bit pack in ONE native pass (no dense corpus-sized uint8
    intermediate)."""
    from ..native import get_scorer_lib

    lib = get_scorer_lib()
    if lib is not None and hasattr(lib, "fill_code_rows6"):
        order = np.ascontiguousarray(order, dtype=np.int32)
        out = np.empty((len(order), -(-width // 5)), dtype=np.uint32)
        lib.fill_code_rows6(
            np.ascontiguousarray(src.flat_codes),
            np.ascontiguousarray(src.coff),
            order, len(order), width, out,
        )
        return out
    return _pack_codes6(_fill_code_rows(src, order, width))


def _fill_code_rows(src, order: np.ndarray, width: int) -> np.ndarray:
    """Dense (len(order), width) uint8 code rows from the ragged payload,
    0-padded (native one-pass gather; numpy fallback for tests)."""
    from ..native import get_scorer_lib

    order = np.ascontiguousarray(order, dtype=np.int32)
    out = np.empty((len(order), width), dtype=np.uint8)
    lib = get_scorer_lib()
    if lib is not None and hasattr(lib, "fill_code_rows"):
        lib.fill_code_rows(
            np.ascontiguousarray(src.flat_codes),
            np.ascontiguousarray(src.coff),
            order, len(order), width, out,
        )
        return out
    out[:] = 0
    lens = np.minimum(np.diff(src.coff)[order], width).astype(np.int64)
    starts = src.coff[order]
    idx = starts[:, None] + np.arange(width)[None, :]
    valid = np.arange(width)[None, :] < lens[:, None]
    out[valid] = src.flat_codes[np.minimum(idx, len(src.flat_codes) - 1)[valid]]
    return out


def _code_width_tiers(lens: np.ndarray, ngram: int, quantum: int):
    """Choose the (narrow_w, full_w) ship widths that minimize uploaded
    words for this corpus's row-length distribution.

    Widths are multiples of ``quantum`` (40 = 5 codes per word x 8 on the
    6-bit path), the JAX package's tiers, so both packages ship the same
    rows at the same widths.  A fixed narrow width with a power-of-two full
    width would ship long-tailed corpora at up to ~2.7x their needed width.

    Returns ``(narrow_w, full_w)`` with narrow_w == full_w when a single
    tier is (near-)optimal."""
    q = quantum
    full_w = max(ngram, -(-int(lens.max(initial=1)) // q) * q)
    n = len(lens)
    if n == 0 or full_w <= q:
        return full_w, full_w
    # Candidate narrow widths: every multiple of q below full_w; cost =
    # words(narrow tier) + words(wide tier).  One pass over a histogram.
    hist = np.bincount(
        np.minimum((lens + q - 1) // q, full_w // q), minlength=full_w // q + 1
    )
    cum = np.cumsum(hist)  # rows with width-need <= k*q
    ks = np.arange(1, full_w // q + 1)
    total = ks * q * cum[ks] + full_w * (n - cum[ks])
    best = int(np.argmin(total))
    if total[best] > 0.85 * n * full_w:  # <15% saving: one tier is simpler
        return full_w, full_w
    return int(ks[best] * q), full_w


def _tiered_rows(narrow: np.ndarray, build_tier,
                 device: torch.device) -> torch.Tensor:
    """Two-tier upload shape of both upload paths (byte-payload codes and
    packed slots): order rows narrow-first, build each tier's device rows
    with ``build_tier(order_slice, wide)``, concatenate, and gather back to
    the original row order on the device."""
    n = len(narrow)
    order = np.argsort(~narrow, kind="stable").astype(np.int64)
    k = int(narrow.sum())
    parts = [build_tier(order[:k], False)]
    if k < n:
        parts.append(build_tier(order[k:], True))
    h_perm = torch.cat(parts) if len(parts) > 1 else parts[0]
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n, dtype=np.int64)
    return h_perm[_to_device(inv, device)]


def _build_hash_from_codes(src, n_pad: int, dim: int, device: torch.device,
                           min_rows: int = 10000) -> torch.Tensor:
    """(n_pad, dim) bf16 projection from a DeviceEncodeSrc payload: the
    corpus ships as ~0.8 byte per character (plus f32 norms and the small
    key->term table) and the card rebuilds the projection with the
    ``device_hash_codes`` kernel.  Rows ship in two width tiers fitted to
    the corpus length distribution (``_code_width_tiers``)."""
    lens = src.row_lengths()
    n = len(lens)
    table = _to_device(src.table_id, device)
    idf = _to_device(src.idf32, device)
    args = dict(dim=dim, base=src.base, ngram=src.ngram)
    # 6-bit pack when every code fits (base <= 64: codes are 1..base-1,
    # 0 pad); larger alphabets ship raw uint8.
    pack6 = src.base <= 64

    def ship(order, w):
        if pack6:
            return _to_device(_fill_code_rows6(src, order, w), device), w
        return _to_device(_fill_code_rows(src, order, w), device), None

    narrow_w, full_w = _code_width_tiers(
        lens, src.ngram, 40 if pack6 else 8
    )
    narrow = lens <= narrow_w
    if full_w <= narrow_w or n < min_rows:
        codes, pw = ship(np.arange(n, dtype=np.int32), full_w)
        h = device_hash_codes(
            codes, _to_device(src.inv_norm, device), table, idf, width=pw,
            **args,
        )
    else:
        def build_tier(order_slice, wide):
            codes_t, pw = ship(
                order_slice.astype(np.int32), full_w if wide else narrow_w
            )
            return device_hash_codes(
                codes_t, _to_device(src.inv_norm[order_slice], device),
                table, idf, width=pw, **args,
            )

        h = _tiered_rows(narrow, build_tier, device)
    if n_pad > n:
        h = torch.cat([h, h.new_zeros((n_pad - n, dim))])
    return h


def device_encode_enabled() -> bool:
    """Byte-level device encode (DeviceEncodeSrc) toggle, read per call:
    on unless ``SG_TPU_DEVICE_ENCODE=0``, which sends every corpus down the
    packed-slot path (the JAX package's knob)."""
    return os.environ.get("SG_TPU_DEVICE_ENCODE", "1") != "0"


_PREFETCH_POOL = ThreadPoolExecutor(
    max_workers=1, thread_name_prefix="sg-hash-prefetch"
)

#: Serializes the native expand_dedup phase1->phase2 window (process-global
#: scratch; ctypes releases the GIL during the calls).
_EXPAND_LOCK = threading.Lock()


def prefetch_corpus_hash(ell: EllMatrix, hash_dim: int,
                         device="cuda") -> None:
    """Start the FULL-corpus payload upload + device hash build on a worker
    thread at encode completion, so it overlaps the host collapse/setup
    stages.  The worker enqueues on the caller's current stream and
    records an event; ``_prefetched_hash`` makes the consumer's stream wait
    on that event, so no consumer reads a half-built matrix.

    Per-row hashing is row-local given the corpus-global (table, idf), so
    a device gather of unique rows from the full matrix equals shipping a
    host-side subset.  No-op without a device payload or under
    ``SG_TPU_DEVICE_ENCODE=0``."""
    src = getattr(ell, "device_src", None)
    if src is None or not device_encode_enabled():
        return
    device = resolve_device(device)
    key = (hash_dim, device)
    pf = getattr(src, "_hash_prefetch", None)
    if pf is not None and pf[0] == key:
        return
    n = len(src.inv_norm)
    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None

    def run():
        if stream is None:
            return _build_hash_from_codes(src, n, hash_dim, device), None
        with torch.cuda.stream(stream):
            t = _build_hash_from_codes(src, n, hash_dim, device)
            done = torch.cuda.Event()
            done.record(stream)
        return t, done

    # DeviceEncodeSrc is a frozen dataclass; the cache is bookkeeping, not
    # payload state.
    object.__setattr__(src, "_hash_prefetch", (key, _PREFETCH_POOL.submit(run)))


def _prefetched_hash(src, dim: int,
                     device: torch.device) -> Optional[torch.Tensor]:
    """The prefetched (n, dim) full-corpus hash matrix, ready for the
    consumer's current stream, or None when none was started for this
    (dim, device).  A failed build raises here."""
    pf = getattr(src, "_hash_prefetch", None)
    if pf is None or pf[0] != (dim, device):
        return None
    t, done = pf[1].result()
    if done is not None:
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        # The consumer's stream uses the tensor from here on: the caching
        # allocator must not hand its memory to other work before that
        # stream is done with it, whichever stream the build ran on.
        t.record_stream(consumer)
    return t


def build_hash_matrix(ell: EllMatrix, n_pad: int, dim: int,
                      device: torch.device, narrow_w: int = 32,
                      min_rows: int = 10000) -> torch.Tensor:
    """(n_pad, dim) bf16 hashed projection of an encoded corpus on
    ``device``.

    With a byte-level payload (DeviceEncodeSrc) the card rebuilds it from
    cleaned character codes (``_build_hash_from_codes``).  Otherwise, or
    under ``SG_TPU_DEVICE_ENCODE=0``, the rows upload as packed (bucket,
    value) slots (``pack_hash_inputs``) expanded by ``_device_hash``: in two
    width tiers when profitable (most corpora have a long-tail nnz
    distribution -- e.g. 94% of company names fit 32 slots while the ELL
    width is set by the longest string), restored to the original order
    with a device gather."""
    if dim > (1 << 15):
        raise ValueError("hash_dim must be <= 32768")
    src = getattr(ell, "device_src", None)
    if src is not None and device_encode_enabled():
        full = _prefetched_hash(src, dim, device)
        if full is not None:
            if n_pad > full.shape[0]:
                full = torch.cat(
                    [full, full.new_zeros((n_pad - full.shape[0], dim))]
                )
            return full
        return _build_hash_from_codes(src, n_pad, dim, device)
    n = ell.n_rows
    nnz = ell.nnz_per_row()
    narrow = nnz <= narrow_w
    frac = narrow.mean() if n else 0.0
    if ell.width <= narrow_w + 8 or frac < 0.5 or n < min_rows:
        h = _device_hash(_to_device(pack_hash_inputs(ell, n, dim), device), dim)
    else:
        def build_tier(order_slice, wide):
            packed = _pack_rows_ordered(
                ell.ids, ell.vals64, order_slice,
                ell.width if wide else narrow_w, dim,
            )
            return _device_hash(_to_device(packed, device), dim)

        h = _tiered_rows(narrow, build_tier, device)
    if n_pad > n:
        h = torch.cat([h, h.new_zeros((n_pad - n, dim))])
    return h


# ------------------------------------------------------------------- phase 1
def _stable_topk(x: torch.Tensor, k: int):
    """``lax.top_k`` semantics: the k largest per row, descending, lower
    index first among ties (a stable sort; ``torch.topk`` leaves tie order
    unspecified)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _ub_topk_scan(
    a_hash: torch.Tensor,  # (m, d) bf16
    b_hash_tiles: torch.Tensor,  # (n_tiles, tile, d) bf16
    thr_eff: float,
    cand_c: int,
    k_tile: int,
):
    """Tiled phase-1 filter for one left chunk (the torch-op form of the
    JAX package's XLA tile body): per right tile the product of the hashed
    projections (bf16 inputs upcast to f32: exact products, f32
    accumulation), threshold on the upper bound, and extraction of the
    tile-local top ``k_tile`` hits -- closed form at k_tile=2, iterated
    max/argmax up to 32, a stable sort above.  The per-tile hits are
    concatenated across tiles and reduced to the top ``cand_c``.

    Returns (ub_vals (m, W), cols (m, W), counts (m,), tile_max (m,),
    drop_bound (m,)): candidate upper bounds (desc; -inf = none), their
    columns, the per-row count of qualified columns, the per-row maximum
    per-tile count, and an upper bound on every DROPPED candidate (-inf
    when the row dropped nothing)."""
    m = a_hash.shape[0]
    n_tiles, tile = b_hash_tiles.shape[0], b_hash_tiles.shape[1]
    dev = a_hash.device
    kt = min(k_tile, tile)
    thr = float(thr_eff)
    a = a_hash.float()
    col = torch.arange(tile, dtype=torch.int32, device=dev)
    counts = torch.zeros(m, dtype=torch.int32, device=dev)
    tmax = torch.zeros(m, dtype=torch.int32, device=dev)
    tbound = torch.full((m,), _NEG, dtype=torch.float32, device=dev)
    tvs, tcs = [], []
    for t in range(n_tiles):
        off = t * tile
        # bf16 values upcast exactly; TF32 would round them to 10 mantissa
        # bits.  The caller's TF32 setting is restored after the product.
        with ieee_f32_matmul():
            ub = a @ b_hash_tiles[t].float().T
        qual = ub >= thr
        ubm = torch.where(qual, ub, _NEG)
        cnt = qual.sum(1, dtype=torch.int32)
        counts += cnt
        tmax = torch.maximum(tmax, cnt)
        if kt == 2:
            # Closed form: top-1 = (max, first argmax); top-2 value = max
            # with the argmax column masked; its column = (sum of qualified
            # column indices) - argmax (exact for cnt == 2).  Rows with
            # cnt > 2 report bound vmax2 and are re-matched by escalation.
            vmax = ubm.max(1).values
            cmax = ubm.argmax(1).to(torch.int32)
            vmax2 = ubm.scatter(1, cmax[:, None].long(), _NEG).max(1).values
            s1 = torch.where(qual, col, 0).sum(1, dtype=torch.int32)
            have1, have2 = cnt >= 1, cnt == 2
            tvs.append(torch.stack(
                [torch.where(have1, vmax, _NEG), torch.where(have2, vmax2, _NEG)],
                1,
            ))
            tcs.append(torch.stack(
                [torch.where(have1, cmax, 0) + off,
                 torch.where(have2, s1 - cmax, 0) + off],
                1,
            ))
            tbound = torch.maximum(tbound, torch.where(cnt > 2, vmax2, _NEG))
            continue
        if kt <= 32:
            vs, cs = [], []
            cur = ubm
            for _ in range(kt):
                v = cur.max(1).values
                i = cur.argmax(1)
                vs.append(v)
                cs.append(i.to(torch.int32) + off)
                cur = cur.scatter(1, i[:, None], _NEG)
            tv = torch.stack(vs, 1)
            tc = torch.stack(cs, 1)
        else:
            tv, ti = _stable_topk(ubm, kt)
            tc = ti.to(torch.int32) + off
        # Anything not extracted from this tile is <= the tile's smallest
        # extracted value (only relevant on overflow).
        tbound = torch.maximum(tbound, torch.where(cnt > kt, tv[:, -1], _NEG))
        tvs.append(tv)
        tcs.append(tc)
    w_vals = torch.stack(tvs, 1).reshape(m, n_tiles * kt)
    w_cols = torch.stack(tcs, 1).reshape(m, n_tiles * kt)
    drop_bound = tbound
    if n_tiles * kt > cand_c:
        # Truncation only DROPS something when a row extracted more than
        # cand_c finite candidates.
        n_finite = (w_vals > _NEG).sum(1, dtype=torch.int32)
        w_vals, idx = _stable_topk(w_vals, cand_c)
        w_cols = torch.gather(w_cols, 1, idx)
        drop_bound = torch.maximum(
            drop_bound, torch.where(n_finite > cand_c, w_vals[:, -1], _NEG)
        )
    else:
        # Sorted descending so each row's valid candidates form a prefix
        # (the invariant ``_compact_cols`` relies on).
        w_vals, idx = _stable_topk(w_vals, n_tiles * kt)
        w_cols = torch.gather(w_cols, 1, idx)
    return w_vals, w_cols, counts, tmax, drop_bound


def match_block(a_hash, b_hash_tiles, thr_eff, cand_c: int, k_tile: int = 4):
    """One left block against one right block: the phase-1 candidate
    selector (``_ub_topk_scan``)."""
    return _ub_topk_scan(a_hash, b_hash_tiles, thr_eff, cand_c, k_tile)


def finalize_ship(w_vals: torch.Tensor, w_cols: torch.Tensor) -> torch.Tensor:
    """Wire format for the download: sentinel columns."""
    return torch.where(w_vals > _NEG, w_cols, -1)


def _compact_cols(cols: torch.Tensor, budget: int):
    """Ragged-prefix compaction of a sentinel-column candidate matrix.

    ``cols`` is (R, C) int32 with each row's valid entries (>= 0) in a
    prefix.  Returns ``(flat, n_i)``: ``n_i[r]`` the per-row valid count,
    ``flat`` (budget,) the row-major concatenation of every row's valid
    prefix, -1 padded.  Entries beyond ``budget`` are dropped -- the host
    detects that via ``n_i.sum() > budget`` and ships the full matrix."""
    r, c = cols.shape
    dev = cols.device
    n_i = (cols >= 0).sum(1, dtype=torch.int32)
    ends = torch.cumsum(n_i, 0, dtype=torch.int32)
    starts = ends - n_i
    total = ends[-1]
    # out_row[j] = the row owning output slot j: a mark at every row's start
    # (starts past the budget land in a dropped extra slot), prefix-summed.
    marks = torch.zeros(budget + 1, dtype=torch.int32, device=dev)
    marks.index_add_(0, starts.clamp(max=budget).long(), torch.ones_like(starts))
    out_row = torch.cumsum(marks[:budget], 0, dtype=torch.int32) - 1
    out_row = out_row.clamp(0, r - 1).long()
    j = torch.arange(budget, dtype=torch.int32, device=dev)
    k = j - starts[out_row]
    idx = (out_row * c + k).clamp(0, r * c - 1)
    flat = torch.where(j < total, cols.reshape(-1)[idx], -1)
    return flat, n_i


def _as_i32(w: torch.Tensor) -> torch.Tensor:
    """int64 values < 2^32 -> int32 tensor with the same low 32 bits."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def _pack20(flat: torch.Tensor) -> torch.Tensor:
    """Bit-pack a column-id stream (values < 2^20; length a multiple of 8)
    into 20-bit fields: 8 ids -> 5 32-bit words (as int32 bit patterns)."""
    v = flat.clamp(min=0).long().reshape(-1, 8)
    w0 = v[:, 0] | (v[:, 1] << 20)
    w1 = (v[:, 1] >> 12) | (v[:, 2] << 8) | (v[:, 3] << 28)
    w2 = (v[:, 3] >> 4) | (v[:, 4] << 16)
    w3 = (v[:, 4] >> 16) | (v[:, 5] << 4) | (v[:, 6] << 24)
    w4 = (v[:, 6] >> 8) | (v[:, 7] << 12)
    w = torch.stack([w0, w1, w2, w3, w4], 1).reshape(-1) & 0xFFFFFFFF
    return _as_i32(w)


def _unpack20(words: np.ndarray, count: int) -> np.ndarray:
    """Host inverse of ``_pack20``: 5 uint32 words -> 8 ids, int64."""
    w = words.reshape(-1, 5)
    m = np.uint32((1 << 20) - 1)
    parts = [
        w[:, 0] & m,
        ((w[:, 0] >> 20) | (w[:, 1] << 12)) & m,
        (w[:, 1] >> 8) & m,
        ((w[:, 1] >> 28) | (w[:, 2] << 4)) & m,
        ((w[:, 2] >> 16) | (w[:, 3] << 16)) & m,
        (w[:, 3] >> 4) & m,
        ((w[:, 3] >> 24) | (w[:, 4] << 8)) & m,
        (w[:, 4] >> 12) & m,
    ]
    return np.stack(parts, axis=1).reshape(-1)[:count].astype(np.int64)


def _ship_cols(flat: torch.Tensor, n_right_p: int) -> torch.Tensor:
    """Device-side wire form of a compacted column stream: 20-bit packed
    when ids fit (columns are < the padded corpus size)."""
    if n_right_p <= (1 << 20):
        return _pack20(flat)
    return flat


def _download_cols(host: np.ndarray, total: int, n_right_p: int) -> np.ndarray:
    """Host decode of ``_ship_cols``: unpack the first ``total`` ids."""
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    if n_right_p <= (1 << 20):
        return _unpack20(host, total)
    return host[:total].astype(np.int64)


def _pack_meta(*parts: torch.Tensor) -> torch.Tensor:
    """Concatenate per-row metadata vectors (i32 counts, f32 bounds, ...)
    into ONE i32 tensor (f32 as its bit pattern), so each segment costs a
    single device-to-host transfer."""
    out = []
    for x in parts:
        x = x.reshape(-1)
        if x.dtype == torch.float32:
            x = x.view(torch.int32)
        out.append(x.to(torch.int32))
    return torch.cat(out)


def _flat_wire_len(budget: int, n_right_p: int) -> int:
    """Device-side word count of a budget-sized compacted column stream
    (20-bit packed when ids fit, raw i32 otherwise)."""
    return (budget // 8) * 5 if n_right_p <= (1 << 20) else budget


def _join_wire(meta: torch.Tensor, flat: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-row metadata and the compacted column stream as ONE i32 tensor:
    each segment (and each escalation job) downloads in one transfer."""
    if flat is None:
        return meta
    return torch.cat([meta, flat])


def _split_wire(wire_h: np.ndarray, has_flat: bool, budget: int,
                n_right_p: int):
    """Host inverse of ``_join_wire``: (meta_words, flat_words|None)."""
    if not has_flat:
        return wire_h, None
    fl = _flat_wire_len(budget, n_right_p)
    flat = wire_h[len(wire_h) - fl:]
    if n_right_p <= (1 << 20):
        flat = flat.view(np.uint32)
    return wire_h[: len(wire_h) - fl], flat


# Single-worker pool so segment downloads (a) stay ordered and (b) overlap
# the consumer's host-side exact scoring of earlier segments.
_DL_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sg-dl")
#: Scoring worker: per-segment exact rescore + selection run here so the
#: stream consumer goes straight back to waiting on the next download.
_SCORE_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sg-score")
#: Escalation downloads get their OWN worker: their device work queues
#: behind every remaining segment scan.
_ESC_DL_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="sg-esc-dl")
#: one copy stream per (downloading thread, device)
_COPY_STREAMS: Dict[tuple, "torch.cuda.Stream"] = {}


def _mark(t: torch.Tensor) -> Optional["torch.cuda.Event"]:
    """An event recorded on the current stream right after the work that
    produces ``t`` was enqueued (None on the CPU)."""
    if not t.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def _to_host(t: torch.Tensor, ready: Optional["torch.cuda.Event"]) -> np.ndarray:
    """Download ``t`` once ``ready`` has fired: the copy runs on this
    thread's copy stream, which waits on the event -- so a segment's
    download does not queue behind later segments' scans on the compute
    stream."""
    if not t.is_cuda:
        return t.numpy()
    key = (threading.get_ident(), t.device)
    stream = _COPY_STREAMS.get(key)
    if stream is None:
        stream = _COPY_STREAMS[key] = torch.cuda.Stream(device=t.device)
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    t.record_stream(stream)
    done.synchronize()
    return host.numpy()


def _fetch_segment(wire, cols2, has_flat, budget, n_right_p, seg_rows, ready):
    """Download one segment's single-wire transfer (metadata + compacted
    candidate stream) on the download worker.  When the segment overflowed
    the compaction budget (or never compacted), the full candidate matrix
    downloads here too.  The segment's maximum per-tile count comes from
    the downloaded tmax row."""
    wire_h = _to_host(wire, ready)
    meta_w, flat_w = _split_wire(wire_h, has_flat, budget, n_right_p)
    meta_h = meta_w.reshape(-1, seg_rows)
    mc = int(meta_h[1].max(initial=0))
    flat_h = None
    if flat_w is not None:
        total = int(meta_h[-1].sum())  # n_i is packed last
        if total <= budget:
            flat_h = _download_cols(flat_w, total, n_right_p)
    cols_h = None if flat_h is not None else _to_host(cols2, ready)
    return meta_h, flat_h, cols_h, mc


def _consume_stream(futs, budget, n_right_p, seg_rows, n_left, n_right):
    """Consumer of a dispatched segment list: prefetch every segment's
    downloads on the worker thread, then yield per-segment candidate pairs
    in order.  Abandoning the generator cancels not-yet-started
    prefetches."""
    depth = 3  # one downloading, two ready: bounded host memory

    def submit(g):
        wire, cols2, has_flat, ready = futs[g]
        return _DL_POOL.submit(
            _fetch_segment, wire, cols2, has_flat, budget, n_right_p,
            seg_rows, ready,
        )

    fetches = {g: submit(g) for g in range(min(depth, len(futs)))}
    try:
        for g in range(len(futs)):
            if g + depth < len(futs):
                fetches[g + depth] = submit(g + depth)
            base = g * seg_rows
            rows_here = max(0, min(seg_rows, n_left - base))
            if rows_here == 0:
                fetches.pop(g).result()  # still drain (keeps pool ordered)
                continue
            meta_h, flat_h, cols_pref, mc = fetches.pop(g).result()
            counts_h = meta_h[0][:rows_here]
            tmax_h = meta_h[1][:rows_here]
            bound_h = meta_h[2].view(np.float32)[:rows_here]
            if flat_h is not None:
                n_i_h = meta_h[3]
                rows_l = np.repeat(
                    np.arange(seg_rows, dtype=np.int64), n_i_h
                )
                keep = (rows_l < rows_here) & (flat_h < n_right)
                yield (
                    base + rows_l[keep], flat_h[keep],
                    base, rows_here, bound_h, counts_h, tmax_h, mc,
                )
                continue
            cols_h = cols_pref[:rows_here]
            r_g, c_g = _pairs_from_ship(
                cols_h, n_right,
                row_ids=base + np.arange(rows_here, dtype=np.int64),
            )
            yield (r_g, c_g, base, rows_here, bound_h, counts_h, tmax_h, mc)
    finally:
        for f in fetches.values():
            f.cancel()


def _finish_rows(wire, ub_last, cols2, m, m_p, budget, n_right_p, n_right,
                 ready):
    """Download half of a (possibly deferred) hot-row re-match: one transfer
    carrying metadata + the compacted stream when it fit the budget, else
    the full candidate matrix (the range ``sg.match.esc_download``, on the
    thread that downloads)."""
    with span("match.esc_download"):
        bound_h = None
        if wire is not None:
            wire_h = _to_host(wire, ready)
            meta_w, flat_w = _split_wire(wire_h, True, budget, n_right_p)
            meta_h = meta_w.reshape(2, -1)
            bound_h = meta_h[0].view(np.float32)[:m]
            n_i_h = meta_h[1]
            total = int(n_i_h.sum())
            if total <= budget:
                flat_h = _download_cols(flat_w, total, n_right_p)
                rows_l = np.repeat(np.arange(m_p, dtype=np.int64), n_i_h)
                keep = (rows_l < m) & (flat_h < n_right)
                return rows_l[keep], flat_h[keep], bound_h
        if bound_h is None:
            bound_h = _to_host(ub_last, ready).reshape(-1)[:m]
        cols_h = _to_host(cols2, ready)[:m]
        rows_pos, cols_f = _pairs_from_ship(cols_h, n_right)
        return rows_pos, cols_f, bound_h


def _corpus_match(
    a_hash_chunks: torch.Tensor,  # (n_chunks, chunk, d) bf16
    b_hash_tiles: torch.Tensor,  # (n_tiles, tile, d) bf16
    thr_eff: float,
    cand_c: int,
    k_tile: int,
):
    """Phase 1 of a stack of left chunks against the whole right corpus:
    ``(cols, bound, counts, tmax, max_cnt)``, cols with -1 sentinels."""
    cols, bound, counts, tmax = [], [], [], []
    for a in a_hash_chunks:
        w_vals, w_cols, c, t, b = _ub_topk_scan(
            a, b_hash_tiles, thr_eff, cand_c, k_tile
        )
        cols.append(finalize_ship(w_vals, w_cols))
        bound.append(b)
        counts.append(c)
        tmax.append(t)
    tmax_s = torch.stack(tmax)
    return (torch.stack(cols), torch.stack(bound), torch.stack(counts),
            tmax_s, tmax_s.max())


# -------------------------------------------------------------- host driver
def _gather_pad_rows(h: torch.Tensor, idx: torch.Tensor, n_valid: int,
                     n_pad: int) -> torch.Tensor:
    """Device gather of selected rows, zero-padded to ``n_pad`` (padding
    rows must be all-zero so they can never qualify)."""
    g = h[idx]
    g[n_valid:n_pad] = 0
    return g


def _phase1_single(
    left: EllMatrix,
    right: EllMatrix,
    is_self: bool,
    hash_dim: int,
    left_chunk: int,
    right_tile: int,
    device: torch.device,
    left_sel: Optional[np.ndarray] = None,
    right_sel: Optional[np.ndarray] = None,
):
    """Build device-resident hash matrices once; return the phase-1
    callables ``run_stream`` / ``run_rows`` plus the caps (c_cap, tile).

    ``left_sel`` / ``right_sel`` (duplicate-collapse layer): row selectors
    into the matrices -- the selected rows are gathered ON DEVICE from the
    prefetched full-corpus hash, so the scan runs over unique rows only."""
    n_left = left.n_rows if left_sel is None else len(left_sel)
    n_right = right.n_rows if right_sel is None else len(right_sel)
    (tile, n_right_p, chunk, n_left_p, n_seg, cpg, n_chunks,
     seg_rows) = _p1_geometry(n_left, n_right, left_chunk, right_tile)

    def build_selected(ell, sel, n_valid, n_pad):
        """Hash matrix of selected rows only.  With a byte-level payload:
        gathered from the prefetched full-corpus matrix, else built from the
        selected rows' own payload.  Otherwise the full matrix is hashed
        (packed slots) and the selected rows gathered on the device."""
        src = getattr(ell, "device_src", None)
        if src is not None and device_encode_enabled():
            full = _prefetched_hash(src, hash_dim, device)
            if full is None:
                return _build_hash_from_codes(
                    src.take_rows(sel), n_pad, hash_dim, device
                )
        else:
            full = build_hash_matrix(ell, ell.n_rows, hash_dim, device)
        idx = np.zeros(n_pad, dtype=np.int64)
        idx[:n_valid] = sel
        return _gather_pad_rows(full, _to_device(idx, device), n_valid, n_pad)

    _dense: dict = {}

    def dense_b():
        """(n_right_p, d) right hash."""
        if "b" not in _dense:
            if right_sel is None:
                _dense["b"] = build_hash_matrix(right, n_right_p, hash_dim, device)
            else:
                _dense["b"] = build_selected(
                    right, right_sel, n_right, n_right_p
                )
        return _dense["b"]

    def dense_a():
        """(n_chunks * chunk, d) left hash, zero-padded to whole segments."""
        if "a" not in _dense:
            b_hash = dense_b()
            if is_self and n_left_p <= n_right_p:
                a = b_hash[:n_left_p]
            elif left_sel is None:
                a = build_hash_matrix(left, n_left_p, hash_dim, device)
            else:
                a = build_selected(left, left_sel, n_left, n_left_p)
            if n_chunks * chunk > n_left_p:
                a = torch.cat([
                    a, a.new_zeros((n_chunks * chunk - n_left_p, hash_dim))
                ])
            _dense["a"] = a
        return _dense["a"]

    def run_stream(thr_eff, cand_c, k_tile):
        """Yield ``(rows, cols, base, rows_here, bound, counts, tmax,
        max_cnt)`` per segment -- rows/cols are the segment's candidate
        pairs (global int64 ids).  All segments are dispatched up front
        (including the compaction epilogue); the device queue drains while
        the consumer scores earlier segments."""
        thr = float(thr_eff)
        fused = use_fused(device, k_tile, thr_eff, seg_rows, n_right_p,
                          hash_dim, tile, cand_c)
        # Ragged-prefix compaction: skip when thresholdless (every column
        # qualifies -- nothing to compact) or the full ship is small anyway.
        do_compact = thr_eff > 0 and cand_c > _SHIP_BUDGET_ROWS
        budget = -(-seg_rows * _SHIP_BUDGET_ROWS // 1024) * 1024

        def ship(cols2, counts, tmax, bound):
            if do_compact:
                flat, n_i = _compact_cols(cols2, budget)
                wire = _join_wire(
                    _pack_meta(counts, tmax, bound, n_i),
                    _ship_cols(flat, n_right_p),
                )
            else:
                wire = _pack_meta(counts, tmax, bound)
            return wire, cols2, do_compact, _mark(wire)

        b_hash = dense_b()
        b_hash_tiles = b_hash.reshape(n_right_p // tile, tile, hash_dim)
        a_hash = dense_a()
        futs = []
        for g in range(n_seg):
            a_seg = a_hash[g * seg_rows:(g + 1) * seg_rows]
            if fused:
                # Fused phase 1: matmul + closed-form kt=2 extraction +
                # running top-C merge in one CUDA kernel.
                cols2, counts, tmax, bound, _ = p1_fused_closed2(
                    a_seg, b_hash, thr, tile=tile, cand_c=cand_c,
                )
            else:
                cols, bound, counts, tmax, _ = _corpus_match(
                    a_seg.reshape(cpg, chunk, hash_dim), b_hash_tiles, thr,
                    cand_c, k_tile,
                )
                cols2 = cols.reshape(-1, cols.shape[-1])
            futs.append(ship(cols2, counts, tmax, bound))
        yield from _consume_stream(
            futs, budget, n_right_p, seg_rows, n_left, n_right
        )

    def run_rows(row_idx: np.ndarray, thr_eff, cand_c, k_tile,
                 budget_hint: Optional[int] = None, defer: bool = False,
                 stats: Optional[dict] = None):
        """Phase 1 restricted to the given left rows (hot-row escalation):
        device-gathers those rows' hash vectors and matches them at a larger
        candidate width.  Returns ``(rows_pos, cols, bound)`` where rows_pos
        indexes into ``row_idx``; ``defer=True`` dispatches the device work
        now and returns a zero-arg ``finish()`` for the download.  Rows that
        run on ``p1_fused_topk`` (padded to its 128-row blocks, not to
        whole chunks) add to ``stats["esc_kernel_rows"]``."""
        m = len(row_idx)
        m_k = -(-m // 128) * 128
        topk = use_fused_topk(device, k_tile, thr_eff, m_k, n_right_p,
                              hash_dim, tile, cand_c)
        m_p = m_k if topk else -(-m // chunk) * chunk
        idx = np.zeros(m_p, dtype=np.int64)
        idx[:m] = row_idx
        a_sel = _gather_pad_rows(dense_a(), _to_device(idx, device), m, m_p)
        thr = float(thr_eff)
        if topk:
            cols2, counts, _tmax, ub_last, _ = p1_fused_topk(
                a_sel, dense_b(), thr, tile=tile, cand_c=cand_c, k_tile=k_tile,
            )
            if stats is not None:
                stats["esc_kernel_rows"] = stats.get("esc_kernel_rows", 0) + m
        elif use_fused(device, k_tile, thr_eff, m_p, n_right_p, hash_dim, tile,
                       cand_c):
            # kt=2 escalation buckets (rows unsafe only via top-C
            # truncation) re-match on the fused kernel too.
            cols2, counts, _tmax, ub_last, _ = p1_fused_closed2(
                a_sel, dense_b(), thr, tile=tile, cand_c=cand_c,
            )
        else:
            cols, ub_last, counts, _tmax, _ = _corpus_match(
                a_sel.reshape(-1, chunk, hash_dim),
                dense_b().reshape(n_right_p // tile, tile, hash_dim),
                thr, cand_c, k_tile,
            )
            cols2 = cols.reshape(-1, cols.shape[-1])
        w = cols2.shape[-1]
        wire = None
        budget = 0
        if (
            thr_eff > 0
            and budget_hint is not None
            and m_p * w > _ROWS_COMPACT_MIN
        ):
            budget = _next_pow2(budget_hint + 8)
            if budget < m_p * w:
                flat, n_i = _compact_cols(cols2, budget)
                wire = _join_wire(
                    _pack_meta(ub_last, n_i), _ship_cols(flat, n_right_p)
                )
        ready = _mark(cols2 if wire is None else wire)

        def finish():
            return _finish_rows(
                wire, ub_last, cols2, m, m_p, budget, n_right_p, n_right,
                ready,
            )

        if defer:
            return _ESC_DL_POOL.submit(finish).result
        return finish()

    return run_stream, run_rows, n_right_p, tile


def _pairs_from_ship(cols: np.ndarray, n_right: int, row_ids=None):
    """Flatten a shipped (m, W) sentinel-column matrix into (rows, cols)
    pair arrays.  ``row_ids`` maps local row positions to global rows."""
    valid = (cols >= 0) & (cols < n_right)
    m = cols.shape[0]
    if row_ids is None:
        row_ids = np.arange(m, dtype=np.int64)
    rows_b = np.broadcast_to(row_ids[:, None], cols.shape)
    return (
        np.ascontiguousarray(rows_b[valid]),
        np.ascontiguousarray(cols[valid].astype(np.int64)),
    )


def _select_topn(
    rows_f: np.ndarray,
    cols_f: np.ndarray,
    sims: np.ndarray,
    n_left: int,
    min_similarity: float,
    max_n: int,
):
    """Per-row top-n selection over scored pairs.

    Returns (rows_s, cols_s, sims_s, kept_q, row_cut): selected pairs sorted
    (row asc, sim desc, col asc), per-row qualified counts, and the per-row
    exact top-n cut (-inf when fewer than max_n qualified).

    Native path: per-row bucket sort in C++ (exact_scorer.cpp
    select_topn_f64); the numpy lexsort below is the fallback and oracle."""
    from ..native import get_scorer_lib

    lib = get_scorer_lib()
    if lib is not None and len(rows_f):
        rows_c = np.ascontiguousarray(rows_f, dtype=np.int64)
        cols_c = np.ascontiguousarray(cols_f, dtype=np.int64)
        sims_c = np.ascontiguousarray(sims, dtype=np.float64)
        kept_q = np.empty(n_left, dtype=np.int64)
        row_cut = np.empty(n_left, dtype=np.float64)
        out_idx = np.empty(len(rows_c), dtype=np.int64)
        n_sel = lib.select_topn_f64(
            rows_c, cols_c, sims_c, len(rows_c), n_left,
            float(min_similarity), int(max_n), out_idx, kept_q, row_cut,
        )
        sel = out_idx[:n_sel]
        return rows_c[sel], cols_c[sel], sims_c[sel], kept_q, row_cut
    qualify = (sims > 0) & (sims >= min_similarity)
    rows_q, cols_q, sims_q = rows_f[qualify], cols_f[qualify], sims[qualify]
    kept_q = np.bincount(rows_q, minlength=n_left)

    order = np.lexsort((cols_q, -sims_q, rows_q))
    rows_s, cols_s, sims_s = rows_q[order], cols_q[order], sims_q[order]
    row_cut = np.full(n_left, -np.inf)
    if len(rows_s):
        new_row = np.r_[True, rows_s[1:] != rows_s[:-1]]
        grp_start = np.maximum.accumulate(
            np.where(new_row, np.arange(len(rows_s)), 0)
        )
        rank = np.arange(len(rows_s)) - grp_start
        keep = rank < max_n
        # Exact top-n cut: similarity of the max_n-th kept pair per row.
        at_cut = rank == max_n - 1
        row_cut[rows_s[at_cut]] = sims_s[at_cut]
        rows_s, cols_s, sims_s = rows_s[keep], cols_s[keep], sims_s[keep]
    return rows_s, cols_s, sims_s, kept_q, row_cut


def adaptive_topn(
    phase1_run,
    left: EllMatrix,
    right: EllMatrix,
    min_similarity: float,
    max_n: int,
    *,
    c_cap: int,
    kt_cap: int,
    c0: int,
    kt0: int,
    phase1_run_rows=None,
    score_dtype=np.float64,
    stats: Optional[dict] = None,
    left_map: Optional[np.ndarray] = None,
    right_map: Optional[np.ndarray] = None,
    n_left: Optional[int] = None,
    n_right: Optional[int] = None,
) -> MatchPairs:
    """Adaptive driver shared by the single-chip and distributed paths.

    ``left_map`` / ``right_map`` (duplicate-collapse layer): phase-1 row and
    column ids index UNIQUE rows; the maps translate them to representative
    rows of the original matrices for the exact rescore.  ``n_left`` /
    ``n_right`` are then the unique counts.

    The device reports, per row, an upper bound on every candidate it
    DROPPED (per-tile k_tile overflow or top-C truncation; -inf when
    nothing was dropped).  A row is provably complete when that bound
    cannot qualify AND beat the row's exact top-n cut.  With
    ``phase1_run_rows`` (single-chip path), the remaining unsafe rows are
    re-matched individually at escalated widths -- one hot row never
    inflates the corpus-wide download or forces a second full pass.
    Without it (distributed path), the widths grow globally.
    """
    if n_left is None:
        n_left = left.n_rows
    if n_right is None:
        n_right = right.n_rows
    max_n_eff = min(max_n, n_right)

    def rescore(rows, cols):
        r = rows if left_map is None else left_map[rows]
        c = cols if right_map is None else right_map[cols]
        return rescore_pairs_fp64(left, right, r, c, acc_dtype=score_dtype)
    if np.dtype(score_dtype) == np.float32:
        # The reference thresholds inside sp_matmul_topn with the threshold
        # cast to the MATRIX dtype, so float32 configurations must compare
        # against the float32-rounded threshold (its exact f64 promotion
        # here -- scores are f32-valued too, so the comparison is exact).
        min_similarity = float(np.float32(min_similarity))
    qual_low = min_similarity if min_similarity > 0 else 0.0
    c, kt = c0, kt0
    # Per-fit stats dict (the caller's, when provided): concurrent fits
    # each accumulate into their own dict.
    if stats is None:
        stats = {}
    stats.update(
        p1_wait=0.0, rescore=0.0, select=0.0, esc_wait=0.0,
        rescore_wait=0.0, rounds=0, pairs_scored=0, esc_kernel_rows=0,
    )

    def split_jobs(idx, tmax, counts, c):
        """Exact-width kt-bucket split of unsafe rows (see the escalation
        loop below for the rationale): pow2 kt buckets from the device's
        per-row per-tile maxima, sub-chunk buckets merged into the next
        wider one, C per bucket from the rows' exact qualified counts."""
        tm = tmax[idx]
        raw = []
        prev_tm = 0
        for ktb in (2, 4, 8):
            gb = idx[(tm > prev_tm) & (tm <= ktb)]
            if len(gb):
                raw.append((gb, ktb))
            prev_tm = ktb
        g_hi = idx[tm > 8]
        if len(g_hi):
            raw.append((
                g_hi,
                min(kt_cap, max(8, _next_pow2(int(tmax[g_hi].max())))),
            ))
        jobs = []
        pend = None
        for i, (gb, kt_g) in enumerate(raw):
            if pend is not None:
                gb = np.concatenate([pend, gb])
                pend = None
            if len(gb) < _ESC_MIN_JOB_ROWS and i + 1 < len(raw):
                pend = gb
                continue
            c_g = min(
                max(c_cap, 1),
                max(_next_pow2(int(counts[gb].max())), c),
            )
            jobs.append((gb, c_g, kt_g))
        return jobs

    def dispatch_job(g, c_big, kt_use, counts, rnd):
        logger.debug(
            "escalate %d rows to C=%d k_tile=%d (round %d)",
            len(g), c_big, kt_use, rnd,
        )
        # rows re-matched per escalation rung: round and extraction width
        key = f"esc_rows_r{rnd}_kt{kt_use}"
        stats[key] = stats.get(key, 0) + len(g)
        with span("match.esc_dispatch", stats, "esc_wait"):
            fin = phase1_run_rows(
                g, effective_threshold(min_similarity), c_big, kt_use,
                budget_hint=int(counts[g].sum()), defer=True, stats=stats,
            )
        return g, fin

    def collect(c, kt, stream_escalate):
        """One full phase-1 pass.  Segments stream; each segment's exact
        fp64 scoring AND its per-row top-n selection run while the device
        matches later segments (selection is row-local, so per-segment
        selection equals the global one).  With ``stream_escalate``, each
        segment's unsafe rows are detected and their escalation re-match
        DISPATCHED immediately -- the device executes it behind the
        already-enqueued segment scans, so by the time the stream drains,
        most escalation compute (and its downloads, via the deferred
        finish) has already overlapped the host's scoring of later
        segments instead of serializing after the whole pass."""
        logger.debug("phase1: C=%d k_tile=%d", c, kt)
        sel_r, sel_c, sel_s = [], [], []
        counts = np.zeros(n_left, dtype=np.int64)
        tmax = np.zeros(n_left, dtype=np.int64)
        bound = np.full(n_left, -np.inf)
        kept_q = np.zeros(n_left, dtype=np.int64)
        row_cut = np.full(n_left, -np.inf)
        pending = []  # deferred escalation jobs (rows, finish)
        esc_buf: list = []  # unsafe rows accumulated across segments
        esc_cnt = 0
        max_cnt = 0

        def flush_esc():
            """Dispatch the accumulated unsafe rows.  Accumulating across
            segments keeps the JOB count low -- every deferred job costs a
            full device round-trip at finish time, and per-segment unsafe
            sets are typically far below one device chunk."""
            nonlocal esc_cnt
            if not esc_buf:
                return
            idx_g = np.concatenate(esc_buf)
            esc_buf.clear()
            esc_cnt = 0
            for g, c_big, kt_use in split_jobs(idx_g, tmax, counts, c):
                if len(g) * c_big > 16_000_000:
                    # Unlike the post-stream rounds (jobs finish as the
                    # next dispatches), streamed jobs all stay deferred
                    # until the stream drains -- leave oversized buckets
                    # for the post-stream machinery instead of parking a
                    # giant device buffer.
                    continue
                pending.append(dispatch_job(g, c_big, kt_use, counts, 1))

        def score_task(r_g, cl_g, base, m_g):
            """Exact rescore + per-segment selection -- native calls that
            release the GIL, run on the scoring worker so the consumer
            thread goes straight back to blocking on the next segment's
            download (wire/device wait and host scoring overlap).  Its
            seconds go back to the calling thread with the result."""
            took: dict = {}
            with span("match.rescore", took, "rescore"):
                sims_g = rescore(r_g, cl_g)
            with span("match.select", took, "select"):
                sel = _select_topn(
                    r_g - base, cl_g, sims_g, m_g, min_similarity, max_n_eff
                )
            return sel, len(r_g), took

        def resolve(fut, base, m_g, bound_g):
            """Fold one finished scoring task into the driver state (main
            thread: escalation dispatch and stats stay unsynchronized)."""
            nonlocal esc_cnt
            with span("match.rescore_wait", stats, "rescore_wait"):
                (r_s, c_s, s_s, kq_g, rc_g), n_p, took = fut.result()
            for k, v in took.items():
                stats[k] += v
            stats["pairs_scored"] += n_p
            sel_r.append(r_s + base)
            sel_c.append(c_s)
            sel_s.append(s_s)
            kept_q[base : base + m_g] = kq_g
            row_cut[base : base + m_g] = rc_g
            if not stream_escalate:
                return
            idx_l = np.flatnonzero(unsafe_rows(bound_g, kq_g, rc_g))
            if not len(idx_l):
                return
            esc_buf.append(idx_l.astype(np.int64) + base)
            esc_cnt += len(idx_l)
            if esc_cnt >= _ESC_MIN_JOB_ROWS:
                flush_esc()

        from collections import deque

        inflight: deque = deque()
        stream = iter(phase1_run(effective_threshold(min_similarity), c, kt))
        while True:
            with span("match.p1_wait", stats, "p1_wait"):
                item = next(stream, None)
            if item is None:
                break
            r_g, cl_g, base, m_g, bound_g, counts_g, tmax_g, mc_g = item
            counts[base : base + m_g] = counts_g
            tmax[base : base + m_g] = tmax_g
            bound[base : base + m_g] = bound_g
            max_cnt = max(max_cnt, mc_g)
            inflight.append((
                _SCORE_POOL.submit(score_task, r_g, cl_g, base, m_g),
                base, m_g, bound_g,
            ))
            # Fold finished tasks in order; cap the queue at two segments so
            # escalation detection (and its overlap with the still-running
            # scan) never lags the stream by more than one segment.
            while inflight and inflight[0][0].done():
                resolve(*inflight.popleft())
            if len(inflight) > 2:
                resolve(*inflight.popleft())
        while inflight:
            resolve(*inflight.popleft())
        flush_esc()
        logger.debug(
            "phase1 done: max_cnt=%d counts.max=%d streamed_esc_jobs=%d",
            max_cnt, int(counts.max(initial=0)), len(pending),
        )
        rows_s = (
            np.concatenate(sel_r) if sel_r else np.zeros(0, np.int64)
        )
        cols_s = (
            np.concatenate(sel_c) if sel_c else np.zeros(0, np.int64)
        )
        sims_s = np.concatenate(sel_s) if sel_s else np.zeros(0)
        return (rows_s, cols_s, sims_s, kept_q, row_cut,
                counts, tmax, bound, max_cnt, pending)

    def unsafe_rows(bound, kept_q, row_cut):
        return escalation_unsafe(bound, kept_q, row_cut, qual_low, max_n_eff)

    (rows_s, cols_s, sims_s, kept_q, row_cut, counts, tmax, bound, max_cnt,
     pending0) = collect(c, kt, stream_escalate=phase1_run_rows is not None)

    def drain_and_merge(pending, rows_s, cols_s, sims_s):
        """Finish deferred escalation jobs (download + exact fp64 rescore,
        each job's scoring overlapping the next job's transfer), then patch
        the selection: top-n is independent per row, so only the escalated
        rows' selections change (the re-run returns a superset of their
        previous candidates)."""
        touched = np.zeros(n_left, dtype=bool)
        parts_r, parts_c, parts_s = [], [], []
        for g, fin in pending:
            with span("match.esc_finish", stats, "esc_wait"):
                rows_pos, g_cols, g_bound = fin()
            g_rows = g.astype(np.int64)[rows_pos]
            with span("match.rescore", stats, "rescore"):
                parts_s.append(rescore(g_rows, g_cols))
            parts_r.append(g_rows)
            parts_c.append(g_cols)
            bound[g] = g_bound
            touched[g] = True
        idx = np.flatnonzero(touched)
        sub_rows = np.concatenate(parts_r)
        sub_cols = np.concatenate(parts_c)
        sub_sims = np.concatenate(parts_s)
        stats["pairs_scored"] += len(sub_rows)
        with span("match.select", stats, "select"):
            r2, c2, s2, kq2, rc2 = _select_topn(
                sub_rows, sub_cols, sub_sims, n_left, min_similarity, max_n_eff
            )
        keep_sel = ~touched[rows_s]
        rows_s = np.concatenate([rows_s[keep_sel], r2])
        cols_s = np.concatenate([cols_s[keep_sel], c2])
        sims_s = np.concatenate([sims_s[keep_sel], s2])
        kept_q[idx] = kq2[idx]
        row_cut[idx] = rc2[idx]
        return rows_s, cols_s, sims_s

    escalations = 0
    if pending0:
        # Streamed round 1: every job was dispatched while later segments
        # were still scanning; only the downloads + scoring remain.
        escalations = 1
        stats["rounds"] = 1
        rows_s, cols_s, sims_s = drain_and_merge(
            pending0, rows_s, cols_s, sims_s
        )
    last_round = None  # (kt_big, c_full, n_unsafe) of the previous round
    last_bucketed = False
    while True:
        unsafe = unsafe_rows(bound, kept_q, row_cut)
        if not unsafe.any():
            break
        if phase1_run_rows is None:
            # Global-growth fallback (no per-row re-match available).
            grew = False
            if max_cnt > kt and kt < kt_cap:
                kt = min(kt_cap, _next_pow2(max_cnt))
                grew = True
            if counts.max(initial=0) > c and c < c_cap:
                c = min(c_cap, _next_pow2(int(counts.max())))
                grew = True
            if not grew:
                break
            (rows_s, cols_s, sims_s, kept_q, row_cut, counts, tmax, bound,
             max_cnt, _) = collect(c, kt, stream_escalate=False)
            continue
        # Per-row escalation: re-match just the unsafe rows at widths large
        # enough that they provably drop nothing (k_tile covers the largest
        # per-tile count, C covers the largest total count), so one round
        # normally suffices; the counter is a safety net against cap-bound
        # corner cases.
        escalations += 1
        idx = np.flatnonzero(unsafe)
        kt_big = min(kt_cap, max(_next_pow2(max_cnt), kt))
        c_full = min(max(c_cap, 1), max(_next_pow2(int(counts[idx].max())), c))
        forced = escalations > 8 or (
            (kt_big, c_full, len(idx)) == last_round and not last_bucketed
        )
        if forced:
            # Termination guard: widths did not grow between rounds (or the
            # loop is running away) -- force the caps, at which nothing can
            # be dropped (k_tile == tile extracts every qualified column and
            # C == padded corpus width fits them all), so the next unsafe
            # check clears unconditionally.
            kt_big, c_full = kt_cap, max(c_cap, 1)
        jobs = []  # (rows, c_big, kt_use)
        if forced:
            jobs.append((idx, c_full, kt_big))
            last_bucketed = False
        elif escalations < 4 and len(idx) * c_full > 128_000_000:
            # Quantile-bucketed escalation, only when the full-width
            # re-match's device candidate buffer would be too large (the
            # guard is slots: 128M i32 = 512 MB; downloads are compacted so
            # buffer size, not wire bytes, is the constraint -- at the old
            # 32M guard the exact-width one-round split below was skipped
            # for ordinary corpora, costing a whole extra round +
            # re-select): cover the bulk of the unsafe rows at the width
            # the 90th percentile needs; the hot tail waits for the next
            # (wider) round.  The final round always uses the full width,
            # so completeness is unconditional.
            c_q = _next_pow2(int(np.quantile(counts[idx], 0.9)) + 1)
            c_big = min(c_full, max(c_q, 2 * c))
            covered = idx[counts[idx] <= c_big]
            if len(covered):
                idx = covered
            last_bucketed = c_big < c_full or len(idx) < int(unsafe.sum())
            if escalations == 1 and kt_big > 8:
                # Extraction at a large k is a full per-tile sort, so the
                # bucketed bulk extracts at the cheap iterated kt=8 width;
                # rows genuinely above it re-escalate via their drop bound.
                kt_use = 8
                last_bucketed = True
            else:
                kt_use = kt_big
            jobs.append((idx, c_big, kt_use))
        else:
            # Exact width split: the device reports each row's maximum
            # per-tile qualified count (tmax), so the bulk of the unsafe
            # rows run at the cheap iterated kt=8 width they provably fit,
            # and the (typically few) rows above it get exactly the width
            # they need -- both widths are sufficient by construction, so
            # one escalation round settles everything (the drop-bound
            # re-check stays as the unconditional safety net).
            if logger.isEnabledFor(logging.DEBUG):
                logger.debug(
                    "escalate tmax histogram: %s",
                    dict(zip(*map(list, np.unique(
                        np.minimum(tmax[idx], 33), return_counts=True)))),
                )
            # Pow2 kt buckets (split_jobs): the iterated extraction costs
            # ~3 elementwise passes per kt per tile, so re-matching a tmax<=4 row
            # at kt=8 doubles its epilogue for nothing (and the bulk of
            # unsafe rows sit at tmax 3-4; tmax<=2 rows are unsafe only via
            # top-C truncation and re-run on the closed-form kt=2 path).
            # A bucket smaller than one device chunk costs a full chunk
            # scan anyway, so it merges into the next (wider-kt) one.
            jobs.extend(split_jobs(idx, tmax, counts, c))
            last_bucketed = False
        last_round = (kt_big, c_full, int(unsafe.sum()))
        stats["rounds"] = escalations
        pending = [
            dispatch_job(g, c_big, kt_use, counts, escalations)
            for g, c_big, kt_use in jobs
        ]
        rows_s, cols_s, sims_s = drain_and_merge(
            pending, rows_s, cols_s, sims_s
        )
    if len(rows_s):
        true_max = int(np.bincount(rows_s, minlength=n_left).max(initial=0))
    else:
        true_max = 0
    return MatchPairs(
        rows=rows_s, cols=cols_s, sims=sims_s, true_max_n_matches=true_max
    )


# ------------------------------------------------------------- post-fix-ups
def apply_self_join_fixups(pairs: MatchPairs, n: int) -> MatchPairs:
    """Exact-1 diagonal + symmetric closure for self-joins
    (reference string_grouper.py:419-427, :954-964).

    Native path: per-row bucket symmetrize/dedupe in C++
    (exact_scorer.cpp selfjoin_fixups_f64); numpy below is the oracle."""
    from ..native import get_scorer_lib

    lib = get_scorer_lib()
    if lib is not None:
        rows_c = np.ascontiguousarray(pairs.rows, dtype=np.int64)
        cols_c = np.ascontiguousarray(pairs.cols, dtype=np.int64)
        sims_c = np.ascontiguousarray(pairs.sims, dtype=np.float64)
        cap = 2 * len(rows_c) + n
        out_r = np.empty(cap, dtype=np.int64)
        out_c = np.empty(cap, dtype=np.int64)
        out_s = np.empty(cap, dtype=np.float64)
        cnt = lib.selfjoin_fixups_f64(
            rows_c, cols_c, sims_c, len(rows_c), n, out_r, out_c, out_s
        )
        return MatchPairs(
            rows=out_r[:cnt].copy(),
            cols=out_c[:cnt].copy(),
            sims=out_s[:cnt].copy(),
            true_max_n_matches=pairs.true_max_n_matches,
        )
    rows, cols, sims = pairs.rows, pairs.cols, pairs.sims
    off = rows != cols
    rows, cols, sims = rows[off], cols[off], sims[off]
    # Symmetric closure: emit each unordered pair in both directions with one
    # value (our scores are symmetric by construction).
    key_fwd = rows * n + cols
    key_rev = cols * n + rows
    all_keys = np.concatenate([key_fwd, key_rev])
    all_sims = np.concatenate([sims, sims])
    uniq, idx = np.unique(all_keys, return_index=True)
    rows_u = uniq // n
    cols_u = uniq % n
    sims_u = all_sims[idx]
    # Diagonal forced to exactly 1 for every row (_fix_diagonal, :954-958).
    diag = np.arange(n, dtype=np.int64)
    rows_o = np.concatenate([rows_u, diag])
    cols_o = np.concatenate([cols_u, diag])
    sims_o = np.concatenate([sims_u, np.ones(n)])
    order = np.lexsort((cols_o, rows_o))
    return MatchPairs(
        rows=rows_o[order],
        cols=cols_o[order],
        sims=sims_o[order],
        true_max_n_matches=pairs.true_max_n_matches,
    )


def order_like_reference_csr(pairs: MatchPairs) -> MatchPairs:
    """Order pairs the way the reference's value-sorted CSR storage lists
    them: row-major, similarity descending within row, column ascending on
    ties (sp_matmul_topn ``sort=True``)."""
    from ..native import get_scorer_lib

    lib = get_scorer_lib()
    if lib is not None and len(pairs.rows):
        # select_topn_f64 with no threshold/limit IS this sort (all pairs
        # carry sims > 0; zero-sim completion happens later, in the engine).
        rows_c = np.ascontiguousarray(pairs.rows, dtype=np.int64)
        cols_c = np.ascontiguousarray(pairs.cols, dtype=np.int64)
        sims_c = np.ascontiguousarray(pairs.sims, dtype=np.float64)
        n_left = int(rows_c.max()) + 1
        kept_q = np.empty(n_left, dtype=np.int64)
        row_cut = np.empty(n_left, dtype=np.float64)
        out_idx = np.empty(len(rows_c), dtype=np.int64)
        n_sel = lib.select_topn_f64(
            rows_c, cols_c, sims_c, len(rows_c), n_left,
            0.0, len(rows_c), out_idx, kept_q, row_cut,
        )
        if n_sel == len(rows_c):  # nothing filtered: pure reorder
            sel = out_idx
            return MatchPairs(
                rows=rows_c[sel], cols=cols_c[sel], sims=sims_c[sel],
                true_max_n_matches=pairs.true_max_n_matches,
            )
    order = np.lexsort((pairs.cols, -pairs.sims, pairs.rows))
    return MatchPairs(
        rows=pairs.rows[order],
        cols=pairs.cols[order],
        sims=pairs.sims[order],
        true_max_n_matches=pairs.true_max_n_matches,
    )


# ------------------------------------------------ duplicate-collapse layer
def _clean_refined_codes(src) -> Optional[np.ndarray]:
    """Duplicate coding by CLEAN-equality from the device payload's per-row
    hashes: rows whose cleaned bytes are identical (case / stripped-
    punctuation variants of the same string) have identical TF-IDF rows
    regardless of raw differences, so they can share one matcher row --
    a strictly coarser grouping than raw equality.  Hash groups are
    byte-VERIFIED against their representative (mismatching rows demote to
    fresh singleton groups), so a hash collision costs only the check.
    The route without the native library, and the oracle of its one-pass
    ``clean_group_positions`` (``_clean_codes``)."""
    h = getattr(src, "row_hash", None)
    if h is None:
        return None
    lens = src.row_lengths()
    n = len(h)
    order = np.lexsort((lens, h))
    hs, ls = h[order], lens[order]
    new_grp = np.concatenate(
        ([True], (hs[1:] != hs[:-1]) | (ls[1:] != ls[:-1]))
    )
    gid = np.empty(n, dtype=np.int64)
    gid[order] = np.cumsum(new_grp) - 1
    codes, first, perm, starts, counts = _group_positions(gid)
    multi = np.flatnonzero(counts > 1)
    if len(multi):
        mem_cnt = counts[multi] - 1
        tot_m = int(mem_cnt.sum())
        cum_m = np.concatenate(([0], np.cumsum(mem_cnt)[:-1]))
        mem_idx = (
            np.repeat(starts[multi] + 1, mem_cnt)
            + np.arange(tot_m, dtype=np.int64)
            - np.repeat(cum_m, mem_cnt)
        )
        members = perm[mem_idx]
        reps = first[codes[members]].astype(np.int64)
        L = lens[members]
        nz = np.flatnonzero(L > 0)
        ok = np.ones(len(members), dtype=bool)
        if len(nz):
            Lnz = L[nz]
            tot = int(Lnz.sum())
            cum = np.concatenate(([0], np.cumsum(Lnz)[:-1]))
            within = np.arange(tot, dtype=np.int64) - np.repeat(cum, Lnz)
            a = src.flat_codes[np.repeat(src.coff[members[nz]], Lnz) + within]
            b = src.flat_codes[np.repeat(src.coff[reps[nz]], Lnz) + within]
            eq = a == b
            ok[nz] = np.logical_and.reduceat(eq, cum)
        bad = members[~ok]
        if len(bad):
            codes = codes.copy()
            codes[bad] = int(codes.max()) + 1 + np.arange(len(bad))
    return codes


def _group_positions(codes: np.ndarray):
    """Per-group position lists of a duplicate coding.

    Returns ``(codes, first, perm, starts, counts)``: codes RELABELED so
    group ids ascend by first occurrence (group id order == min-position
    order -- the invariant the expansion's tie-break proof needs), the
    first (= minimum) position per group, and the positions of every group
    as ``perm[starts[g] : starts[g] + counts[g]]`` (ascending within a
    group)."""
    codes = np.ascontiguousarray(codes, dtype=np.int64)
    n = len(codes)
    if n == 0:
        e = np.zeros(0, dtype=np.int64)
        return codes, e.astype(np.int32), e, e, e
    u = int(codes.max()) + 1
    counts = np.bincount(codes, minlength=u)
    if (counts == 0).any():
        # Non-dense coding (unused group ids, e.g. from a filtered
        # factorize): densify first -- the relabel below assumes every id
        # in [0, max] occurs, and would otherwise recurse forever.
        codes = (np.cumsum(counts > 0) - 1)[codes]
        u = int(codes.max()) + 1
        counts = counts[counts > 0]
    perm = np.argsort(codes, kind="stable")
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    first = perm[starts]
    if not (first[1:] > first[:-1]).all():
        # Relabel to first-occurrence order (pd.factorize already provides
        # it; arbitrary codings are normalized here).
        order = np.argsort(first, kind="stable")
        rank = np.empty(u, dtype=np.int64)
        rank[order] = np.arange(u)
        return _group_positions(rank[codes])
    return codes, first.astype(np.int32), perm, starts, counts


def _expand_dedup(
    pairs_u: MatchPairs,
    codes_l: np.ndarray,
    perm_r: np.ndarray,
    starts_r: np.ndarray,
    counts_r: np.ndarray,
    u_left: int,
    n_left: int,
    min_similarity: float,
    max_n_eff: int,
) -> MatchPairs:
    """Expand unique-level matches back to original rows, exactly.

    Stage 1 expands each unique-level pair (g, h, s) to (g, c, s) for every
    original position c of group h; stage 2 re-selects the per-group top-n
    over the expanded columns (ties at equal similarity interleave position
    lists of different groups, so selection must run on original column
    ids); stage 3 replicates each group's selection to all of its original
    left rows (duplicates have identical candidate sets by construction).

    Exactness of stage 1's input: the unique-level driver keeps, per group,
    the top ``max_n_eff`` candidates by (similarity desc, group id asc)
    with group ids ordered by minimum position.  The k groups with the
    smallest minimum positions own the k smallest expanded columns at any
    tie (if a group owning one of the k smallest positions were outside
    the k smallest-min-position groups, at least k groups would each
    contribute a strictly smaller position -- contradiction), so the
    expanded top ``max_n_eff`` is covered.

    The native two-pass kernel (exact_scorer.cpp ``expand_dedup_phase1/2``)
    computes the identical output with no materialized expansion -- a
    group's position list is already column-ascending, so only equal-
    similarity runs gather + sort; the numpy chain below remains the
    oracle (tests/test_dedup_collapse.py fuzzes them against each other).
    """
    if not len(pairs_u.rows):
        # Zero qualifying pairs at the unique level (e.g. a cross-join
        # above every similarity): the repeat-chain below builds a
        # length-1 `cum` against a length-0 `cnt` and raises.
        z = np.zeros(0, dtype=np.int64)
        return MatchPairs(rows=z, cols=z, sims=np.zeros(0),
                          true_max_n_matches=0)
    from ..native import get_scorer_lib

    lib = get_scorer_lib()
    if (
        lib is not None
        and hasattr(lib, "expand_dedup_phase1")
        and len(pairs_u.rows)
    ):
        rows_c = np.ascontiguousarray(pairs_u.rows, dtype=np.int64)
        cols_c = np.ascontiguousarray(pairs_u.cols, dtype=np.int64)
        sims_c = np.ascontiguousarray(pairs_u.sims, dtype=np.float64)
        codes_c = np.ascontiguousarray(codes_l, dtype=np.int64)
        perm_c = np.ascontiguousarray(perm_r, dtype=np.int64)
        starts_c = np.ascontiguousarray(starts_r, dtype=np.int64)
        counts_c = np.ascontiguousarray(counts_r, dtype=np.int64)
        tm = np.zeros(1, dtype=np.int64)
        # The two native calls share process-global scratch and ctypes
        # releases the GIL: serialize the phase1->phase2 window against
        # concurrent fits on other threads.
        with _EXPAND_LOCK:
            total = lib.expand_dedup_phase1(
                rows_c, cols_c, sims_c, len(rows_c),
                perm_c, starts_c, counts_c, u_left,
                codes_c, n_left, float(min_similarity), max_n_eff, tm,
            )
            out_r = np.empty(total, dtype=np.int64)
            out_c = np.empty(total, dtype=np.int64)
            out_s = np.empty(total, dtype=np.float64)
            lib.expand_dedup_phase2(codes_c, n_left, out_r, out_c, out_s)
        return MatchPairs(
            rows=out_r, cols=out_c, sims=out_s,
            true_max_n_matches=int(tm[0]),
        )
    hu = pairs_u.cols
    cnt = counts_r[hu]
    tot = int(cnt.sum())
    rows_e = np.repeat(pairs_u.rows, cnt)
    sims_e = np.repeat(pairs_u.sims, cnt)
    base = np.repeat(starts_r[hu], cnt)
    cum = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    within = np.arange(tot, dtype=np.int64) - np.repeat(cum, cnt)
    cols_e = perm_r[base + within]
    r2, c2, s2, _, _ = _select_topn(
        rows_e, cols_e, sims_e, u_left, min_similarity, max_n_eff
    )
    sel_cnt = np.bincount(r2, minlength=u_left)
    sel_starts = np.concatenate(([0], np.cumsum(sel_cnt)[:-1]))
    rep = sel_cnt[codes_l]
    tot2 = int(rep.sum())
    rows_f = np.repeat(np.arange(n_left, dtype=np.int64), rep)
    base2 = np.repeat(sel_starts[codes_l], rep)
    cum2 = np.concatenate(([0], np.cumsum(rep)[:-1]))
    within2 = np.arange(tot2, dtype=np.int64) - np.repeat(cum2, rep)
    cols_f = c2[base2 + within2]
    sims_f = s2[base2 + within2]
    if len(rows_f):
        true_max = int(np.bincount(rows_f, minlength=n_left).max())
    else:
        true_max = 0
    return MatchPairs(
        rows=rows_f, cols=cols_f, sims=sims_f, true_max_n_matches=true_max
    )


def duplicate_codes(series, ell: EllMatrix):
    """Duplicate coding for the collapse layer: ``None`` when the byte
    payload's clean-equality hashes are present (``match_with_collapse``
    derives a strictly coarser coding from them itself), else a raw
    factorize of the strings."""
    import pandas as pd

    src = getattr(ell, "device_src", None)
    if src is not None and src.row_hash is not None:
        return None
    return pd.factorize(pd.Series(series))[0]


def _side_groups(m: EllMatrix, codes: Optional[np.ndarray], stats: dict):
    """One list's duplicate grouping in ``_group_positions``' form: its
    payload's clean-equality grouping where it has one (counting the rows
    in ``stats["collapse_native_rows"]`` when the native pass made it),
    else the caller's coding's; None without either, or for a coding of
    another length than the list."""
    src = getattr(m, "device_src", None) if device_encode_enabled() else None
    groups, native = _clean_codes(src) if src is not None else (None, False)
    if groups is not None:
        if native:
            stats["collapse_native_rows"] += m.n_rows
    elif codes is not None:
        groups = _group_positions(codes)
    if groups is None or len(groups[0]) != m.n_rows:
        return None
    return groups


def match_with_collapse(
    left: EllMatrix,
    right_m: EllMatrix,
    is_self: bool,
    min_similarity: float,
    max_n: int,
    score_dtype,
    left_codes: Optional[np.ndarray],
    right_codes: Optional[np.ndarray],
    phase1_factory,
) -> MatchPairs:
    """Driver of the duplicate-collapse layer.

    ``phase1_factory(left_sel, right_sel)`` builds the phase-1 closures for
    the (possibly row-selected) matrices and returns
    ``(run, run_rows, c_cap, tile)``.

    When the byte-level payload is present (and ``SG_TPU_DEVICE_ENCODE`` is
    not 0), its per-row hashes provide a (strictly coarser, byte-verified)
    duplicate coding by CLEANED content, superseding any raw-equality coding
    the caller passed; with the native library loaded one native pass
    groups it (``_clean_codes``), and ``stats["collapse_native_rows"]``
    counts the rows it grouped, both lists together.  With an effective
    coding that actually collapses something, the scan runs over unique
    rows and the result expands back exactly (``_expand_dedup``);
    otherwise the plain whole-corpus pass runs.
    """
    if left.n_rows == 0 or right_m.n_rows == 0:
        # Engine callers never get here (the encoder raises sklearn's
        # "empty vocabulary" on an empty corpus, reference behavior);
        # direct callers get an empty matches list.
        z = np.zeros(0, dtype=np.int64)
        return MatchPairs(rows=z, cols=z, sims=np.zeros(0),
                          true_max_n_matches=0, stats={})
    stats: dict = {"collapse_native_rows": 0}
    with span("match.collapse", stats, "collapse"):
        groups_l = _side_groups(left, left_codes, stats)
        groups_r = groups_l if is_self else (
            _side_groups(right_m, right_codes, stats)
            if groups_l is not None else None
        )
        dedup = groups_r is not None
        if dedup:
            codes_l, first_l = groups_l[:2]
            _, first_r, perm_r, starts_r, counts_r = groups_r
            u_left, u_right = len(first_l), len(first_r)
            # Only pay the expansion machinery when something actually
            # collapses.
            dedup = u_left < left.n_rows or u_right < right_m.n_rows

    if not dedup:
        with span("match.p1_setup", stats, "p1_setup"):
            run, run_rows, c_cap, tile = phase1_factory(None, None)
        c0 = initial_cand_c(min_similarity, max_n, right_m.n_rows, c_cap)
        kt0 = initial_k_tile(min_similarity, tile, c0)
        pairs = adaptive_topn(
            run, left, right_m, min_similarity, max_n,
            c_cap=c_cap, kt_cap=tile, c0=c0, kt0=kt0,
            phase1_run_rows=run_rows, score_dtype=score_dtype,
            stats=stats,
        )
        pairs.stats = stats
        _publish_stats(stats)
        return pairs
    with span("match.p1_setup", stats, "p1_setup"):
        run, run_rows, c_cap, tile = phase1_factory(first_l, first_r)
    c0 = initial_cand_c(min_similarity, max_n, u_right, c_cap)
    kt0 = initial_k_tile(min_similarity, tile, c0)
    pairs_u = adaptive_topn(
        run, left, right_m, min_similarity, max_n,
        c_cap=c_cap, kt_cap=tile, c0=c0, kt0=kt0,
        phase1_run_rows=run_rows, score_dtype=score_dtype, stats=stats,
        left_map=first_l.astype(np.int64),
        right_map=first_r.astype(np.int64),
        n_left=u_left, n_right=u_right,
    )
    min_sim_sel = (
        float(np.float32(min_similarity))
        if np.dtype(score_dtype) == np.float32
        else min_similarity
    )
    with span("match.expand", stats, "expand"):
        pairs = _expand_dedup(
            pairs_u, codes_l, perm_r, starts_r, counts_r,
            u_left, left.n_rows, min_sim_sel,
            min(max_n, right_m.n_rows),
        )
    pairs.stats = stats
    _publish_stats(stats)
    return pairs


def topn_cosine_matches(
    left: EllMatrix,
    right: Optional[EllMatrix],
    min_similarity: float,
    max_n_matches: Optional[int],
    *,
    force_symmetries: bool = True,
    hash_dim: int = 512,
    topn_slack: int = 8,  # legacy knob; selection is now always complete
    left_chunk: int = 4096,
    right_tile: int = 4096,
    score_dtype=np.float64,
    left_codes: Optional[np.ndarray] = None,
    right_codes: Optional[np.ndarray] = None,
    device="cuda",
) -> MatchPairs:
    """Full matcher: returns the reference-equivalent matches list.
    ``device`` is where phase 1 runs: ``"cuda"`` (default; raises without a
    GPU) or ``"cpu"``.

    ``right=None`` means self-join (reference: duplicate_matrix = master
    matrix, string_grouper.py:693-695).

    ``left_codes`` / ``right_codes`` enable the duplicate-collapse layer:
    a group coding of exactly-equal input strings (e.g. ``pd.factorize``).
    Identical strings have identical TF-IDF rows, hence identical
    similarities to everything -- so the device scan, downloads, and exact
    rescore all run over UNIQUE rows only, and the results expand back to
    original rows on the host (``_expand_dedup``, with the tie-break
    argument in its docstring).  When the encoder attached a byte-level
    payload, clean-equality codes are derived automatically (see
    ``match_with_collapse``).  Output is bitwise-identical to the
    uncollapsed path; tie-heavy corpora (clusters of equal strings) shrink
    from O(cluster^2) shipped candidates to O(unique^2).
    """
    del topn_slack
    device = resolve_device(device)
    is_self = right is None
    right_m = left if is_self else right
    # Equalize ELL widths so host scoring sees consistent padding
    # (multiple of 8 for shape bucketing; pow2 would waste upload bytes).
    width = -(-max(left.width, right_m.width, 8) // 8) * 8
    left = _pad_width(left, width)
    right_m = left if is_self else _pad_width(right_m, width)
    max_n = right_m.n_rows if max_n_matches is None else max_n_matches

    pairs = match_with_collapse(
        left, right_m, is_self, min_similarity, max_n, score_dtype,
        left_codes, right_codes,
        lambda ls, rs: _phase1_single(
            left, right_m, is_self, hash_dim, left_chunk, right_tile, device,
            left_sel=ls, right_sel=rs,
        ),
    )
    stats = pairs.stats
    with span("match.fixups", stats, "fixups"):
        if is_self and force_symmetries:
            fixed = apply_self_join_fixups(pairs, left.n_rows)
        else:
            fixed = order_like_reference_csr(pairs)
    if stats is not None:
        fixed.stats = stats
    return fixed
