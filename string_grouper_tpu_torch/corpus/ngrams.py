"""Vectorized character n-gram window extraction.

Produces, for a cleaned :class:`CodepointCorpus`, the full list of n-gram
windows per row -- the same multiset of n-grams the reference analyzer emits
per string (reference: string_grouper/string_grouper.py:377-378, the
zip-shift ``zip(*[string[i:] for i in range(ngram_size)])``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .preprocess import CodepointCorpus


@dataclass(frozen=True)
class NgramWindows:
    """All n-gram occurrences of a corpus, row-major."""

    windows: np.ndarray  # uint32[total_windows, ngram_size] codepoints
    row_ids: np.ndarray  # int64[total_windows] owning row per window
    n_rows: int

    @property
    def total(self) -> int:
        return len(self.row_ids)


def extract_windows(corpus: CodepointCorpus, ngram_size: int) -> NgramWindows:
    """Slide a length-``ngram_size`` window over every row of the corpus."""
    lengths = corpus.lengths()
    wcounts = np.maximum(lengths - ngram_size + 1, 0)
    total = int(wcounts.sum())
    n_rows = corpus.n_rows
    if total == 0:
        return NgramWindows(
            windows=np.zeros((0, ngram_size), dtype=np.uint32),
            row_ids=np.zeros(0, dtype=np.int64),
            n_rows=n_rows,
        )
    row_ids = np.repeat(np.arange(n_rows, dtype=np.int64), wcounts)
    # Start position of each window in the flat buffer: per-row base offset
    # plus the within-row window index.
    wstarts_cum = np.concatenate(([0], np.cumsum(wcounts)))
    intra = np.arange(total, dtype=np.int64) - np.repeat(wstarts_cum[:-1], wcounts)
    starts = np.repeat(corpus.offsets[:-1], wcounts) + intra
    windows = corpus.buf[starts[:, None] + np.arange(ngram_size, dtype=np.int64)[None, :]]
    return NgramWindows(windows=windows, row_ids=row_ids, n_rows=n_rows)


def packed_key_bits(max_codepoint: int) -> int:
    """Bits per codepoint for order-preserving packed keys."""
    if max_codepoint < 1 << 8:
        return 8
    if max_codepoint < 1 << 16:
        return 16
    return 21  # all Unicode codepoints fit in 21 bits


def extract_packed_keys(
    corpus: CodepointCorpus, ngram_size: int, bits: int | None = None
):
    """n-gram occurrences as order-preserving uint64 keys.

    Packs each window's codepoints big-endian (first codepoint in the most
    significant bits), so for the fixed window length ``ngram_size`` the
    uint64 sort order equals Python-string lexicographic order -- i.e.
    sklearn's sorted-vocabulary order.  This avoids the (slow) void-dtype
    byte-key comparisons on multi-million-window corpora.

    If ``bits`` is given (a previously fitted packing width), windows
    containing codepoints outside that range are dropped -- they cannot be in
    the fitted vocabulary, so this matches transform's out-of-vocabulary
    filtering.  Returns ``None`` when the n-grams don't fit in 64 bits
    (caller falls back to the void-key path).
    """
    n_rows = corpus.n_rows
    buf = corpus.buf
    offsets = corpus.offsets
    total_len = len(buf)
    if bits is None:
        maxcp = int(buf.max(initial=0))
        bits = packed_key_bits(maxcp)
    if bits * ngram_size > 64:
        return None
    n_keys = total_len - ngram_size + 1
    if n_keys <= 0 or (offsets[1:] - offsets[:-1] >= ngram_size).sum() == 0:
        return (
            np.zeros(0, np.uint64),
            np.zeros(0, np.int64),
            n_rows,
            bits,
        )
    # Rows are concatenated in one flat buffer, so every n-gram window is a
    # contiguous slice of it: pack keys over the WHOLE buffer with
    # ``ngram_size`` shifted slice ops (a few linear passes over ~total_len
    # elements), then select the valid window starts by mask -- instead of
    # per-window gathers, which cost ~6x the memory traffic at tens of
    # millions of windows.
    b64 = buf.astype(np.uint64)
    shift = np.uint64(bits)
    keys_all = b64[:n_keys].copy()
    for j in range(1, ngram_size):
        keys_all <<= shift
        keys_all |= b64[j : n_keys + j]
    # A position is a valid window start unless it lies within the last
    # ngram_size-1 positions of its row (the window would cross into the
    # next row).  Rows shorter than ngram_size contribute no starts.
    mask = np.ones(total_len, dtype=bool)
    for j in range(1, ngram_size):
        p = offsets[1:] - j
        sel = p >= offsets[:-1]
        mask[p[sel]] = False
    if bits < 21:
        # Codepoints outside the fitted packing width invalidate every
        # window containing them (transform-time out-of-vocabulary drop).
        limit = np.uint64(1) << shift
        big = b64 >= limit
        if big.any():
            for j in range(ngram_size):
                # window starting at p contains position p+j; invalidate
                # every window whose j-th codepoint is out of range
                mask[: total_len - j][big[j:total_len]] = False
    starts = np.flatnonzero(mask[:n_keys])
    keys = keys_all[starts]
    row_of_pos = np.repeat(np.arange(n_rows, dtype=np.int64), corpus.lengths())
    row_ids = row_of_pos[starts]
    return keys, row_ids, n_rows, bits


def windows_as_sortable_keys(windows: np.ndarray) -> np.ndarray:
    """View (total, n) uint32 windows as opaque fixed-width byte keys.

    Big-endian per codepoint so that byte-wise (void dtype) comparison order
    equals Python string comparison order -- this makes our vocabulary sort
    order identical to sklearn's sorted-vocabulary order, which is needed for
    dense-matrix conformance against TfidfVectorizer.
    """
    n = windows.shape[1] if windows.ndim == 2 else 1
    be = np.ascontiguousarray(windows.astype(">u4"))
    return be.view(np.dtype((np.void, 4 * n))).reshape(-1)
