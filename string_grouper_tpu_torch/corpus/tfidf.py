"""Exact TF-IDF encoding into an ELL (padded sparse-row) layout.

Reproduces sklearn's ``TfidfVectorizer(min_df=1, analyzer=n_grams, dtype=...)``
semantics used by the reference (reference: string_grouper/string_grouper.py
:305-308 and :685-707):

  * vocabulary: sorted unique n-grams of the fit corpus
  * term frequency: raw counts
  * idf: smooth -- ``ln((1 + n_docs) / (1 + df)) + 1``
  * row normalization: L2

Values are computed in float64 on the host (matching the reference's default
``tfidf_matrix_dtype=np.float64``, string_grouper.py:18).  The ELL layout
(`ids` padded with -1, `vals` padded with 0, term ids ascending per row) is
the device-friendly equivalent of the reference's CSR matrices: fixed-width
rows map directly onto device tiles, and the ascending-id invariant enables the
exact merge-rescore kernels.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from ..config import DEFAULT_REGEX, StringGrouperConfig
from ..native import get_scorer_lib
from .ngrams import extract_packed_keys, extract_windows, windows_as_sortable_keys
from .preprocess import _DEFAULT_STRIP_BYTES, clean_corpus


@dataclass(frozen=True)
class DeviceEncodeSrc:
    """Wire-minimal device-encode payload: the corpus as cleaned per-row
    compact character codes, plus everything the device needs to rebuild
    the hashed TF-IDF projection itself (ops/matcher.py
    ``_device_hash_codes``): ``h[i, b] = inv_norm[i] * sum_p idf[term(key_p)]``
    over n-gram windows ``p`` -- mathematically the same projection as the
    packed-slot upload, at ~1 byte per character instead of 4 bytes per
    nonzero.  Produced by the native encoder (exact_scorer.cpp
    ``encode_get_clean``/``encode_row_norms``); the exact ELL values stay on
    host for the fp64 rescore.
    """

    flat_codes: np.ndarray  # uint8[total]: cleaned chars as codes 1..base-1
    coff: np.ndarray  # int64[n + 1] row offsets into flat_codes
    inv_norm: np.ndarray  # float32[n] inverse L2 norms (0 for empty rows)
    table_id: np.ndarray  # int32[base**ngram]: compact key -> term id, -1 OOV
    idf32: np.ndarray  # float32[n_terms]
    base: int  # code alphabet size + 1 (0 reserved for pad/unknown)
    ngram: int
    #: FNV-1a of each row's cleaned bytes -- feeds clean-equality duplicate
    #: grouping (equal cleaned content => identical TF-IDF row); groups are
    #: byte-verified before use, so collisions are harmless.
    row_hash: Optional[np.ndarray] = None  # uint64[n]

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.coff).astype(np.int64)

    def slice_rows(self, lo: int, hi: int) -> "DeviceEncodeSrc":
        off = self.coff[lo:hi + 1]
        return DeviceEncodeSrc(
            flat_codes=self.flat_codes[off[0]:off[-1]],
            coff=np.ascontiguousarray(off - off[0]),
            inv_norm=self.inv_norm[lo:hi],
            table_id=self.table_id,
            idf32=self.idf32,
            base=self.base,
            ngram=self.ngram,
            row_hash=(
                self.row_hash[lo:hi] if self.row_hash is not None else None
            ),
        )

    def take_rows(self, rows: np.ndarray) -> "DeviceEncodeSrc":
        """Arbitrary row subset (duplicate-collapse layer: upload only the
        unique rows' bytes).  Native one-memcpy-per-row gather; the numpy
        fallback's repeat/arange index build is payload-sized."""
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        lens = self.coff[rows + 1] - self.coff[rows]
        coff = np.concatenate(([0], np.cumsum(lens)))
        total = int(coff[-1])
        lib = get_scorer_lib()
        if lib is not None and hasattr(lib, "gather_rows_u8"):
            flat = np.empty(total, dtype=np.uint8)
            lib.gather_rows_u8(
                np.ascontiguousarray(self.flat_codes),
                np.ascontiguousarray(self.coff),
                rows, len(rows), np.ascontiguousarray(coff), flat,
            )
        else:
            idx = (
                np.repeat(self.coff[rows], lens)
                + np.arange(total, dtype=np.int64)
                - np.repeat(coff[:-1], lens)
            )
            flat = self.flat_codes[idx]
        return DeviceEncodeSrc(
            flat_codes=flat,
            coff=coff,
            inv_norm=self.inv_norm[rows],
            table_id=self.table_id,
            idf32=self.idf32,
            base=self.base,
            ngram=self.ngram,
            row_hash=(
                self.row_hash[rows] if self.row_hash is not None else None
            ),
        )


class _DeferredFill:
    """A background fill of preallocated arrays (the native encoder's
    phase 2): the ctypes call releases the GIL, so the ELL value fill runs
    on a worker thread while the caller ships the (already complete)
    byte-level payload to the device and starts the phase-1 scan.  ``join``
    re-raises any worker exception."""

    def __init__(self, fn):
        self._exc: Optional[BaseException] = None

        def run():
            try:
                fn()
            except BaseException as e:  # re-raised at join
                self._exc = e

        self._t = threading.Thread(
            target=run, name="sg-torch-encode-phase2", daemon=True
        )
        self._t.start()

    def join(self):
        self._t.join()
        if self._exc is not None:
            # Stay poisoned: sibling matrices share this handle, and a
            # cleared exception would let a second wait_ready() hand out
            # the uninitialized np.empty arrays as if the fill succeeded.
            raise self._exc


#: The most recent deferred phase-2 fill: the native encoder keeps
#: per-process scratch state, so the next encode call must join it first.
_PENDING_FILL: Optional[_DeferredFill] = None


def _join_pending_fill():
    global _PENDING_FILL
    p = _PENDING_FILL
    if p is not None:
        _PENDING_FILL = None
        p.join()


@dataclass(frozen=True)
class EllMatrix:
    """Padded sparse-row TF-IDF matrix.

    ``ids[i, k]`` is the k-th (ascending) vocabulary index present in row i,
    or -1 for padding; ``vals64[i, k]`` the corresponding L2-normalized
    float64 TF-IDF value (0 for padding).  ``device_src``, when present,
    carries the byte-level payload from which the device rebuilds the hashed
    projection without uploading the matrix (DeviceEncodeSrc).

    ``pending`` marks a matrix whose ids/vals64 are still being filled by a
    background thread (native encode phase 2 overlapping the device scan);
    every host reader must call :meth:`wait_ready` first.  Shape/width
    queries are always safe (arrays are preallocated).
    """

    ids: np.ndarray  # int32[n, L]
    vals64: np.ndarray  # float64[n, L]
    n_terms: int  # vocabulary size
    device_src: Optional[DeviceEncodeSrc] = None
    pending: Optional[_DeferredFill] = field(
        default=None, compare=False, repr=False
    )

    def wait_ready(self) -> "EllMatrix":
        """Block until ids/vals64 are fully materialized (no-op normally)."""
        if self.pending is not None:
            self.pending.join()
            object.__setattr__(self, "pending", None)
        return self

    @property
    def n_rows(self) -> int:
        return self.ids.shape[0]

    @property
    def width(self) -> int:
        return self.ids.shape[1]

    def nnz_per_row(self) -> np.ndarray:
        self.wait_ready()
        return (self.ids >= 0).sum(axis=1)

    def to_dense(self) -> np.ndarray:
        """Dense (n_rows, n_terms) float64 matrix -- for conformance tests."""
        self.wait_ready()
        out = np.zeros((self.n_rows, self.n_terms), dtype=np.float64)
        r, k = np.nonzero(self.ids >= 0)
        out[r, self.ids[r, k]] = self.vals64[r, k]
        return out

    def row_dot(self, other: "EllMatrix") -> np.ndarray:
        """Row-wise sparse dot in float64 (reference ``dot()``,
        string_grouper.py:433-440).  Summation runs in ascending-term order,
        matching CSR elementwise-multiply row sums."""
        assert self.n_rows == other.n_rows
        self.wait_ready()
        other.wait_ready()
        out = np.empty(self.n_rows, dtype=np.float64)
        # Merge per row: both id lists ascending.  Vectorized by comparing
        # every slot of self against other's slots; L (max distinct n-grams
        # per string) is small, so L^2 per row is cheap -- but the (n, L, L)
        # comparison cube is not, so process row BLOCKS to bound peak
        # memory (at 663k x L=64 the whole-corpus cube would be ~20 GB).
        blk = max(1, (1 << 24) // max(1, self.width * other.width))
        for lo in range(0, self.n_rows, blk):
            hi = min(self.n_rows, lo + blk)
            a_ids, b_ids = self.ids[lo:hi], other.ids[lo:hi]
            a_vals, b_vals = self.vals64[lo:hi], other.vals64[lo:hi]
            eq = (
                (a_ids[:, :, None] == b_ids[:, None, :])
                & (a_ids[:, :, None] >= 0)
            )
            out[lo:hi] = np.einsum(
                "nk,nkl,nl->n", a_vals, eq.astype(np.float64), b_vals
            )
        return out


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def device_tables_from_vocab(
    vocab_keys: np.ndarray, idf: np.ndarray, ngram: int
):
    """(code_lut, table_id, idf32, base) for DeviceEncodeSrc, derived from
    an 8-bit-packed sorted vocabulary: bytes appearing in vocabulary keys
    get compact codes 1..base-1 (0 = pad / byte unseen at fit time), and
    the direct-address table maps each vocabulary n-gram's base-`base`
    compact key to its term id.  Any window touching a 0 code has a zero
    base-`base` digit, so it can never alias a vocabulary key (whose digits
    are all >= 1) -- it reads -1 (OOV) from the table.  Pure function of
    (vocab, idf, ngram)."""
    ks = vocab_keys.astype(np.uint64)
    cols = [
        ((ks >> np.uint64(8 * (ngram - 1 - j))) & np.uint64(0xFF)).astype(
            np.int64
        )
        for j in range(ngram)
    ]
    present = np.zeros(256, dtype=bool)
    for c in cols:
        present[c] = True
    code_lut = np.zeros(256, dtype=np.uint8)
    code_lut[present] = np.arange(1, int(present.sum()) + 1, dtype=np.uint8)
    base = int(present.sum()) + 1
    key = np.zeros(len(ks), dtype=np.int64)
    for c in cols:
        key = key * base + code_lut[c].astype(np.int64)
    table = np.full(base**ngram, -1, dtype=np.int32)
    table[key] = np.arange(len(ks), dtype=np.int32)
    idf32 = np.ascontiguousarray(idf, dtype=np.float32)
    return code_lut, table, idf32, base


_EMPTY_VOCAB_MSG = (
    "empty vocabulary; perhaps the documents only contain stop "
    "characters or are shorter than the n-gram size"
)

# The native per-row insertion buffers are sized for strings up to this many
# characters; longer rows route to the numpy path.
_NATIVE_MAX_ROW = 4096


def _native_luts(config: StringGrouperConfig, prefolded: bool = False):
    """(keep, map) byte LUTs of the default-regex ASCII cleanup.
    ``prefolded`` input was already lowercased on the host (unicode fold
    path), so the LUT must not lowercase again (it would be a no-op anyway,
    but identity keeps the contract explicit)."""
    keep = np.ones(256, dtype=np.uint8)
    keep[list(_DEFAULT_STRIP_BYTES)] = 0
    lut = np.arange(256, dtype=np.uint8)
    if config.ignore_case and not prefolded:
        upper = np.arange(65, 91)
        lut[upper] = upper + 32
    return keep, lut


def _native_raw_arrow(series) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Zero-copy raw bytes + offsets straight from a pandas Arrow-backed
    string Series (pandas >= 3 default ``str`` dtype): the Arrow layout IS
    the flat-UTF-8-buffer + offsets form the native encoder consumes, so
    the per-string python materialization and the corpus-sized ``join``
    both disappear."""
    arr = getattr(series, "array", None)
    pa_arr = getattr(arr, "_pa_array", None)
    if pa_arr is None:
        return None
    try:
        import pyarrow as pa
    except ImportError:  # pragma: no cover
        return None
    combined = pa_arr.combine_chunks()
    if combined.null_count:
        return None
    if pa.types.is_string(combined.type):
        off_dtype = np.int32
    elif pa.types.is_large_string(combined.type):
        off_dtype = np.int64
    else:
        return None
    bufs = combined.buffers()
    if len(bufs) < 3 or bufs[1] is None:
        return None
    n = len(combined)
    offsets = np.frombuffer(bufs[1], dtype=off_dtype)[
        combined.offset : combined.offset + n + 1
    ].astype(np.int64)
    data = np.frombuffer(bufs[2], dtype=np.uint8) if bufs[2] is not None \
        else np.zeros(0, np.uint8)
    raw = np.ascontiguousarray(data[offsets[0] : offsets[-1]])
    roff = offsets - offsets[0]
    if len(raw) and int(raw.max()) > 127:  # non-ASCII byte present
        return None
    if n and int(np.diff(roff).max(initial=0)) > _NATIVE_MAX_ROW:
        return None
    return raw, roff


def _native_raw(
    strings, config: Optional[StringGrouperConfig] = None
) -> Optional[Tuple[np.ndarray, np.ndarray, bool]]:
    """Raw ASCII byte buffer + row offsets (+ a ``prefolded`` flag), or None
    when ineligible.

    Non-ASCII input with ``normalize_to_ascii`` (the default) is PRE-FOLDED
    here in the reference's exact operation order (lower -> NFKD -> ASCII-
    ignore, reference string_grouper.py:365-378) so a single accented
    character no longer disqualifies the whole corpus from the native
    encoder + device payload; the native byte LUTs then skip lowercasing
    (``prefolded=True``) and only strip."""
    if isinstance(strings, pd.Series):
        rr = _native_raw_arrow(strings)
        if rr is not None:
            return rr + (False,)
        strings = list(strings)
    joined = "".join(strings)
    if joined.isascii():
        lengths = np.fromiter(
            (len(s) for s in strings), dtype=np.int64, count=len(strings)
        )
        if len(lengths) and int(lengths.max()) > _NATIVE_MAX_ROW:
            return None
        raw = np.frombuffer(joined.encode("ascii"), dtype=np.uint8)
        roff = np.concatenate(([0], np.cumsum(lengths)))
        return raw, roff, False
    if config is None or not config.normalize_to_ascii:
        return None
    from unicodedata import normalize as _nfkd

    lower = config.ignore_case
    parts = [
        _nfkd("NFKD", s.lower() if lower else s).encode("ascii", "ignore")
        for s in strings
    ]
    lengths = np.fromiter((len(b) for b in parts), dtype=np.int64,
                          count=len(parts))
    if len(lengths) and int(lengths.max()) > _NATIVE_MAX_ROW:
        return None
    raw = np.frombuffer(b"".join(parts), dtype=np.uint8)
    roff = np.concatenate(([0], np.cumsum(lengths)))
    return raw, roff, True


def _native_eligible(config: StringGrouperConfig):
    """The native encoder covers the default-regex, float64, ngram<=3 ASCII
    case -- i.e. the reference's default configuration (reference
    string_grouper.py:17-19).  Everything else uses the numpy path, which is
    also the bitwise oracle (tests/test_native_encode.py)."""
    if config.regex != DEFAULT_REGEX:
        return None
    if config.tfidf_matrix_dtype == np.float32:
        return None
    if not (1 <= config.ngram_size <= 3):
        return None
    lib = get_scorer_lib()
    if lib is None or not hasattr(lib, "encode_fit_phase1"):
        return None
    return lib


def f32_idf(df: np.ndarray, n_docs: int) -> np.ndarray:
    """sklearn's float32 smooth-IDF chain, rounding at every step
    (TfidfTransformer.fit casts df to the matrix dtype, then /=, log, +=
    all in float32), op for op as the JAX package's encoder runs it."""
    df32 = df.astype(np.float32) + np.float32(1.0)
    idf = np.full_like(df32, n_docs + 1, dtype=np.float32)
    idf /= df32
    np.log(idf, out=idf)
    idf += np.float32(1.0)
    return idf


def f32_row_values(
    rows: np.ndarray,
    terms: np.ndarray,
    tf: np.ndarray,
    idf32: np.ndarray,
    n_rows: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn's float32 value chain (shared across tiers like
    :func:`f32_idf`): tf*idf as f32*f32, squares in f32 with sequential
    float64 accumulation (inplace_csr_row_normalize_l2's double sum_),
    then the f32/f64 division rounded back to f32.  Returns ``(vals
    float64-promoted, inv_norm float64)``; the chain is row-local, so
    shard blocks concatenate bitwise equal to a full encode."""
    w = tf.astype(np.float32) * idf32[terms]
    norm_sq = np.bincount(rows, weights=w * w, minlength=n_rows)
    norm = np.sqrt(norm_sq)
    safe = np.where(norm > 0, norm, 1.0)
    vals = (w / safe[rows]).astype(np.float32).astype(np.float64)
    inv = np.zeros(n_rows, dtype=np.float64)
    nz = norm > 0
    inv[nz] = 1.0 / norm[nz]
    return vals, inv


def _ell_from_unique_pairs(
    rows: np.ndarray,
    terms: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_terms: int,
    width: Optional[int] = None,
) -> EllMatrix:
    """Pack (row, term, value) triples -- sorted by (row, term) -- into ELL."""
    counts = np.bincount(rows, minlength=n_rows)
    if width is None:
        width = max(8, _round_up(int(counts.max(initial=0)), 8))
    ids = np.full((n_rows, width), -1, dtype=np.int32)
    vals64 = np.zeros((n_rows, width), dtype=np.float64)
    starts = np.concatenate(([0], np.cumsum(counts)))
    pos = np.arange(len(rows), dtype=np.int64) - starts[rows]
    ids[rows, pos] = terms.astype(np.int32)
    vals64[rows, pos] = vals
    return EllMatrix(ids=ids, vals64=vals64, n_terms=n_terms)


class TfidfEncoder:
    """sklearn-parity TF-IDF vectorizer over char n-grams.

    Plays the role of the reference's ``TfidfVectorizer`` wiring
    (string_grouper.py:305-308, :685-707): ``fit`` learns the vocabulary and
    IDF from a corpus; ``transform`` encodes any string sequence against it.
    """

    def __init__(self, config: StringGrouperConfig):
        self.config = config
        # Sorted vocabulary keys: uint64 packed n-grams on the fast path
        # (_packed_bits set), void byte-keys on the fallback path.
        self.vocab_keys_: Optional[np.ndarray] = None
        self._packed_bits: Optional[int] = None
        self.idf_: Optional[np.ndarray] = None  # float64[U]
        self.n_docs_: int = 0
        # Device-encode tables (code LUT, key->term table, idf32, base),
        # derived from the fitted vocabulary; see DeviceEncodeSrc.
        self._dev_tables = None

    @property
    def vocabulary_size(self) -> int:
        return 0 if self.vocab_keys_ is None else len(self.vocab_keys_)

    def vocabulary_terms(self) -> list:
        """Vocabulary n-grams as strings, in term-id (sorted) order --
        sklearn ``get_feature_names_out`` parity."""
        if self.vocab_keys_ is None:
            return []
        k = self.config.ngram_size
        if self._packed_bits is not None:
            bits = self._packed_bits
            mask = (1 << bits) - 1
            out = []
            for key in self.vocab_keys_.tolist():
                cps = [(key >> (bits * (k - 1 - j))) & mask for j in range(k)]
                out.append("".join(chr(c) for c in cps))
            return out
        return [
            "".join(chr(c) for c in np.frombuffer(bytes(key), dtype=">u4"))
            for key in self.vocab_keys_
        ]

    def fit(self, strings: Sequence[str]) -> "TfidfEncoder":
        self.fit_transform(strings)
        return self

    def _corpus_keys(self, corpus, bits: Optional[int]):
        """(keys, row_ids, n_rows, bits|None): packed uint64 fast path, or
        void byte-keys (bits None) when n-grams don't fit in 64 bits."""
        packed = extract_packed_keys(corpus, self.config.ngram_size, bits)
        if packed is not None:
            return packed
        win = extract_windows(corpus, self.config.ngram_size)
        return (
            windows_as_sortable_keys(win.windows),
            win.row_ids,
            win.n_rows,
            None,
        )

    def _native_fit_transform(self, strings: list) -> Optional[EllMatrix]:
        lib = _native_eligible(self.config)
        if lib is None:
            return None
        rr = _native_raw(strings, self.config)
        if rr is None:
            return None
        _join_pending_fill()
        raw, roff, prefolded = rr
        keep, lut = _native_luts(self.config, prefolded)
        n_rows = len(strings)
        info = np.zeros(3, dtype=np.int64)
        lib.encode_fit_phase1(
            raw, roff, n_rows, keep, lut, self.config.ngram_size, info
        )
        vocab_n, max_w = int(info[0]), int(info[1])
        if vocab_n == 0:
            raise ValueError(_EMPTY_VOCAB_MSG)
        keys32 = np.empty(vocab_n, dtype=np.uint32)
        df = np.empty(vocab_n, dtype=np.int32)
        lib.encode_get_vocab_df(keys32, df)
        self.vocab_keys_ = keys32.astype(np.uint64)
        self._packed_bits = 8
        self._dev_tables = None
        self.n_docs_ = n_rows
        self.idf_ = np.log((1.0 + n_rows) / (1.0 + df)) + 1.0
        src = self._device_payload(lib, n_rows)
        ell = self._native_phase2(lib, n_rows, max_w, vocab_n)
        return replace(ell, device_src=src)

    def _native_transform(self, strings: list) -> Optional[EllMatrix]:
        if self._packed_bits != 8:
            return None
        lib = _native_eligible(self.config)
        if lib is None:
            return None
        rr = _native_raw(strings, self.config)
        if rr is None:
            return None
        _join_pending_fill()
        raw, roff, prefolded = rr
        keep, lut = _native_luts(self.config, prefolded)
        n_rows = len(strings)
        keys32 = np.ascontiguousarray(self.vocab_keys_.astype(np.uint32))
        info = np.zeros(3, dtype=np.int64)
        lib.encode_transform_phase1(
            raw, roff, n_rows, keep, lut, self.config.ngram_size,
            keys32, len(keys32), info,
        )
        src = self._device_payload(lib, n_rows)
        ell = self._native_phase2(lib, n_rows, int(info[1]), len(keys32))
        return replace(ell, device_src=src)

    def _native_phase2(
        self, lib, n_rows: int, max_w: int, n_terms: int
    ) -> EllMatrix:
        """ELL value fill, DEFERRED to a worker thread: the caller gets a
        ``pending`` matrix (preallocated arrays) immediately, so the device
        payload upload + phase-1 scan start without waiting for the
        corpus-sized fill -- which is also the most page-fault-sensitive
        host stage (docs/performance.md "memory weather").  Every host
        reader of ids/vals64 joins via ``EllMatrix.wait_ready``; the next
        native encode call joins via ``_join_pending_fill`` (the native
        scratch state is per-process)."""
        global _PENDING_FILL
        width = max(8, _round_up(max_w, 8))
        ids = np.empty((n_rows, width), dtype=np.int32)
        vals = np.empty((n_rows, width), dtype=np.float64)
        idf = np.ascontiguousarray(self.idf_)

        def fill():
            lib.encode_phase2(idf, width, ids, vals)

        pending = _DeferredFill(fill)
        _PENDING_FILL = pending
        return EllMatrix(
            ids=ids, vals64=vals, n_terms=n_terms, pending=pending
        )

    def _device_tables(self):
        if self._dev_tables is None:
            self._dev_tables = device_tables_from_vocab(
                self.vocab_keys_, self.idf_, self.config.ngram_size
            )
        return self._dev_tables

    def _device_payload(self, lib, n_rows: int) -> Optional[DeviceEncodeSrc]:
        """Materialize the device-encode payload for the rows of the encode
        call that just ran (the native scratch state is per-process and the
        next encode overwrites it, so this copies eagerly)."""
        total = int(lib.encode_clean_total())
        flat = np.empty(total, dtype=np.uint8)
        coff = np.empty(n_rows + 1, dtype=np.int64)
        lib.encode_get_clean(flat, coff)
        inv = np.empty(n_rows, dtype=np.float32)
        lib.encode_row_norms(np.ascontiguousarray(self.idf_), inv)
        hashes = np.empty(n_rows, dtype=np.uint64)
        lib.encode_row_hashes(hashes)
        code_lut, table, idf32, base = self._device_tables()
        return DeviceEncodeSrc(
            flat_codes=code_lut[flat],
            coff=coff,
            inv_norm=inv,
            table_id=table,
            idf32=idf32,
            base=base,
            ngram=self.config.ngram_size,
            row_hash=hashes,
        )

    def fit_transform(
        self, strings: Sequence[str], *, defer_fill: bool = False
    ) -> EllMatrix:
        """Fit + encode.  ``defer_fill`` (engine path) returns immediately
        with the native value fill still running on a worker thread (the
        matrix carries the join handle); the default joins, so direct
        callers always see materialized arrays."""
        if not isinstance(strings, pd.Series):
            strings = list(strings)
        native = self._native_fit_transform(strings)
        if native is not None:
            return native if defer_fill else native.wait_ready()
        if isinstance(strings, pd.Series):
            strings = list(strings)
        corpus = clean_corpus(strings, self.config)
        keys, row_ids, n_rows, bits = self._corpus_keys(corpus, None)
        if len(keys) == 0:
            raise ValueError(
                "empty vocabulary; perhaps the documents only contain stop "
                "characters or are shorter than the n-gram size"
            )
        if bits is not None:
            # Hash-based factorization (no O(n log n) sort of all windows),
            # then sort only the (small) unique-term table; sorted uint64
            # order == sklearn's lexicographic vocabulary order.
            codes, uniques = pd.factorize(keys)
            vocab = np.sort(uniques)
            remap = np.searchsorted(vocab, uniques)
            t_idx = remap[codes]
        else:
            vocab, t_idx = np.unique(keys, return_inverse=True)
        n_terms = len(vocab)
        self.vocab_keys_ = vocab
        self._packed_bits = bits
        self.n_docs_ = n_rows
        # New vocabulary: any cached device tables belong to the PREVIOUS
        # fit's vocabulary and must not pair with this fit's idf/norms.
        self._dev_tables = None

        rows, terms, tf = _unique_row_term_counts(row_ids, t_idx, n_terms)
        df = np.bincount(terms, minlength=n_terms)
        if self.config.tfidf_matrix_dtype == np.float32:
            self.idf_ = f32_idf(df, n_rows)
        else:
            self.idf_ = np.log((1.0 + n_rows) / (1.0 + df)) + 1.0

        return self._encode(rows, terms, tf, n_rows, n_terms)

    def transform(
        self, strings: Sequence[str], *, defer_fill: bool = False
    ) -> EllMatrix:
        if self.vocab_keys_ is None:
            raise RuntimeError("TfidfEncoder.transform called before fit")
        if not isinstance(strings, pd.Series):
            strings = list(strings)
        native = self._native_transform(strings)
        if native is not None:
            return native if defer_fill else native.wait_ready()
        if isinstance(strings, pd.Series):
            strings = list(strings)
        corpus = clean_corpus(strings, self.config)
        if self._packed_bits is not None:
            keys, row_ids, _, _ = self._corpus_keys(corpus, self._packed_bits)
        else:
            win = extract_windows(corpus, self.config.ngram_size)
            keys = windows_as_sortable_keys(win.windows)
            row_ids = win.row_ids
        n_terms = self.vocabulary_size
        if len(keys) == 0:
            return _ell_from_unique_pairs(
                np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0),
                corpus.n_rows, n_terms,
            )
        # Map windows into the fitted vocabulary; drop out-of-vocabulary
        # n-grams (sklearn transform semantics).
        t_idx = np.searchsorted(self.vocab_keys_, keys)
        t_idx_clipped = np.minimum(t_idx, n_terms - 1)
        in_vocab = self.vocab_keys_[t_idx_clipped] == keys
        rows_in = row_ids[in_vocab]
        terms_in = t_idx_clipped[in_vocab]
        rows, terms, tf = _unique_row_term_counts(rows_in, terms_in, n_terms)
        return self._encode(rows, terms, tf, corpus.n_rows, n_terms)

    def fit_transform_pair(
        self,
        master: Sequence[str],
        duplicates: Optional[Sequence[str]],
        *,
        defer_fill: bool = False,
    ) -> Tuple[EllMatrix, EllMatrix]:
        """Fit on concat(master, duplicates) and encode both sides.

        Mirrors reference ``_fit_vectorizer`` + ``_get_tf_idf_matrices``
        (string_grouper.py:685-707): one shared vocabulary/IDF, fit on the
        concatenation, each side transformed separately.  For a self-join the
        second return value is the first.

        ``defer_fill`` (the engine's match path) may return matrices whose
        value fill is still running on a worker thread so the device scan
        starts immediately; see :meth:`fit_transform`.
        """
        if duplicates is None:
            m = self.fit_transform(master, defer_fill=defer_fill)
            return m, m
        n_m_early = len(master)
        if isinstance(master, pd.Series) and isinstance(duplicates, pd.Series):
            both_in = pd.concat([master, duplicates], ignore_index=True)
        else:
            both_in = list(master) + list(duplicates)
        both = self.fit_transform(both_in, defer_fill=defer_fill)
        if not defer_fill:
            both.wait_ready()
        n_m = n_m_early
        src = both.device_src
        # Row-slice views share the (possibly still filling) buffers, so
        # the deferred-fill handle propagates to both sides.
        m = EllMatrix(
            ids=both.ids[:n_m], vals64=both.vals64[:n_m],
            n_terms=both.n_terms,
            device_src=src.slice_rows(0, n_m) if src is not None else None,
            pending=both.pending,
        )
        d = EllMatrix(
            ids=both.ids[n_m:], vals64=both.vals64[n_m:],
            n_terms=both.n_terms,
            device_src=(
                src.slice_rows(n_m, both.n_rows) if src is not None else None
            ),
            pending=both.pending,
        )
        return m, d

    def _encode(
        self,
        rows: np.ndarray,
        terms: np.ndarray,
        tf: np.ndarray,
        n_rows: int,
        n_terms: int,
    ) -> EllMatrix:
        if self.config.tfidf_matrix_dtype == np.float32:
            # dtype flows into the MATRIX, not just the output (reference
            # string_grouper.py:306: TfidfVectorizer(dtype=...)); rounding
            # points verified bitwise against sklearn 1.9 -- see
            # f32_row_values.
            vals, _inv = f32_row_values(
                rows, terms, tf, self.idf_.astype(np.float32), n_rows
            )
            return _ell_from_unique_pairs(rows, terms, vals, n_rows, n_terms)
        w = tf.astype(np.float64) * self.idf_[terms]
        norm_sq = np.bincount(rows, weights=w * w, minlength=n_rows)
        norm = np.sqrt(norm_sq)
        inv = np.zeros(n_rows, dtype=np.float64)
        nonzero = norm > 0
        inv[nonzero] = 1.0 / norm[nonzero]
        vals = w * inv[rows]
        return _ell_from_unique_pairs(rows, terms, vals, n_rows, n_terms)


def _unique_row_term_counts(
    row_ids: np.ndarray, t_idx: np.ndarray, n_terms: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse (row, term) occurrences into unique pairs with counts,
    sorted by (row, term)."""
    pair_keys = row_ids.astype(np.int64) * n_terms + t_idx.astype(np.int64)
    if len(pair_keys) == 0:
        # E.g. every n-gram of the transform input is out-of-vocabulary
        # (sklearn transform yields all-zero rows).
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    pair_keys.sort()
    boundary = np.empty(len(pair_keys), dtype=bool)
    boundary[0] = True
    np.not_equal(pair_keys[1:], pair_keys[:-1], out=boundary[1:])
    upairs = pair_keys[boundary]
    idx = np.flatnonzero(boundary)
    tf = np.diff(np.concatenate((idx, [len(pair_keys)])))
    rows = upairs // n_terms
    terms = upairs % n_terms
    return rows, terms, tf


def ell_from_numpy(
    ids: np.ndarray,
    vals64: np.ndarray,
    n_terms: int,
    *,
    table_id: Optional[np.ndarray] = None,
    idf32: Optional[np.ndarray] = None,
    inv_norm: Optional[np.ndarray] = None,
    flat_codes: Optional[np.ndarray] = None,
    coff: Optional[np.ndarray] = None,
    base: Optional[int] = None,
    ngram: Optional[int] = None,
    row_hash: Optional[np.ndarray] = None,
) -> EllMatrix:
    """An :class:`EllMatrix` (with its :class:`DeviceEncodeSrc` payload when
    the payload arrays are given) from plain numpy arrays -- the fitted
    corpus state of any encoder that shares this layout, e.g. the JAX
    package's ``TfidfEncoder`` output, so one encoded corpus can feed both
    matchers.  Arrays are copied into the dtypes the port uses."""
    src = None
    if flat_codes is not None:
        src = DeviceEncodeSrc(
            flat_codes=np.ascontiguousarray(flat_codes, dtype=np.uint8),
            coff=np.ascontiguousarray(coff, dtype=np.int64),
            inv_norm=np.ascontiguousarray(inv_norm, dtype=np.float32),
            table_id=np.ascontiguousarray(table_id, dtype=np.int32),
            idf32=np.ascontiguousarray(idf32, dtype=np.float32),
            base=int(base),
            ngram=int(ngram),
            row_hash=(
                None if row_hash is None
                else np.ascontiguousarray(row_hash, dtype=np.uint64)
            ),
        )
    return EllMatrix(
        ids=np.array(ids, dtype=np.int32, order="C"),
        vals64=np.array(vals64, dtype=np.float64, order="C"),
        n_terms=int(n_terms),
        device_src=src,
    )
