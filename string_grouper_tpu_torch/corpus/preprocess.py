"""Host-side string preprocessing: lowercase, NFKD->ASCII, regex strip.

Reproduces exactly the per-string preprocessing of the reference analyzer
(reference: string_grouper/string_grouper.py:365-378):

    1. if ignore_case: ``str.lower()``
    2. if normalize_to_ascii: ``normalize('NFKD', s).encode('ASCII','ignore')``
    3. ``re.sub(regex, '', s)``

The output is a flat uint32 codepoint buffer plus row offsets -- the byte/
codepoint-level representation consumed by the n-gram stage and by the device
tokenizer kernels.  A vectorized numpy fast path handles the (overwhelmingly
common) all-ASCII + default-regex case; the general path mirrors the
reference's Python semantics character-for-character.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence
from unicodedata import normalize as _unicode_normalize

import numpy as np

from ..config import StringGrouperConfig, DEFAULT_REGEX

# Characters removed by the default regex '[,-./]|\s'.  '[,-./]' is the byte
# range 44..47 (",", "-", ".", "/"); '\s' on ASCII input is " \t\n\r\f\v".
_DEFAULT_STRIP_BYTES = frozenset(
    list(range(44, 48)) + [ord(c) for c in " \t\n\r\x0b\x0c"]
)


@dataclass(frozen=True)
class CodepointCorpus:
    """Cleaned corpus as a flat codepoint buffer with row offsets."""

    buf: np.ndarray  # uint32[total_chars] cleaned codepoints
    offsets: np.ndarray  # int64[n_rows + 1]

    @property
    def n_rows(self) -> int:
        return len(self.offsets) - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)


def _ascii_fast_path_ok(config: StringGrouperConfig, joined: str) -> bool:
    return config.regex == DEFAULT_REGEX and joined.isascii()


def _clean_ascii_vectorized(
    strings: Sequence[str], config: StringGrouperConfig,
    joined: Optional[str] = None,
) -> CodepointCorpus:
    """Vectorized byte-LUT cleanup for pure-ASCII corpora with default
    regex.  ``joined`` lets the caller reuse its corpus-sized join (the
    ASCII check already built one)."""
    if joined is None:
        joined = "".join(strings)
    lengths = np.fromiter((len(s) for s in strings), dtype=np.int64, count=len(strings))
    buf = np.frombuffer(joined.encode("ascii"), dtype=np.uint8)

    # Byte LUTs: lowercase + keep-mask.
    lut = np.arange(256, dtype=np.uint8)
    if config.ignore_case:
        upper = np.arange(65, 91, dtype=np.uint8)
        lut[upper] = upper + 32
    keep = np.ones(256, dtype=bool)
    keep[list(_DEFAULT_STRIP_BYTES)] = False

    mapped = lut[buf]
    keep_mask = keep[buf]

    # Per-row kept counts -> new offsets; then compact.
    row_ends = np.cumsum(lengths)
    kept_cum = np.concatenate(([0], np.cumsum(keep_mask)))
    new_offsets = np.concatenate(([0], kept_cum[row_ends]))
    cleaned = mapped[keep_mask].astype(np.uint32)
    return CodepointCorpus(buf=cleaned, offsets=new_offsets)


def _clean_general(strings: Sequence[str], config: StringGrouperConfig) -> CodepointCorpus:
    """Per-string path mirroring reference string_grouper.py:365-378 exactly."""
    pat = re.compile(config.regex)
    cleaned: List[str] = []
    for s in strings:
        if config.ignore_case and s is not None:
            s = s.lower()
        if config.normalize_to_ascii:
            s = _unicode_normalize("NFKD", s).encode("ASCII", "ignore").decode()
        cleaned.append(pat.sub("", s))
    joined = "".join(cleaned)
    buf = np.frombuffer(joined.encode("utf-32-le"), dtype=np.uint32).copy()
    lengths = np.fromiter((len(s) for s in cleaned), dtype=np.int64, count=len(cleaned))
    offsets = np.concatenate(([0], np.cumsum(lengths)))
    return CodepointCorpus(buf=buf, offsets=offsets)


def clean_corpus(strings: Sequence[str], config: StringGrouperConfig) -> CodepointCorpus:
    """Clean a corpus of strings into a codepoint buffer.

    Equivalent to applying the reference's analyzer preprocessing
    (string_grouper.py:372-376) to every string.
    """
    strings = list(strings)
    if not strings:
        return CodepointCorpus(
            buf=np.zeros(0, dtype=np.uint32), offsets=np.zeros(1, dtype=np.int64)
        )
    joined = "".join(strings)
    if _ascii_fast_path_ok(config, joined):
        # NFKD + ASCII-encode are identity on ASCII input, and lower() on
        # ASCII is a byte LUT, so the fast path is exact here.
        return _clean_ascii_vectorized(strings, config, joined=joined)
    return _clean_general(strings, config)
