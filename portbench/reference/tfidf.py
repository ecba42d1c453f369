"""Plain reference of the similarity: string_grouper's cleaning, character
n-gram TF-IDF (scikit-learn's ``TfidfVectorizer`` defaults: raw counts,
smooth idf, l2 rows) and exact cosines, in NumPy and PyTorch.

It is written from string_grouper's documented semantics and reads nothing
of the program.  Names whose cleaned strings are equal have equal TF-IDF
rows, so the rows are built once per *class* of equal cleaned strings; the
idf still counts every name (a class of k names adds k to a term's
document frequency), as the vectorizer fitted on the whole list does.
Cosines come from a sparse (classes x terms) matrix times dense query
columns, in the precision asked for, on the device asked for.
"""

from __future__ import annotations

import re
import unicodedata
import warnings
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch


def clean(strings: Sequence[str], regex: str, ignore_case: bool,
          normalize_to_ascii: bool) -> list:
    """string_grouper's analyzer before the n-grams: lower case, NFKD
    folded to ASCII, then every match of ``regex`` removed."""
    rx = re.compile(regex)
    out = []
    for s in strings:
        if ignore_case:
            s = s.lower()
        if normalize_to_ascii:
            s = unicodedata.normalize("NFKD", s).encode("ASCII", "ignore").decode()
        out.append(rx.sub("", s))
    return out


@dataclass
class Corpus:
    """Classes of equal cleaned strings over named input lists, and their
    TF-IDF rows as CSR arrays."""

    cls: Dict[str, np.ndarray]     # list -> class of each of its names
    mult: Dict[str, np.ndarray]    # list -> names of each class in it
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray               # float64 TF-IDF values, rows of unit norm
    n_terms: int

    @property
    def n_classes(self) -> int:
        return len(self.indptr) - 1


def _gram_keys(uniq: list, n: int):
    """(class of each n-gram occurrence, a key per distinct n-gram)."""
    cps = np.frombuffer("".join(uniq).encode("utf-32-le"), dtype=np.uint32)
    lens = np.fromiter((len(s) for s in uniq), dtype=np.int64, count=len(uniq))
    n_g = np.maximum(lens - n + 1, 0)
    doc = np.repeat(np.arange(len(uniq), dtype=np.int64), n_g)
    first = np.cumsum(n_g) - n_g
    pos = (np.cumsum(lens) - lens)[doc] + (np.arange(len(doc)) - first[doc])
    if 21 * n <= 63:  # code points take 21 bits: pack the n-gram into one int
        key = np.zeros(len(doc), dtype=np.int64)
        for k in range(n):
            key = (key << 21) | cps[pos + k].astype(np.int64)
        return doc, np.unique(key, return_inverse=True)[1]
    grams = np.ascontiguousarray(np.stack([cps[pos + k] for k in range(n)], axis=1))
    view = grams.view(np.dtype((np.void, 4 * n))).ravel()
    return doc, np.unique(view, return_inverse=True)[1]


def build(lists: Dict[str, Sequence[str]], semantics: dict) -> Corpus:
    """The corpus the vectorizer is fitted on: every list, concatenated."""
    ids: Dict[str, int] = {}
    cls = {}
    for name, strings in lists.items():
        cleaned = clean(strings, semantics["regex"], semantics["ignore_case"],
                        semantics["normalize_to_ascii"])
        cls[name] = np.fromiter((ids.setdefault(c, len(ids)) for c in cleaned),
                                dtype=np.int64, count=len(cleaned))
    uniq = list(ids)
    n_cls = len(uniq)
    mult = {k: np.bincount(v, minlength=n_cls) for k, v in cls.items()}
    total = sum(mult.values())
    n_docs = int(total.sum())

    doc, term = _gram_keys(uniq, int(semantics["ngram_size"]))
    n_terms = int(term.max()) + 1 if len(term) else 0
    pair, tf = np.unique(doc * max(n_terms, 1) + term, return_counts=True)
    p_doc, p_term = pair // max(n_terms, 1), pair % max(n_terms, 1)
    df = np.bincount(p_term, weights=total[p_doc], minlength=n_terms)
    idf = np.log((1.0 + n_docs) / (1.0 + df)) + 1.0
    val = tf.astype(np.float64) * idf[p_term]
    norm = np.sqrt(np.bincount(p_doc, weights=val * val, minlength=n_cls))
    val = val / norm[p_doc]
    indptr = np.zeros(n_cls + 1, dtype=np.int64)
    np.cumsum(np.bincount(p_doc, minlength=n_cls), out=indptr[1:])
    return Corpus(cls=cls, mult=mult, indptr=indptr, indices=p_term.astype(np.int64),
                  data=val, n_terms=n_terms)


def _row_entries(indptr: np.ndarray, rows: np.ndarray):
    """Entries per row, and the CSR positions of the rows' entries in row
    order."""
    cnt = indptr[rows + 1] - indptr[rows]
    take = np.repeat(indptr[rows] - (np.cumsum(cnt) - cnt), cnt) + np.arange(int(cnt.sum()))
    return cnt, take


class Cosines:
    """Cosines of query classes against the classes of one list (the rows:
    classes with a name in ``side``), on ``device`` in ``dtype``."""

    def __init__(self, corpus: Corpus, side: str, device, dtype=torch.float64):
        self.corpus, self.device, self.dtype = corpus, torch.device(device), dtype
        self.rows = np.flatnonzero(corpus.mult[side] > 0)
        ip = corpus.indptr
        cnt, take = _row_entries(ip, self.rows)
        sub_ptr = np.zeros(len(self.rows) + 1, dtype=np.int64)
        np.cumsum(cnt, out=sub_ptr[1:])
        data = corpus.data[take]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.x = torch.sparse_csr_tensor(
                torch.from_numpy(sub_ptr), torch.from_numpy(corpus.indices[take]),
                torch.from_numpy(data).to(dtype),
                size=(len(self.rows), max(corpus.n_terms, 1)),
                check_invariants=False,
            ).to(self.device)

    def columns(self, q: np.ndarray) -> torch.Tensor:
        """(rows of the side, len(q)) cosines against query classes ``q``."""
        c = self.corpus
        cnt, take = _row_entries(c.indptr, q)
        qt = torch.zeros(max(c.n_terms, 1), len(q), dtype=self.dtype)
        vals = c.data[take]
        qt[torch.from_numpy(c.indices[take]),
           torch.from_numpy(np.repeat(np.arange(len(q)), cnt))] = \
            torch.from_numpy(vals).to(self.dtype)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return torch.sparse.mm(self.x, qt.to(self.device))

    def scan(self, q: np.ndarray, lo, k: int, block_bytes: float = 2e9):
        """For each query class in ``q``: its ``k`` best row classes with
        their cosines, best first, and (``lo`` not None) every row class at
        a cosine of at least ``lo``.  Returns ``{query: (classes, cosines)}``
        dicts ``top`` and ``cand``."""
        top, cand = {}, {}
        n_rows = len(self.rows)
        k = min(k, n_rows)
        size = torch.finfo(self.dtype).bits // 8
        step = max(1, min(1024, int(block_bytes // max(1, n_rows * size))))
        for b0 in range(0, len(q), step):
            qb = q[b0:b0 + step]
            s = self.columns(qb)
            tv, ti = torch.topk(s, k, dim=0)
            tv, ti = tv.cpu().numpy(), ti.cpu().numpy()
            for j, qc in enumerate(qb):
                top[int(qc)] = (self.rows[ti[:, j]], tv[:, j].astype(np.float64))
            if lo is not None:
                nz = torch.nonzero(s >= lo)
                vals = s[nz[:, 0], nz[:, 1]].cpu().numpy().astype(np.float64)
                r, c = nz[:, 0].cpu().numpy(), nz[:, 1].cpu().numpy()
                order = np.argsort(c, kind="stable")
                r, c, vals = r[order], c[order], vals[order]
                bounds = np.searchsorted(c, np.arange(len(qb) + 1))
                for j, qc in enumerate(qb):
                    sl = slice(bounds[j], bounds[j + 1])
                    cand[int(qc)] = (self.rows[r[sl]], vals[sl])
            del s
        return top, cand
