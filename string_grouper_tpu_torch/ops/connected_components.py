"""Connected components of the match graph (the grouping step of
``group_similar_strings``; reference string_grouper.py:863 uses
scipy.sparse.csgraph.connected_components).

Edges are undirected (scipy's 'weak' connectivity, the reference's
effective semantics for its symmetric match graphs).  Deterministic: the
label of a component is its smallest member index, so edge order never
changes the result.

The native union-find (native/exact_scorer.cpp ``connected_components_i64``)
is the path whenever the host library builds.  ``_cc_labels`` is the torch
op form of the JAX package's XLA ``_cc_kernel``: min-label propagation over
the edges plus pointer jumping, round after round until no label changes.
It is the path without the library, and the oracle the tests hold the
native path against; its labels are bitwise the union-find's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..native import get_scorer_lib


def _cc_labels(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Component label per node (int64, on the edges' device) of the
    undirected graph with edges ``(a[i], b[i])`` (int64) over ``n`` nodes.

    Each round scatters ``min(l[a], l[b])`` into both ends with an ``amin``
    reduction (order-independent, so the card and the CPU agree bitwise),
    then ``max(1, n.bit_length())`` pointer jumps ``l = l[l]`` flatten every
    path.  The loop ends at the first round that changes no label."""
    labels = torch.arange(n, dtype=torch.int64, device=a.device)
    jumps = max(1, n.bit_length())
    while True:
        m = torch.minimum(labels[a], labels[b])
        nxt = labels.clone()
        nxt.scatter_reduce_(0, a, m, "amin")
        nxt.scatter_reduce_(0, b, m, "amin")
        for _ in range(jumps):
            nxt = nxt[nxt]
        if torch.equal(nxt, labels):
            return labels
        labels = nxt


def connected_components(
    edges_a: np.ndarray, edges_b: np.ndarray, n: int, device
) -> np.ndarray:
    """Component label per node; label == smallest node index in its
    component.  The native union-find runs when the host library builds;
    otherwise the torch op ``_cc_labels`` runs on ``device``."""
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    a = np.ascontiguousarray(edges_a, dtype=np.int64)
    b = np.ascontiguousarray(edges_b, dtype=np.int64)
    lib = get_scorer_lib()
    if lib is not None:
        labels = np.empty(n, dtype=np.int64)
        lib.connected_components_i64(a, b, len(a), n, labels)
        return labels
    # torch.tensor copies: the edge arrays may be read-only pandas buffers.
    labels = _cc_labels(
        torch.tensor(a, device=device), torch.tensor(b, device=device), n
    )
    return labels.cpu().numpy()
