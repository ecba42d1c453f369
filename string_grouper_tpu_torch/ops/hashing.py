"""Unsigned feature hashing of ELL TF-IDF rows: the PyTorch counterpart of
``string_grouper_tpu.ops.hashing`` (same names, same bits).

The phase-1 filter multiplies *hashed* dense projections of the TF-IDF
rows.  TF-IDF values are non-negative, so bucket collisions can only
*increase* a dot product:

    a_hash . b_hash = sum_buckets (sum_{t in bucket} a_t)(sum_{t in bucket} b_t)
                   >= sum_t a_t * b_t  =  exact cosine similarity

and hashed scores are a provable upper bound: thresholding them can produce
false positives but never false negatives.

Nothing in this package calls this module: the matcher builds its
projections through ``ops.matcher.build_hash_matrix`` (the kernel
``device_hash_codes`` or the packed-slot op ``_device_hash``).  It is kept
only as the public ``ops.hashed_projection`` the JAX package exports.
"""

from __future__ import annotations

import torch

_KNUTH = 2654435761  # Knuth multiplicative hash constant (2^32 / phi)


def _log2(x: int) -> int:
    if x <= 0 or x & (x - 1):
        raise ValueError(f"hash_dim must be a power of two, not {x}")
    return x.bit_length() - 1


def bucket_of(ids: torch.Tensor, dim: int) -> torch.Tensor:
    """Hash vocabulary indices into [0, dim) via multiplicative hashing:
    the top log2(dim) bits of ``uint32(id) * _KNUTH mod 2^32``, as int32.

    The uint32 wrap-around runs in int64 and is masked: for any int32 id
    (padding ids of -1 included) the product stays inside int64 and its
    low 32 bits are the uint32 product's."""
    u = (ids.to(torch.int64) * _KNUTH) & 0xFFFFFFFF
    return (u >> (32 - _log2(dim))).to(torch.int32)


def hashed_projection(ids: torch.Tensor, vals: torch.Tensor,
                      dim: int) -> torch.Tensor:
    """Scatter-add ELL rows into dense (n, dim) float32 hashed vectors on
    the tensors' device.

    Padding slots (``ids < 0``) add 0.  One ``scatter_add_`` per slot
    column: no two adds of one call land on the same element, so each
    bucket sums in slot order -- the order of the JAX package's
    ``.at[].add`` on the CPU -- and the card gives the CPU's bits."""
    n, width = ids.shape
    b = bucket_of(ids, dim).to(torch.int64)
    v = torch.where(ids >= 0, vals.to(torch.float32), 0.0)
    out = torch.zeros((n, dim), dtype=torch.float32, device=ids.device)
    for j in range(width):
        out.scatter_add_(1, b[:, j:j + 1], v[:, j:j + 1])
    return out
