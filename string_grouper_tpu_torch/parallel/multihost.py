"""Multi-process (multi-host) matching on ``torch.distributed``: the PyTorch
counterpart of ``string_grouper_tpu.parallel.multihost`` (same tiers, same
names).

Ranks are processes.  The rank and the world size come from
``torch.distributed`` when a group is initialized; otherwise the rank is 0,
the world 1, and every collective below is the identity (the single-process
run of the tiers that the CPU tests cover).  A rank drives one device, the
fit's ``device`` (``"cuda"`` is the current device, which the caller sets
with ``torch.cuda.set_device(local_rank)``) -- or, in the sharded tiers,
the device SLOTS of a ``mesh`` (``parallel.Mesh``, flattened in (dp, mp)
row-major order; a slot may repeat a device).  Every rank must have the
same number of slots ``k``; the tiers' geometry then uses ``n_dev = world x
k``, the JAX tiers' global device count, and slot ``j`` of rank ``r`` is
global device ``r * k + j``.  With JAX's device count the sharded tiers do
JAX's work: the same candidate widths, the same escalated rows.

Three tiers live here:

* the REPLICATED production tier (:func:`multihost_fit_pairs`; the
  engine's default below ``SG_TPU_MH_SHARDED_ROWS``): every rank encodes
  its shard, the exact blocks + byte payload gather once, each rank runs
  the complete single-device matcher (``ops.matcher.topn_cosine_matches``,
  or the mesh tier under ``mesh``) on its left-row slice, and one packed
  collective gathers the results, so every rank returns the identical full
  output.
* the SHARDED production tier (:func:`multihost_sharded_fit_pairs`;
  ``multihost="sharded"`` or auto above the threshold): no rank holds the
  full corpus ELL or payload.  Each rank hashes its right block on its
  first slot and moves one sub-block to each slot, the left hash
  replicates onto every rank block by block and reaches each distinct slot
  device once, every slot scans all left rows against its sub-block, the
  slots merge on slot 0, and every rank receives its own rows' candidates
  from every peer (:func:`_phase1_scan`); exact rescoring visits remote
  right shards over a broadcast ring.
* the shard-local DEMONSTRATION tier (:func:`multihost_encode_shard` +
  :func:`multihost_match_shard`): the self-join-only pipeline the sharded
  tier grew from.

Collectives.  Host values travel as RAW BYTES (``uint8`` CPU tensors) over
a gloo group -- the default group when its backend is gloo, else one gloo
group made beside it -- so uint64 vocabulary keys and float64 values stay
exact.  They are host arrays in both packages (the vocabulary, the ELL
blocks, the ring's shards, the pairs); JAX moves them through its devices
only because it has no host transport.

The sharded tiers' DEVICE tensors -- the replicated left hash
(:func:`_replicate_rows`, JAX's gather of a sharded device array) and the
phase-1 candidate merge (:func:`_exchange_rows`, JAX's ``all_gather`` /
``pmax`` over ``mp``) -- take one of two routes, chosen by one rule
(:func:`_route`) from how the group was set up:

* DIRECT, when the default group's backend carries the tensors' device
  type (``nccl`` carries ``cuda``, ``gloo`` carries ``cpu``, a combined
  backend such as ``"cpu:gloo,cuda:nccl"`` each type it names): one
  collective on the tensors' own device (``all_gather_single`` /
  ``all_to_all_single``), even in a one-rank group; nothing passes
  through numpy, and the exchange downloads only this rank's rows.  Under
  nccl the tensors must lie on the rank's current CUDA device, the one
  the communicator is bound to, or the call raises.
* HOST, in every other case (chiefly gloo with CUDA tensors, e.g. several
  ranks on one card): the replication broadcasts each rank's rows card ->
  host -> gloo -> host -> card, and the exchange downloads the ranks' rows
  once and runs the same all-to-all over the gloo group.

Nothing falls back from one route to the other: a collective that fails
raises.  ``ROUTE_CALLS`` counts the collectives each route runs, keyed
by ``(route, op)``.  Without a group both routes are the identity and
run none.

What the sharded tier moves between ranks is timed and counted in its
stage dict (the engine's ``timings`` as ``match.mh_<key>``): the
replication and the exchanges (``replicate_s`` / ``exchange_s``, the
ranges ``sg.match.mh_replicate`` / ``.mh_exchange``), the ring's
broadcasts (``ring_bcast_s``, ``sg.match.mh_ring_bcast``), the bytes of
the buffers this rank hands each kind of collective, sent and received
(``replicate_bytes``, ``exchange_bytes``, ``ring_bytes``; 0 where no
collective ran), and the ``world`` and the rank's ``slots``.

Every decision that could send one rank into a collective
its peers skip is made global first (the capacity checks, the ring's
``need`` vector, the ladder's continuation, the mesh validation and
slot count, the completeness checks), so a raise happens on every rank
together; the group's timeout turns anything left into a failure instead of
a hang.
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import replace
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import StringGrouperConfig
from ..corpus.tfidf import (
    DeviceEncodeSrc,
    EllMatrix,
    _ell_from_unique_pairs,
    device_tables_from_vocab,
)
from ..ops.matcher import (
    MatchPairs,
    _pairs_from_ship,
    _select_topn,
    apply_self_join_fixups,
    build_hash_matrix,
    device_encode_enabled,
    duplicate_codes,
    effective_threshold,
    escalation_unsafe,
    initial_cand_c,
    initial_k_tile,
    topn_cosine_matches,
    use_fused,
)
from ..ops.rescore import rescore_pairs_fp64
from ..utils.profiling import span
from ..validation import resolve_device
from .distributed import (
    _local_block,
    distributed_topn_cosine_matches,
    validate_mesh,
)

__all__ = [
    "multihost_encode_shard",
    "multihost_match_shard",
    "multihost_fit_pairs",
    "multihost_sharded_fit_pairs",
]

#: the gloo group made for host values beside a non-gloo default group,
#: per default group
_HOST_GROUPS: dict = {}
#: collectives run for the sharded tiers' device tensors, by (route, op):
#: ("direct" | "host", "replicate" | "exchange")
ROUTE_CALLS: Counter = Counter()
#: the device type each backend carries on the direct route
_CARRIES = {"gloo": "cpu", "nccl": "cuda"}


# ---------------------------------------------------------------- collectives
def _world() -> Tuple[int, int]:
    """``(rank, world size)``: torch.distributed's when a group is
    initialized, else ``(0, 1)``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _host_group():
    """The gloo group that carries host values: the default group (None)
    when its backend is gloo, else one gloo group over every rank, made on
    first use (every rank reaches it in the same collective order) with
    the default group's timeout, so that a lost peer fails its host
    collectives as soon as its device collectives."""
    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    group = _HOST_GROUPS.get(world)
    if group is None:
        group = _HOST_GROUPS[world] = dist.new_group(
            backend="gloo", timeout=_group_timeout(world))
    return group


def _group_timeout(group) -> Optional[timedelta]:
    """The timeout ``group`` was made with, read from its first backend's
    options; None (the backend's default) where torch does not say."""
    for dev in getattr(group, "_device_types", ()):
        try:
            return group._get_backend(dev).options._timeout
        except (AttributeError, RuntimeError):
            continue
    return None


def _bytes_of(x: np.ndarray) -> torch.Tensor:
    """The bytes of a contiguous array as a 1-D uint8 CPU tensor sharing
    its memory."""
    if not x.flags.writeable:
        x = x.copy()
    return torch.from_numpy(x.reshape(-1).view(np.uint8))


def _allgather_host(x: np.ndarray) -> np.ndarray:
    """Host-value allgather across ranks: shape ``(world, *x.shape)`` in
    x's dtype.  Every rank passes an array of the SAME shape and dtype.
    Transports raw bytes, so uint64 keys and float64 values stay exact."""
    x = np.ascontiguousarray(x)
    _rank, size = _world()
    if size == 1 or x.size == 0:
        return np.stack([x] * size)
    raw = _bytes_of(x)
    parts = [torch.empty_like(raw) for _ in range(size)]
    dist.all_gather(parts, raw, group=_host_group())
    return np.stack([p.numpy().view(x.dtype).reshape(x.shape) for p in parts])


def _broadcast_host_from(x: np.ndarray, source: int) -> np.ndarray:
    """Host-value broadcast from rank ``source`` to every rank.  Every rank
    passes an array of the SAME shape and dtype (contents are read only on
    the source); the received buffer is one block -- O(shape), not
    O(world x shape) -- which lets the sharded tier visit remote ELL shards
    one at a time."""
    x = np.ascontiguousarray(x)
    rank, size = _world()
    if size == 1 or x.size == 0:
        return x
    buf = (_bytes_of(x) if rank == source
           else torch.empty(x.nbytes, dtype=torch.uint8))
    dist.broadcast(buf, src=source, group=_host_group())
    return buf.numpy().view(x.dtype).reshape(x.shape)


def _allgather_ragged(x: np.ndarray) -> list:
    """Allgather arrays whose LEADING dimension differs per rank (equal
    trailing dims and dtype): pad to the global max, gather, slice back.
    Returns the per-rank list."""
    counts = _allgather_host(
        np.array([x.shape[0]], dtype=np.int64)
    ).reshape(-1)
    mx = int(counts.max())
    if mx == 0:
        return [x[:0] for _ in range(len(counts))]
    padded = np.zeros((mx,) + x.shape[1:], dtype=x.dtype)
    padded[: x.shape[0]] = x
    g = _allgather_host(padded)
    return [g[p, : counts[p]] for p in range(len(counts))]


def _all_ranks_agree(ok: bool) -> bool:
    """True when ``ok`` holds on every rank (one tiny collective, so a
    check that fails on one rank fails on all)."""
    return bool(_allgather_host(np.array([int(ok)], np.int64)).min())


def reset_route_calls() -> None:
    ROUTE_CALLS.clear()


def _count(t: Optional[dict], key: str, n: int) -> None:
    """Add ``n`` into the counter ``t[key]`` (nothing without ``t``)."""
    if t is not None:
        t[key] = t.get(key, 0) + int(n)


def _route(device: torch.device) -> str:
    """``"direct"`` when a group is initialized and the default group's
    backend carries ``device``'s type (``nccl`` carries ``cuda``, ``gloo``
    carries ``cpu``, a combined backend such as ``"cpu:gloo,cuda:nccl"``
    each ``type:backend`` pair it names whose backend carries that type);
    ``"host"`` otherwise."""
    if not (dist.is_available() and dist.is_initialized()):
        return "host"
    for part in str(dist.get_backend()).split(","):
        dev_type, _, name = part.rpartition(":")
        carried = _CARRIES.get(name)
        if carried == device.type and dev_type in ("", carried):
            return "direct"
    return "host"


def _check_direct_device(device: torch.device) -> None:
    """Under nccl the communicator is bound to the rank's current CUDA
    device: a tensor elsewhere raises, naming both."""
    if device.type == "cuda":
        current = torch.device("cuda", torch.cuda.current_device())
        if device != current:
            raise ValueError(
                f"the sharded tier's device tensors are on {device}, but "
                f"this rank's current CUDA device is {current}, the one its "
                "NCCL communicator is bound to: call "
                "torch.cuda.set_device() with the rank's first slot"
            )


def _all_gather_single(out: torch.Tensor, inp: torch.Tensor) -> None:
    # newer torch names it all_gather_single and deprecates
    # all_gather_into_tensor, the only name torch 2.11 has
    gather = getattr(dist, "all_gather_single", None)
    (gather or dist.all_gather_into_tensor)(out, inp)


def _replicate_rows(block: torch.Tensor, counts: np.ndarray,
                    n_rows: int, t: Optional[dict] = None) -> torch.Tensor:
    """``(n_rows, d)`` on ``block``'s device: every rank's first
    ``counts[rank]`` rows of its ``block`` in rank order, zero rows after
    (the JAX tier's replicated gather of a sharded device array), on the
    route of :func:`_route` (the range ``sg.match.mh_replicate``; its
    seconds into ``t["replicate_s"]``, its buffers' bytes into
    ``t["replicate_bytes"]``)."""
    with span("match.mh_replicate", t, "replicate_s"):
        if _route(block.device) == "direct":
            return _replicate_direct(block, counts, n_rows, t)
        return _replicate_host(block, counts, n_rows, t)


def _replicate_direct(block, counts, n_rows, t=None):
    """One all-gather on ``block``'s device: each rank's rows padded to
    ``max(counts)``, moved as bytes so the transport cannot change a
    bit, then copied in rank order into the preallocated result."""
    _check_direct_device(block.device)
    rank, size = _world()
    width, d = int(counts.max()), block.shape[1]
    mine = int(counts[rank])
    send = block.new_zeros((width, d))
    send[:mine] = block[:mine]
    recv = block.new_empty((size * width, d))
    _all_gather_single(recv.view(torch.uint8), send.view(torch.uint8))
    ROUTE_CALLS["direct", "replicate"] += 1
    _count(t, "replicate_bytes", send.nbytes + recv.nbytes)
    out = block.new_zeros((n_rows, d))
    lo = 0
    for s in range(size):
        cnt = int(counts[s])
        out[lo:lo + cnt] = recv[s * width:s * width + cnt]
        lo += cnt
    return out


def _replicate_host(block, counts, n_rows, t=None):
    """One broadcast per source rank through the host, uploaded into the
    preallocated result, so the host holds one rank's block at a time."""
    rank, size = _world()
    out = block.new_zeros((n_rows, block.shape[1]))
    lo = 0
    for s in range(size):
        cnt = int(counts[s])
        if cnt == 0:
            continue
        if s == rank:
            out[lo:lo + cnt] = block[:cnt]
        if size > 1:
            host = (block[:cnt].contiguous().view(torch.uint8).cpu()
                    if s == rank
                    else torch.empty((cnt, 2 * block.shape[1]),
                                     dtype=torch.uint8))
            dist.broadcast(host, src=s, group=_host_group())
            ROUTE_CALLS["host", "replicate"] += 1
            _count(t, "replicate_bytes", host.nbytes)
            if s != rank:
                out[lo:lo + cnt] = host.to(block.device).view(block.dtype)
        lo += cnt
    return out


def _all_to_all(recv: torch.Tensor, wire: torch.Tensor, counts: np.ndarray,
                group) -> None:
    """Rank p's ``counts[p]`` rows of ``wire`` (in rank order) to rank p:
    ``recv`` receives every rank's block of this rank's rows, in rank
    order."""
    world = len(counts)
    dist.all_to_all_single(recv, wire, [recv.shape[0] // world] * world,
                           [int(c) for c in counts], group=group)


def _exchange_rows(cols: torch.Tensor, bound: torch.Tensor,
                   tmax: torch.Tensor, starts: np.ndarray,
                   counts: np.ndarray, t: Optional[dict] = None):
    """The JAX tier's ``all_gather`` over ``mp`` and its ``pmax``,
    delivering to each rank only its own rows, in one all-to-all on the
    route of :func:`_route`.

    ``cols`` (m, W) int32, ``bound`` (m,) f32 and ``tmax`` (m,) int32 are
    this rank's phase 1 of m left rows against its right block; rank p
    owns rows ``[starts[p], starts[p] + counts[p])``, contiguous in rank
    order (rows past them are padding).  The owned rows travel packed as
    ``(rows, W + 2)`` int32 (cols, bound's bits, tmax): on the tensors'
    device on the direct route, downloaded first and over the gloo group
    on the host route.  Each rank receives its rows' slices from every
    peer: the columns concatenate along the width in rank order, bound and
    tmax reduce by an elementwise max.  Returns host ``(cols, bound,
    tmax)`` of this rank's rows, downloaded once (the range
    ``sg.match.mh_exchange``; its seconds into ``t["exchange_s"]``, the
    bytes of the all-to-all's send and receive buffers into
    ``t["exchange_bytes"]``)."""
    with span("match.mh_exchange", t, "exchange_s"):
        rank, size = _world()
        owners = np.flatnonzero(counts)
        lo = int(starts[owners[0]]) if len(owners) else 0
        total = int(counts.sum())
        if np.any((counts > 0) & (starts != lo + np.cumsum(counts) - counts)):
            raise ValueError(
                f"the ranks' rows are not contiguous in rank order: starts "
                f"{starts.tolist()}, counts {counts.tolist()}"
            )
        w = cols.shape[1]
        route = _route(cols.device)
        wire = torch.cat([
            cols[lo:lo + total].to(torch.int32),
            bound[lo:lo + total, None].view(torch.int32),
            tmax[lo:lo + total, None].to(torch.int32),
        ], 1)
        mine = int(counts[rank])
        recv = wire
        if dist.is_available() and dist.is_initialized():
            if route == "direct":
                _check_direct_device(wire.device)
            else:
                wire = wire.cpu()
            recv = wire.new_empty((size * mine, w + 2))
            _all_to_all(recv, wire, counts,
                        None if route == "direct" else _host_group())
            ROUTE_CALLS[route, "exchange"] += 1
            _count(t, "exchange_bytes",
                   wire.numel() * wire.element_size()
                   + recv.numel() * recv.element_size())
        recv = recv.view(size, mine, w + 2)
        flat = torch.cat([
            recv[:, :, :w].permute(1, 0, 2).reshape(-1),
            recv[:, :, w].view(torch.float32).amax(0).view(torch.int32),
            recv[:, :, w + 1].amax(0),
        ]).cpu().numpy()
        n = mine * size * w
        return (flat[:n].reshape(mine, size * w),
                flat[n:n + mine].view(np.float32), flat[n + mine:])


def _phase1_scan(a_rows: dict, b_slots: list, thr: float,
                 starts: np.ndarray, counts: np.ndarray, *, tile: int,
                 chunk: int, cand_c: int, k_tile: int,
                 t: Optional[dict] = None):
    """The phase-1 scan of the multi-process tiers (JAX's
    ``_make_phase1_scan`` over the ``(1, n_dev)`` mesh): the same left rows
    on every rank against this rank's slots, then :func:`_exchange_rows`.

    ``b_slots[j]`` is slot j's right sub-block (``per_dev`` rows on the
    slot's device; global columns from ``(rank * k + j) * per_dev``), and
    ``a_rows`` maps each distinct slot device to its copy of the left rows.
    Per slot, the CUDA kernel ``p1_fused_closed2`` runs at kt = 2 with a
    threshold on the card where it supports the shape (the mesh tier's
    rule, off under ``SG_TPU_FUSED=0``), the torch-op ``match_block`` chunk
    by chunk otherwise.  The slots merge on slot 0 in slot order (columns
    concatenated along the width, bound and tmax by an elementwise maximum:
    the mesh tier's ``_dist_match`` at dp = 1), so the width is global
    device order once the exchange adds the ranks.  ``t``: the stage dict
    the exchange times and counts into."""
    rank, _size = _world()
    k = len(b_slots)
    per_dev, d = b_slots[0].shape
    home = b_slots[0].device
    parts = []
    for j, b in enumerate(b_slots):
        a = a_rows[b.device]
        fused = use_fused(b.device, k_tile, thr, a.shape[0], per_dev, d, tile,
                          cand_c)
        cols, _counts, tmax, bound = _local_block(
            a, b, thr, (rank * k + j) * per_dev, tile=tile, chunk_loc=chunk,
            cand_c=cand_c, k_tile=k_tile, fused=fused,
        )
        parts.append([t.to(home) for t in (cols, tmax, bound)])
    cols = torch.cat([p[0] for p in parts], 1)
    tmax, bound = (torch.stack([p[i] for p in parts]).amax(0) for i in (1, 2))
    return _exchange_rows(cols, bound, tmax, starts, counts, t)


def _slot_blocks(block: torch.Tensor, slots: list) -> list:
    """``block`` (k x per_dev rows) cut into the slots' sub-blocks, sub-block
    j moved to slot j's device (a view where it is already there)."""
    per_dev = block.shape[0] // len(slots)
    return [block[j * per_dev:(j + 1) * per_dev].to(dev)
            for j, dev in enumerate(slots)]


def _slot_copies(rows: torch.Tensor, b_slots: list) -> dict:
    """``rows`` on each distinct device of the slots, once per device."""
    out: dict = {}
    for b in b_slots:
        if b.device not in out:
            out[b.device] = rows.to(b.device)
    return out


def _rows_of(a_rows: dict, idx: np.ndarray) -> dict:
    """Rows ``idx`` of every device's copy, gathered on that device."""
    return {dev: a[torch.as_tensor(idx, device=dev)]
            for dev, a in a_rows.items()}


def _batch_owners(rows: np.ndarray, row_starts: np.ndarray):
    """``(starts, counts)`` of each rank's rows within the sorted ``rows``,
    rank p owning ``[row_starts[p], row_starts[p + 1])``."""
    lo = np.searchsorted(rows, row_starts[:-1])
    return lo, np.searchsorted(rows, row_starts[1:]) - lo


# --------------------------------------------------------------------- encode
def multihost_encode_shard(
    shard_strings, config: StringGrouperConfig
) -> Tuple[EllMatrix, np.ndarray, int]:
    """Shard-local encode across ranks.

    Consumes ONLY this rank's strings; agrees globally on the packing
    width (one scalar max), the vocabulary (union of per-shard sorted
    unique key sets) and the document frequencies (one |vocab| vector per
    rank, summed).  Returns (local ELL block over the GLOBAL vocabulary,
    float64 IDF, global doc count) -- bitwise the corresponding rows of a
    single-process fit over the concatenated corpus.
    """
    from ..corpus.ngrams import (
        extract_packed_keys,
        extract_windows,
        packed_key_bits,
        windows_as_sortable_keys,
    )
    from ..corpus.preprocess import clean_corpus
    from ..corpus.tfidf import _EMPTY_VOCAB_MSG, _unique_row_term_counts

    corpus = clean_corpus(list(shard_strings), config)

    # 1. Global key-packing width: one scalar max across ranks.
    maxcp_local = np.array([int(corpus.buf.max(initial=0))], dtype=np.int64)
    maxcp = int(_allgather_host(maxcp_local).max())
    bits0 = packed_key_bits(maxcp)
    if bits0 * config.ngram_size > 64:
        bits0 = None

    if bits0 is not None:
        keys, row_ids, n_rows, _ = extract_packed_keys(
            corpus, config.ngram_size, bits0
        )
        key_dtype = np.dtype(np.uint64)
    else:
        # Byte-key fallback: n-grams wider than 64 bits travel as opaque
        # big-endian fixed-width byte keys (void dtype), whose byte-wise
        # order is sklearn's sorted-vocabulary order.  bits0 is a function
        # of the GLOBAL max codepoint, so every rank takes this branch.
        win = extract_windows(corpus, config.ngram_size)
        keys, row_ids, n_rows = (
            windows_as_sortable_keys(win.windows), win.row_ids, win.n_rows
        )
        # The wire dtype comes from the data: a hardcoded itemsize would
        # silently reinterpret the gathered bytes if the key layout changed.
        key_dtype = keys.dtype if len(keys) else np.dtype(
            (np.void, 4 * config.ngram_size)
        )
        if key_dtype.itemsize != 4 * config.ngram_size:
            raise AssertionError(
                f"window key dtype {key_dtype} does not match the 4-bytes-"
                f"per-codepoint layout for ngram_size={config.ngram_size}"
            )

    # 2. Vocabulary union: per-shard sorted unique key sets, padded to the
    # global max length and gathered as raw bytes (uint64 packed keys and
    # void byte keys alike); each shard's block is sliced by its exact
    # count, so no key pattern is reserved as a sentinel.
    local_vocab = (
        np.unique(keys) if len(keys) else np.zeros(0, dtype=key_dtype)
    )
    itemsize = key_dtype.itemsize
    counts_v = _allgather_host(
        np.array([len(local_vocab)], dtype=np.int64)
    ).reshape(-1)
    max_loc = int(counts_v.max())
    if max_loc == 0:
        raise ValueError(_EMPTY_VOCAB_MSG)
    padded = np.zeros((max_loc, itemsize), dtype=np.uint8)
    if len(local_vocab):
        padded[: len(local_vocab)] = (
            np.ascontiguousarray(local_vocab)
            .view(np.uint8)
            .reshape(len(local_vocab), itemsize)
        )
    g = _allgather_host(padded)  # (world, max_loc, itemsize)
    gathered_keys = (
        np.ascontiguousarray(
            np.concatenate([g[p, : counts_v[p]] for p in range(g.shape[0])])
        )
        .view(key_dtype)
        .reshape(-1)
    )
    vocab = np.unique(gathered_keys)
    n_terms = len(vocab)

    # 3. Document frequency: per-shard partials gathered and summed.
    t_idx = np.searchsorted(vocab, keys)
    rows, terms, tf = _unique_row_term_counts(row_ids, t_idx, n_terms)
    df_local = np.bincount(terms, minlength=n_terms).astype(np.int64)
    df = _allgather_host(df_local).sum(axis=0)
    n_docs = int(_allgather_host(np.array([n_rows], dtype=np.int64)).sum())

    # 4. Shard-local values / norms / ELL over the global vocabulary.  The
    # float32 branch runs the single-process encoder's sklearn rounding
    # chain with the GLOBAL df and doc count; both chains are row-local
    # given (idf, tf), so shard blocks concatenate bitwise.
    f32 = np.dtype(config.tfidf_matrix_dtype) == np.float32
    if f32:
        from ..corpus.tfidf import f32_idf, f32_row_values

        idf32c = f32_idf(df, n_docs)
        idf = idf32c.astype(np.float64)
        vals, inv = f32_row_values(rows, terms, tf, idf32c, n_rows)
    else:
        idf = np.log((1.0 + n_docs) / (1.0 + df)) + 1.0
        w = tf.astype(np.float64) * idf[terms]
        norm_sq = np.bincount(rows, weights=w * w, minlength=n_rows)
        norm = np.sqrt(norm_sq)
        inv = np.zeros(n_rows, dtype=np.float64)
        nz = norm > 0
        inv[nz] = 1.0 / norm[nz]
        vals = w * inv[rows]
    width_local = np.array(
        [int(np.bincount(rows, minlength=n_rows).max(initial=0))], np.int64
    )
    width = max(8, -(-int(_allgather_host(width_local).max()) // 8) * 8)
    ell = _ell_from_unique_pairs(
        rows, terms, vals, n_rows, n_terms, width=width
    )

    # Byte-level device-encode payload: eligible exactly when the
    # vocabulary packed at 8 bits per codepoint (post-clean ASCII), a
    # GLOBAL property, so every rank takes the same branch; the tables are
    # a pure function of the agreed vocabulary.
    if bits0 == 8 and not f32 and device_encode_enabled():
        code_lut, table, idf32, base = device_tables_from_vocab(
            vocab.astype(np.uint64), idf, config.ngram_size
        )
        coff = corpus.offsets.astype(np.int64)
        src = DeviceEncodeSrc(
            flat_codes=code_lut[corpus.buf.astype(np.int64)],
            coff=coff,
            inv_norm=inv.astype(np.float32),
            table_id=table,
            idf32=idf32,
            base=base,
            ngram=config.ngram_size,
            row_hash=_poly_row_hash(corpus.buf, coff),
        )
        ell = replace(ell, device_src=src)
    return ell, idf, n_docs


def _poly_row_hash(buf: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit polynomial hash of each row's cleaned codepoints.

    Feeds the clean-equality duplicate collapse like the native encoder's
    FNV-1a row hashes: groups are keyed by (hash, length) and byte-verified
    before use, so any well-mixing per-row hash that is consistent within
    one payload is valid."""
    n = len(offsets) - 1
    h = np.zeros(n, dtype=np.uint64)
    if len(buf) == 0 or n == 0:
        return h
    lens = np.diff(offsets)
    r = np.uint64(0x100000001B3)
    max_len = int(lens.max())
    pows = np.empty(max_len, dtype=np.uint64)
    pos = np.arange(len(buf), dtype=np.int64) - np.repeat(offsets[:-1], lens)
    with np.errstate(over="ignore"):
        pows[0] = np.uint64(1)
        for i in range(1, max_len):
            pows[i] = pows[i - 1] * r
        w = (buf.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)) * pows[pos]
        nz = lens > 0
        # Nonzero rows' content tiles ``w`` exactly (empty rows contribute
        # no elements between them), so reduceat over their starts is the
        # per-row segment sum.
        h[nz] = np.add.reduceat(w, offsets[:-1][nz])
    return h


# -------------------------------------------------------- demonstration tier
def multihost_match_shard(
    local_ell: EllMatrix,
    shard_row0: int,
    n_total: int,
    min_similarity: float,
    max_n_matches: int,
    *,
    hash_dim: int = 512,
    tile: int = 4096,
    cand_c0: Optional[int] = None,
    device="cuda",
    mesh=None,
):
    """Self-join matching across ranks: this rank owns rows
    ``[shard_row0, shard_row0 + local_ell.n_rows)`` of the corpus and
    returns the EXACT top-n matches for those rows only, as
    ``(rows, cols, sims)`` in corpus positions.

    ``mesh`` (a ``parallel.Mesh`` of ``device``'s type, the same size on
    every rank) gives the rank several device slots -- the counterpart of
    the JAX tier's ``jax.devices()``; without it the rank has one slot,
    ``device``.  The rank's hash block splits into one sub-block per slot;
    the exact blocks gather once; every rank rebuilds the full left hash
    from them and scans it against each slot's sub-block at the complete
    per-tile width (k_tile = tile), and receives its own rows' candidates
    from every peer (:func:`_phase1_scan`).  Rows whose drop bound could
    still matter escalate as ONE union re-match at the provably complete
    width -- the union gathers first, so every rank runs the same
    collectives.  ``cand_c0`` overrides the initial candidate width (tests
    force the escalation with it)."""
    slots = _rank_slots(mesh, resolve_device(device))
    n_local = local_ell.n_rows
    pid, nproc = _world()
    k = len(slots)
    n_dev = nproc * k

    # Per-device shard size (rows), padded to whole tiles, and the rank's
    # k of them.  The capacity check is COLLECTIVE: row counts gather
    # first, so an oversized shard raises on every rank.
    per_dev = -(-max(-(-n_total // n_dev), 8) // tile) * tile
    n_pad_local = per_dev * k
    local_ell.wait_ready()
    g = _allgather_host(np.array([n_local, shard_row0], np.int64))
    counts, row0s = g[:, 0], g[:, 1]
    if int(counts.max()) > n_pad_local:
        raise ValueError(
            f"shard of {int(counts.max())} rows (rank "
            f"{int(counts.argmax())}) exceeds the per-rank padded capacity "
            f"{n_pad_local} (n_total={n_total}, {nproc} ranks, {n_dev} "
            f"devices, tile={tile}): shards must be balanced to "
            "ceil(n_total / world) rows"
        )
    b_slots = _slot_blocks(
        build_hash_matrix(local_ell, n_pad_local, hash_dim, slots[0]), slots
    )

    # Exact blocks: one bulk allgather.  Widths were agreed at encode; row
    # counts may differ per shard.
    full_ell = EllMatrix(
        ids=np.concatenate(_allgather_ragged(local_ell.ids)),
        vals64=np.concatenate(_allgather_ragged(local_ell.vals64)),
        n_terms=local_ell.n_terms,
    )
    # The left hash is a pure function of the exact blocks + the global
    # vocabulary: rebuilt here instead of a second collective.
    a_hash = _slot_copies(
        build_hash_matrix(full_ell, per_dev * n_dev, hash_dim, slots[0]),
        b_slots,
    )
    chunk = min(8, per_dev)
    cand_c = cand_c0 or initial_cand_c(
        min_similarity, max_n_matches, n_total, per_dev
    )
    # Full per-tile extraction (k_tile = tile): only top-C truncation can
    # drop, so the drop bound alone drives escalation.
    thr = float(effective_threshold(min_similarity))
    geom = dict(tile=tile, chunk=chunk)

    proc_starts = np.concatenate(([0], np.cumsum(counts)[:-1]))

    def map_cols(cols_h):
        """Padded-device-space column ids -> global corpus ids."""
        dev_of = cols_h // per_dev
        within = cols_h % per_dev
        proc_of = np.minimum(dev_of // k, nproc - 1)
        within_proc = (dev_of % k) * per_dev + within
        valid = (cols_h >= 0) & (within_proc < counts[proc_of])
        return np.where(valid, proc_starts[proc_of] + within_proc, -1)

    def score_select(cols_h, row_ids_local):
        """Exact rescore + per-row top-n for a set of OWNED rows."""
        rows_pos, cols_f = _pairs_from_ship(map_cols(cols_h), n_total)
        rows_l = row_ids_local[rows_pos]
        sims = rescore_pairs_fp64(
            full_ell, full_ell, rows_l + shard_row0, cols_f
        )
        return _select_topn(
            rows_l, cols_f, sims, n_local, min_similarity,
            min(max_n_matches, n_total),
        )

    cols_my, bound_my, _tmax = _phase1_scan(
        a_hash, b_slots, thr, row0s, counts, cand_c=cand_c, k_tile=tile,
        **geom,
    )
    r_s, c_s, s_s, kept_q, row_cut = score_select(
        cols_my, np.arange(n_local, dtype=np.int64)
    )

    # Escalation: each rank detects ITS unsafe rows; the sets gather so
    # every rank runs the IDENTICAL union re-match at the provably
    # complete width (k_tile = tile extracts every qualified column per
    # tile, cand_c = per-rank rows fits them all), so one round settles
    # everything.  Each rank then reads back only the rows it owns.
    max_n_eff = min(max_n_matches, n_total)
    unsafe = escalation_unsafe(
        bound_my, kept_q, row_cut, max(min_similarity, 0.0), max_n_eff
    )
    my_unsafe = np.flatnonzero(unsafe).astype(np.int64) + shard_row0
    union = np.unique(np.concatenate(_allgather_ragged(my_unsafe)))
    if len(union):
        u_starts, u_counts = _batch_owners(
            union, np.concatenate((row0s, [row0s[-1] + counts[-1]]))
        )
        cols_esc, bound_esc, _te = _phase1_scan(
            _rows_of(a_hash, union), b_slots, thr, u_starts, u_counts,
            cand_c=per_dev, k_tile=tile, **geom,
        )
        if not _all_ranks_agree(not np.isfinite(bound_esc).any()):
            raise AssertionError(
                "multihost escalation re-match reported a finite drop "
                "bound: the complete-width invariant is broken"
            )
        mine = union[u_starts[pid]:u_starts[pid] + u_counts[pid]]
        if len(mine):
            r2, c2, s2, _kq2, _rc2 = score_select(cols_esc, mine - shard_row0)
            touched = np.zeros(n_local, dtype=bool)
            touched[mine - shard_row0] = True
            keep = ~touched[r_s]
            r_s = np.concatenate([r_s[keep], r2])
            c_s = np.concatenate([c_s[keep], c2])
            s_s = np.concatenate([s_s[keep], s2])
    return r_s + shard_row0, c_s, s_s


# ============================================================================
# Sharded production tier: the memory-scalable engine form.
#
# The replicated tier below gathers the full corpus ELL (+ payload) to every
# rank -- O(corpus) host memory per rank, which caps the corpus at what ONE
# host holds.  This tier keeps the demonstration tier's layout (per-rank
# string shards, a right hash block on each rank's device) and replaces
# every full-corpus host structure:
#
#   encode   -- each rank encodes ITS left slice (+ right slice on
#               cross-joins); nothing is gathered.
#   phase 1  -- each rank hashes its right block on its device; the left
#               hash replicates onto every device block by block (the host
#               holds one block at a time); each rank scans all left rows
#               against its block and receives its own rows' candidates.
#   phase 2  -- exact rescoring visits remote right shards ONE AT A TIME
#               over a broadcast ring (O(2 x corpus / world) resident).
#   reduce   -- only the RESULT pair list (output-sized: every rank returns
#               the full reference DataFrame) gathers.
# ============================================================================

#: Sharded-tier initial candidate width cap (per rank block): bounds the
#: candidate matrix at n_left_pad x 256 x 4 B per rank for ANY
#: max_n_matches / threshold; truncated rows settle exactly in the ladder.
_SHARDED_CAND_CAP = 256


def _shard_bounds(n: int, nproc: int, pid: int) -> Tuple[int, int, int]:
    """Contiguous even sharding: (per, lo, hi) with per = ceil(n/nproc).
    Both bounds clamp to ``n`` so trailing ranks of a tiny corpus
    (n < nproc) get EMPTY shards, not negative-length ones."""
    per = -(-max(n, 1) // nproc)
    return per, min(pid * per, n), min((pid + 1) * per, n)


def _pad_block(a: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows,) + a.shape[1:], dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


class _RingRescorer:
    """Exact phase-2 scoring against a RING of remote right-ELL shards.

    Each ``score(rows_local, cols_global)`` call runs up to ``world``
    broadcast rounds, one for each shard that some rank other than its
    owner needs -- every rank MUST make the same number of calls, even
    with zero local pairs.  Peak resident: the local shards plus ONE
    visiting shard (tracked in ``peak_visit_bytes``).  The broadcasts,
    their waits included, are the range ``sg.match.mh_ring_bcast``, timed
    into ``t["ring_bcast_s"]``; their bytes, sent or received, count into
    ``t["ring_bytes"]``."""

    def __init__(self, left_ell: EllMatrix, right_ell: EllMatrix,
                 right_counts: np.ndarray, acc_dtype,
                 t: Optional[dict] = None):
        self.left = left_ell
        self.right = right_ell
        self.right_counts = right_counts
        self.right_starts = np.concatenate(
            ([0], np.cumsum(right_counts))
        ).astype(np.int64)
        self.acc = acc_dtype
        self.nproc = len(right_counts)
        self.n_visit_max = int(right_counts.max())
        self.peak_visit_bytes = 0
        self.pid, self.world = _world()
        self.t = t

    def score(self, rows_local: np.ndarray,
              cols_global: np.ndarray) -> np.ndarray:
        self.right.wait_ready()
        sims = np.zeros(len(rows_local), dtype=np.float64)
        owner = (
            np.searchsorted(self.right_starts, cols_global, side="right") - 1
        )
        # One tiny collective agrees which shards a rank other than their
        # owner needs this call, so the other rounds skip their two
        # full-shard broadcasts.
        need_local = np.zeros(self.nproc, dtype=np.int64)
        remote = np.unique(owner)
        need_local[remote[remote != self.pid]] = 1
        need = _allgather_host(need_local).max(axis=0)
        w = self.right.width
        for s in range(self.nproc):
            sel = owner == s
            if s == self.pid and sel.any():
                # Local shard: no transfer (a broadcast below still runs in
                # lock-step on every rank when a peer needs it).
                sims[sel] = rescore_pairs_fp64(
                    self.left, self.right, rows_local[sel],
                    cols_global[sel] - self.right_starts[s],
                    acc_dtype=self.acc,
                )
            if not need[s]:
                continue
            ids_p = _pad_block(
                self.right.ids if s == self.pid
                else np.zeros((0, w), np.int32),
                self.n_visit_max,
            )
            vals_p = _pad_block(
                self.right.vals64 if s == self.pid
                else np.zeros((0, w), np.float64),
                self.n_visit_max,
            )
            with span("match.mh_ring_bcast", self.t, "ring_bcast_s"):
                ids_v = _broadcast_host_from(ids_p, s)
                vals_v = _broadcast_host_from(vals_p, s)
            if self.world > 1:
                _count(self.t, "ring_bytes", ids_p.nbytes + vals_p.nbytes)
            if s != self.pid and sel.any():
                visiting = EllMatrix(
                    ids=ids_v[: self.right_counts[s]],
                    vals64=vals_v[: self.right_counts[s]],
                    n_terms=self.right.n_terms,
                )
                self.peak_visit_bytes = max(
                    self.peak_visit_bytes, ids_v.nbytes + vals_v.nbytes,
                )
                sims[sel] = rescore_pairs_fp64(
                    self.left, visiting, rows_local[sel],
                    cols_global[sel] - self.right_starts[s],
                    acc_dtype=self.acc,
                )
        return sims


def _shard_counts(n: int, nproc: int) -> np.ndarray:
    """Rows of every rank's shard: a pure function of (n, world), so every
    rank computes its peers' without a collective."""
    return np.array(
        [_shard_bounds(n, nproc, p)[2] - _shard_bounds(n, nproc, p)[1]
         for p in range(nproc)], np.int64,
    )


def multihost_sharded_fit_pairs(
    master, duplicates, config: StringGrouperConfig
) -> Tuple[MatchPairs, dict]:
    """Memory-scalable multi-process fit: the engine's ``sharded`` tier
    (see the section header above).  Every rank calls with the same full
    input Series and receives the identical full matches list, but no rank
    materializes the full corpus ELL or byte payload.  Covers self- and
    cross-joins; equal to the single-process engine.

    Phase 1 starts with the single-device heuristic (closed-form kt = 2 on
    thresholded corpora: ``p1_fused_closed2`` on the card), and unsafe rows
    climb a ladder of wider (candidates, k_tile) stages ending at the
    provably complete width, in lock-step on every rank.

    ``config.mesh`` gives each rank its device slots (the same number on
    every rank): the rank's right block splits into one sub-block per slot
    and the geometry is the JAX tier's at ``n_dev = world x k``."""
    t: dict = {}
    with span("match.mh_encode_s", t, "encode_s"):
        is_self = duplicates is None
        pid, nproc = _world()
        slots = _rank_slots(config.mesh, resolve_device(config.device))
        k = len(slots)
        n_dev = nproc * k
        t["world"], t["slots"] = nproc, k
        for key in ("replicate", "exchange", "ring"):
            t[f"{key}_bytes"] = 0
        t["replicate_s"] = t["exchange_s"] = t["ring_bcast_s"] = 0.0
        n_m = len(master)
        right_series = master if is_self else duplicates
        n_right = len(right_series)
        n_docs = n_m + (0 if is_self else n_right)

        min_similarity = config.min_similarity
        if np.dtype(config.tfidf_matrix_dtype) == np.float32:
            # Reference thresholds in the matrix dtype (adaptive_topn does the
            # same rounding on the single-device path).
            min_similarity = float(np.float32(min_similarity))
        max_n = (n_right if config.max_n_matches is None
                 else config.max_n_matches)
        max_n_eff = min(max_n, n_right)

        # --- encode: ONLY this rank's slices of each side.
        _per_l, llo, lhi = _shard_bounds(n_m, nproc, pid)
        _per_r, rlo, rhi = _shard_bounds(n_right, nproc, pid)
        local_strings = list(master.iloc[llo:lhi])
        n_ll = lhi - llo
        if not is_self:
            local_strings += list(duplicates.iloc[rlo:rhi])
        local_ell, _idf, n_docs_g = multihost_encode_shard(
            local_strings, config)
        if n_docs_g != n_docs:
            raise AssertionError(
                f"global document count mismatch: slices sum to {n_docs_g} "
                f"but the full corpus has {n_docs} rows"
            )
        left_ell = _slice_ell(local_ell, 0, n_ll)
        right_ell = (
            left_ell if is_self
            else _slice_ell(local_ell, n_ll, n_ll + (rhi - rlo))
        )
        left_counts = _shard_counts(n_m, nproc)
        right_counts = _shard_counts(n_right, nproc)
        left_starts = np.concatenate(([0], np.cumsum(left_counts))).astype(
            np.int64
        )

    if n_m == 0 or n_right == 0 or max_n_eff <= 0:
        t["match_s"] = 0.0
        return _finish(_empty_pairs(), 0, n_m, is_self, config, t)
    with span("match.mh_p1_s", t, "p1_s"):
        # --- phase 1: a right hash block per rank (one sub-block per slot),
        # the left hash replicated onto every slot device.
        hash_dim = config.hash_dim
        tile = min(
            config.right_tile,
            max(8, -(-max(-(-n_right // n_dev), 8) // 8) * 8),
        )
        per_dev_r = -(-max(-(-n_right // n_dev), 8) // tile) * tile
        pad_local_r = per_dev_r * k
        if int(right_counts.max()) > pad_local_r:
            raise ValueError(
                f"right shard of {int(right_counts.max())} rows exceeds the "
                f"per-rank padded capacity {pad_local_r}"
            )
        local_ell.wait_ready()
        b_local = build_hash_matrix(right_ell, pad_local_r, hash_dim, slots[0])
        b_slots = _slot_blocks(b_local, slots)

        # Left scan-chunk rows: the single-device chunk on the card, tiny on
        # the CPU where per-step work must stay small.
        chunk = min(4096 if slots[0].type == "cuda" else 8, per_dev_r)
        pad_local_l = -(-max(-(-n_m // n_dev), 8) // chunk) * chunk * k
        if int(left_counts.max()) > pad_local_l:
            raise ValueError(
                f"left shard of {int(left_counts.max())} rows exceeds the "
                f"per-rank padded capacity {pad_local_l}"
            )
        a_local = (
            b_local if is_self and pad_local_l == pad_local_r
            else build_hash_matrix(left_ell, pad_local_l, hash_dim, slots[0])
        )
        n_left_pad = -(-n_m // chunk) * chunk
        a_dense = _slot_copies(
            _replicate_rows(a_local, left_counts, n_left_pad, t), b_slots
        )
        del b_local, a_local

        # Candidate width is CAPPED: the per-slot candidate matrix is
        # (n_left_pad, cand_c) int32, uncapped it scales with the corpus
        # itself.  Rows whose top-C truncates report a finite drop bound and
        # settle in the ladder, so the cap never costs exactness.
        cand_c = min(
            initial_cand_c(min_similarity, max_n_eff, n_right, per_dev_r),
            _SHARDED_CAND_CAP,
            per_dev_r,
        )
        thr = float(effective_threshold(min_similarity))
        # Initial extraction width: the single-device heuristic (closed-form
        # kt = 2 on thresholded corpora); the ladder restores completeness.
        kt0 = initial_k_tile(min_similarity, tile, cand_c)
        cols_my, bound_my, tmax_my = _phase1_scan(
            a_dense, b_slots, thr, left_starts[:-1], left_counts, tile=tile,
            chunk=chunk, cand_c=cand_c, k_tile=kt0, t=t,
        )
    with span("match.mh_rescore_s", t, "rescore_s"):
        # --- phase 2: exact rescore over the right-shard ring + selection.
        right_starts = np.concatenate(([0], np.cumsum(right_counts))).astype(
            np.int64
        )

        def map_cols(cols_h: np.ndarray) -> np.ndarray:
            """Padded rank-block right space -> global right ids."""
            proc_of = np.minimum(cols_h // pad_local_r, nproc - 1)
            within = cols_h - proc_of * pad_local_r
            valid = (cols_h >= 0) & (within < right_counts[proc_of])
            return np.where(valid, right_starts[proc_of] + within, -1)

        ring = _RingRescorer(
            left_ell, right_ell, right_counts, config.tfidf_matrix_dtype, t
        )

        def score_select(cols_h: np.ndarray, row_ids_local: np.ndarray):
            rows_pos, cols_f = _pairs_from_ship(map_cols(cols_h), n_right)
            rows_l = row_ids_local[rows_pos]
            sims = ring.score(rows_l, cols_f)
            return _select_topn(
                rows_l, cols_f, sims, n_ll, min_similarity, max_n_eff
            )

        r_s, c_s, s_s, kept_q, row_cut = score_select(
            cols_my, np.arange(n_ll, dtype=np.int64)
        )
    with span("match.mh_esc_s", t, "esc_s"):
        # --- escalation LADDER: unsafe rows re-match at widening
        # (cand, k_tile) stages, ending at the provably complete width
        # (cand = per-device rows, k_tile = tile).  The unsafe union gathers per
        # stage, stage continuation is a global condition, and every rank runs
        # the identical batch sequence; each batch's per-tile extraction stack
        # stays (n_tiles, batch, kt) instead of (n_tiles, corpus, tile).
        qual_low = max(min_similarity, 0.0)
        unsafe = escalation_unsafe(
            bound_my, kept_q, row_cut, qual_low, max_n_eff
        )
        # Rung plan: per-tile widths clamp to at least kt0, candidates widen
        # toward the per-device cap, the complete width is always last.  Rows
        # are ASSIGNED to the first rung whose kt covers their device-reported
        # per-tile maximum (tmax is a property of the data), so no row climbs
        # a rung that provably cannot settle it.
        stages = []
        if kt0 < tile or cand_c < per_dev_r:
            prev = (cand_c, kt0)
            for mid_cand, mid_kt in (
                (min(max(cand_c * 4, 256), per_dev_r), min(max(8, kt0), tile)),
                (
                    min(max(cand_c * 16, 1024), per_dev_r),
                    min(max(32, kt0), tile),
                ),
            ):
                wider = mid_cand > prev[0] or mid_kt > prev[1]
                if wider and (mid_cand < per_dev_r or mid_kt < tile):
                    stages.append((mid_cand, mid_kt))
                    prev = (mid_cand, mid_kt)
        stages.append((per_dev_r, tile))
        n_tiles_dev = max(per_dev_r // tile, 1)
        n_uns0 = _allgather_host(np.array([int(unsafe.sum())], np.int64))
        t["esc_rows"] = int(n_uns0.sum())  # unique escalated rows, all ranks
        touched_all = np.zeros(n_ll, dtype=bool)
        for si, (cand_s, kt_s) in enumerate(stages):
            complete = cand_s >= per_dev_r and kt_s >= tile
            eligible = unsafe if complete else (unsafe & (tmax_my <= kt_s))
            # Per-stage scan-chunk rows: the tile scan stacks (n_tiles, chunk,
            # kt) intermediates, so wide-kt stages take narrow chunks.
            chunk_esc = max(
                8,
                min(
                    512,
                    (1 << 29) // max(16 * n_tiles_dev * kt_s, 1) // 8 * 8,
                ),
            )
            my_unsafe = np.flatnonzero(eligible).astype(np.int64) + llo
            n_uns = _allgather_host(np.array([len(my_unsafe)], np.int64))
            if int(n_uns.max()) == 0:
                continue  # later stages may still own rows (tmax > this kt)
            t[f"esc_s{si}_kt{kt_s}_rows"] = int(n_uns.sum())
            stage = f"esc_s{si}_kt{kt_s}_s"
            with span(f"match.mh_{stage}", t, stage):
                union = np.unique(np.concatenate(_allgather_ragged(my_unsafe)))
                # Batch rows so the per-dispatch extraction stack (~2 copies of
                # (n_tiles, batch, kt) f32 + i32) stays under ~0.5 GB.
                per_row_b = 16 * n_tiles_dev * kt_s + 4 * n_dev * cand_s
                batch = max(
                    chunk_esc,
                    (1 << 29) // max(per_row_b, 1) // chunk_esc * chunk_esc,
                )
                cols_parts, bound_parts, rows_parts = [], [], []
                for b0 in range(0, len(union), batch):
                    ub = union[b0:b0 + batch]
                    u_starts, u_counts = _batch_owners(ub, left_starts)
                    cols_b, bound_b, _tmax_b = _phase1_scan(
                        _rows_of(a_dense, ub), b_slots, thr,
                        u_starts, u_counts, tile=tile, chunk=chunk_esc,
                        cand_c=cand_s, k_tile=kt_s, t=t,
                    )
                    if complete and not _all_ranks_agree(
                        not np.isfinite(bound_b).any()
                    ):
                        raise AssertionError(
                            "sharded-tier complete-width re-match reported a "
                            "finite drop bound: the completeness invariant is "
                            "broken"
                        )
                    if len(cols_b):
                        cols_parts.append(cols_b)
                        bound_parts.append(bound_b)
                        lo_p = u_starts[pid]
                        rows_parts.append(ub[lo_p:lo_p + u_counts[pid]] - llo)
                rows_mine = (
                    np.concatenate(rows_parts) if rows_parts
                    else np.zeros(0, dtype=np.int64)
                )
                cols_mine = (
                    np.concatenate(cols_parts) if cols_parts
                    else np.zeros((0, n_dev * cand_s), dtype=np.int32)
                )
                # Every rank runs the ring (score_select is collective), even
                # with zero own rows this stage.
                r2, c2, s2, kept2, cut2 = score_select(cols_mine, rows_mine)
                touched = np.zeros(n_ll, dtype=bool)
                touched[rows_mine] = True
                touched_all |= touched
                keep = ~touched[r_s]
                r_s = np.concatenate([r_s[keep], r2])
                c_s = np.concatenate([c_s[keep], c2])
                s_s = np.concatenate([s_s[keep], s2])
                # This stage's rows settle or re-queue on their NEW bounds and
                # selection cuts; rows waiting for a wider rung stay unsafe.
                unsafe[rows_mine] = False
                if len(rows_mine) and not complete:
                    unsafe[rows_mine] = escalation_unsafe(
                        np.concatenate(bound_parts), kept2[rows_mine],
                        cut2[rows_mine], qual_low, max_n_eff,
                    )
        if touched_all.any():
            order = np.lexsort((c_s, -s_s, r_s))
            r_s, c_s, s_s = r_s[order], c_s[order], s_s[order]

    # --- memory accounting for the scalability contract.
    local_bytes = left_ell.ids.nbytes + left_ell.vals64.nbytes
    if not is_self:
        local_bytes += right_ell.ids.nbytes + right_ell.vals64.nbytes
    t["mem_local_ell_bytes"] = int(local_bytes)
    t["mem_peak_visit_bytes"] = int(ring.peak_visit_bytes)
    t["mem_replicated_ell_bytes"] = int(
        n_docs * local_ell.width * (4 + 8)
    )

    pairs_local = MatchPairs(
        rows=r_s, cols=c_s, sims=s_s, true_max_n_matches=0
    )
    return _finish(pairs_local, llo, n_m, is_self, config, t)


def _finish(pairs_local: MatchPairs, row_offset: int, n_m: int,
            is_self: bool, config: StringGrouperConfig,
            t: dict) -> Tuple[MatchPairs, dict]:
    """The tail both production tiers share: gather every rank's pairs
    (``row_offset`` = the rank's first left row) into the global list, then
    apply the self-join fix-ups identically on every rank (reference
    string_grouper.py:419-427)."""
    with span("match.mh_result_allgather_s", t, "result_allgather_s"):
        rows_g, cols_g, sims_g = _gather_pair_list(
            pairs_local.rows + row_offset, pairs_local.cols, pairs_local.sims
        )
        true_max = (
            int(np.bincount(rows_g, minlength=n_m).max(initial=0))
            if len(rows_g) else 0
        )
        pairs = MatchPairs(
            rows=rows_g, cols=cols_g, sims=sims_g, true_max_n_matches=true_max
        )
    with span("match.mh_fixups_s", t, "fixups_s"):
        if is_self and config.force_symmetries:
            pairs = apply_self_join_fixups(pairs, n_m)
    return pairs, t


# ============================================================================
# Replicated production tier: the engine-integrated multi-process pipeline.
#
# Every rank calls the SAME engine API with the SAME full input Series.
# Internally the work shards:
#
#   encode  -- each rank tokenizes only ITS contiguous shard of the virtual
#              concat(master, duplicates); vocabulary / DF / widths agree
#              via host collectives (multihost_encode_shard).
#   gather  -- exact ELL blocks + byte payload gather once, so phase 2
#              scoring stays rank-local afterwards.
#   match   -- each rank runs the FULL single-device matcher (or the mesh
#              tier under ``mesh``) on ITS contiguous slice of left rows x
#              the whole right side: duplicate collapse, byte-payload device
#              hash, streamed segments, per-row escalation -- with NO
#              cross-rank traffic in the hot loop (per-row top-n is
#              row-local, so left sharding is exact by construction).
#   reduce  -- per-rank pair lists gather (one packed collective); the
#              self-join fix-ups and reference ordering apply to the global
#              list identically on every rank, so get_matches / get_groups
#              return the SAME full DataFrame everywhere.
# ============================================================================


def _slice_ell(ell: EllMatrix, lo: int, hi: int) -> EllMatrix:
    src = ell.device_src
    return EllMatrix(
        ids=ell.ids[lo:hi],
        vals64=ell.vals64[lo:hi],
        n_terms=ell.n_terms,
        device_src=src.slice_rows(lo, hi) if src is not None else None,
        # Slices view still-filling buffers when the fill is deferred:
        # wait_ready() on the slice must join it.
        pending=ell.pending,
    )


def _allgather_full_ell(local_ell: EllMatrix) -> EllMatrix:
    """One bulk allgather of the exact shard blocks (+ byte payload when
    present) -> the full corpus ELL, identical on every rank.  Widths were
    agreed at encode time, so the blocks concatenate directly."""
    local_ell.wait_ready()
    full = EllMatrix(
        ids=np.concatenate(_allgather_ragged(local_ell.ids)),
        vals64=np.concatenate(_allgather_ragged(local_ell.vals64)),
        n_terms=local_ell.n_terms,
    )
    src = local_ell.device_src
    # Payload eligibility is a global property (multihost_encode_shard), so
    # either every rank has one or none does.
    if src is None:
        return full
    lens = np.concatenate(_allgather_ragged(np.diff(src.coff)))
    full_src = DeviceEncodeSrc(
        flat_codes=np.concatenate(_allgather_ragged(src.flat_codes)),
        coff=np.concatenate(([0], np.cumsum(lens))).astype(np.int64),
        inv_norm=np.concatenate(_allgather_ragged(src.inv_norm)),
        table_id=src.table_id,
        idf32=src.idf32,
        base=src.base,
        ngram=src.ngram,
        row_hash=np.concatenate(_allgather_ragged(src.row_hash)),
    )
    return replace(full, device_src=full_src)


def _gather_pair_list(
    rows: np.ndarray,
    cols: np.ndarray,
    sims: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Allgather per-rank pair lists into the global (rows, cols, sims).

    ONE uint8 stream per rank -- [count:u32, pad:u32, rows:i32, cols:i32,
    sims:f64], 16 bytes per pair."""
    m = len(rows)
    wire = np.concatenate(
        [
            np.array([m, 0], np.uint32).view(np.uint8),
            np.ascontiguousarray(rows, dtype=np.int32).view(np.uint8),
            np.ascontiguousarray(cols, dtype=np.int32).view(np.uint8),
            np.ascontiguousarray(sims, dtype=np.float64).view(np.uint8),
        ]
    )
    rows_l, cols_l, sims_l = [], [], []
    for part in _allgather_ragged(wire):
        part = part.copy()  # gathered slices may be unaligned for views
        mp = int(part[:4].view(np.uint32)[0])
        rows_l.append(part[8:8 + 4 * mp].view(np.int32).astype(np.int64))
        cols_l.append(
            part[8 + 4 * mp:8 + 8 * mp].view(np.int32).astype(np.int64)
        )
        sims_l.append(part[8 + 8 * mp:8 + 16 * mp].view(np.float64))
    return (
        np.concatenate(rows_l),
        np.concatenate(cols_l),
        np.concatenate(sims_l),
    )


def _host_available_bytes() -> Optional[int]:
    """MemAvailable from /proc/meminfo, or None off-Linux."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable"):
                    return int(line.split()[1]) * 1024
    except OSError:  # pragma: no cover - non-Linux
        pass
    return None


def _check_replicated_capacity(local_ell: EllMatrix, n_docs: int) -> None:
    """Guard the replicated tier's O(corpus) per-rank materialization.

    The tier gathers the FULL exact ELL (+ byte payload) to every rank;
    the estimate is compared against ``SG_TPU_MH_HOST_BUDGET_GB`` (or 80% of
    MemAvailable).  Both sides of the comparison are made global -- the max
    estimate against the min budget -- so every rank raises together
    rather than one dying mid-gather."""
    est = n_docs * (local_ell.width * 12 + 16)
    src = local_ell.device_src
    if src is not None and len(src.coff):
        per_row = int(src.coff[-1]) / max(len(src.coff) - 1, 1)
        est += int(n_docs * (per_row + 16))
    budget_env = os.environ.get("SG_TPU_MH_HOST_BUDGET_GB")
    if budget_env is not None:
        local_budget = float(budget_env) * (1 << 30)
    else:
        avail = _host_available_bytes()
        local_budget = float("inf") if avail is None else 0.8 * avail
    gathered = _allgather_host(
        np.array([float(est), local_budget], np.float64)
    )
    est = float(gathered[:, 0].max())
    budget = float(gathered[:, 1].min())
    if est > budget:
        raise MemoryError(
            f"multihost='replicated' would materialize ~{est / (1 << 30):.1f}"
            f" GB of exact corpus encode on EVERY rank ({n_docs:,} rows),"
            f" exceeding the per-host budget of {budget / (1 << 30):.1f} GB. "
            "Use multihost='sharded' (per-rank memory ~1/world; the engine "
            "auto-selects it above SG_TPU_MH_SHARDED_ROWS rows), or raise "
            "SG_TPU_MH_HOST_BUDGET_GB if this host can hold the replicated "
            "encode."
        )


def _empty_pairs() -> MatchPairs:
    return MatchPairs(
        rows=np.zeros(0, dtype=np.int64),
        cols=np.zeros(0, dtype=np.int64),
        sims=np.zeros(0, dtype=np.float64),
        true_max_n_matches=0,
    )


def _check_mesh_everywhere(mesh, dev: torch.device) -> np.ndarray:
    """Validate ``mesh`` (None: no mesh) on EVERY rank, empty-slice ranks
    included, and raise on all of them when any fails: a raise on some
    ranks while the others go on into the next collective would hang the
    job.  Every rank makes the same one collective, mesh or not.  Returns
    each rank's slot count (1 without a mesh)."""
    err, k = None, 1
    if mesh is not None:
        try:
            validate_mesh(mesh, dev)
            k = mesh.devices.size
        except Exception as e:  # re-raised below, after the agreement
            err = e
    g = _allgather_host(np.array([int(err is None), k], np.int64))
    if not g[:, 0].min():
        if err is not None:
            raise err
        raise ValueError(
            "multihost + mesh: the mesh is invalid on another rank"
        )
    return g[:, 1]


def _rank_slots(mesh, dev: torch.device) -> list:
    """This rank's device slots in the sharded tiers: ``mesh``'s devices
    flattened in (dp, mp) row-major order, or ``[dev]`` without a mesh.
    The mesh is validated on every rank and the slot count ``k`` agreed:
    the geometry (``n_dev = world x k``) needs one ``k`` everywhere, so
    differing counts raise on every rank together."""
    ks = _check_mesh_everywhere(mesh, dev)
    if (ks != ks[0]).any():
        rank = _world()[0]
        raise ValueError(
            f"multihost='sharded' + mesh: the ranks' device slot counts "
            f"differ: this rank (rank {rank}) has {int(ks[rank])}, rank "
            f"{int(np.flatnonzero(ks != ks[rank])[0])} has "
            f"{int(ks[ks != ks[rank]][0])} (per rank: {ks.tolist()}); every "
            "rank needs a mesh of the same size"
        )
    return [dev] if mesh is None else list(mesh.devices.flat)


def multihost_fit_pairs(
    master, duplicates, config: StringGrouperConfig
) -> Tuple[MatchPairs, dict]:
    """The engine's multi-process fit: the FULL reference-equivalent
    matches list (identical on every rank) plus per-stage wall times.
    Every rank calls it with the same full input Series.  Covers self- and
    cross-joins; equal to the single-process engine."""
    t = {}
    with span("match.mh_encode_s", t, "encode_s"):
        is_self = duplicates is None
        pid, nproc = _world()
        dev = resolve_device(config.device)
        n_m = len(master)
        n_docs = n_m + (0 if is_self else len(duplicates))

        _per, lo, hi = _shard_bounds(n_docs, nproc, pid)
        shard = list(master.iloc[lo:min(hi, n_m)]) if lo < n_m else []
        if hi > n_m:
            shard += list(duplicates.iloc[max(lo - n_m, 0):hi - n_m])
        # Sharded encode for both matrix dtypes (the f32 sklearn chain runs
        # inside multihost_encode_shard against the global df / doc count).
        local_ell, _idf, n_docs_g = multihost_encode_shard(shard, config)
        if n_docs_g != n_docs:
            raise AssertionError(
                f"global document count mismatch: slices sum to {n_docs_g} "
                f"but the full corpus has {n_docs} rows"
            )
    with span("match.mh_ell_allgather_s", t, "ell_allgather_s"):
        _check_replicated_capacity(local_ell, n_docs)
        full_ell = _allgather_full_ell(local_ell)
    full_master = _slice_ell(full_ell, 0, n_m)
    full_right = (
        full_master if is_self else _slice_ell(full_ell, n_m, n_docs)
    )

    # Left rows shard contiguously over ranks; each rank runs the complete
    # single-device matcher on its slice.
    with span("match.mh_match_s", t, "match_s"):
        right_series = master if is_self else duplicates
        n_right = len(right_series)
        max_n = (n_right if config.max_n_matches is None
                 else config.max_n_matches)
        _per_l, lo_l, hi_l = _shard_bounds(n_m, nproc, pid)
        _check_mesh_everywhere(config.mesh, dev)
        if hi_l > lo_l:
            left_slice = _slice_ell(full_master, lo_l, hi_l)
            kwargs = dict(
                hash_dim=config.hash_dim,
                left_chunk=config.left_chunk,
                right_tile=config.right_tile,
                score_dtype=config.tfidf_matrix_dtype,
                left_codes=duplicate_codes(master.iloc[lo_l:hi_l], left_slice),
                right_codes=duplicate_codes(right_series, full_right),
            )
            args = (left_slice, full_right, config.min_similarity, max_n)
            if config.mesh is not None:
                pairs_local = distributed_topn_cosine_matches(
                    *args, config.mesh, **kwargs
                )
            else:
                pairs_local = topn_cosine_matches(*args, device=dev, **kwargs)
        else:
            pairs_local = _empty_pairs()
    # This rank's matcher stages (escalated rows, p1_wait, ...) beside the
    # tier's own.
    t.update({f"local_{k}": v for k, v in (pairs_local.stats or {}).items()})
    return _finish(pairs_local, lo_l, n_m, is_self, config, t)
