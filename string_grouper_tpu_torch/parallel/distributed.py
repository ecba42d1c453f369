"""Sharded matching over a mesh of devices: the PyTorch counterpart of
``string_grouper_tpu.parallel.distributed`` (same pipeline, same names).

The reference's out-of-core 2-D block decomposition (``n_blocks``, reference
string_grouper/string_grouper.py:709-752) becomes a 2-D device mesh:

  * axis ``dp`` -- left (master) rows, data-parallel: each mesh row processes
    its own chunk of every left super-chunk;
  * axis ``mp`` -- right (candidate) rows: each mesh column holds a shard of
    the right hashed projection.

One process drives every device of the mesh (single controller, as the JAX
tier is): a :class:`Mesh` is a ``(dp, mp)`` grid of ``torch.device``, each
shard's phase 1 is launched on its own device, and the JAX tier's
collectives become tensor moves onto ``devices[0, 0]``: the ``all_gather``
over ``mp`` a concatenation of the shards' candidate columns along the
width, the ``pmax`` an elementwise maximum, the DF ``psum`` a sum.  A slot
may repeat a device (a virtual mesh: every slot ``cpu``, or every slot
``cuda:0``), which runs the same code on one device.

Per shard, phase 1 is the fused CUDA kernel ``p1_fused_closed2`` (on the
card, at the single-device path's eligibility) or the torch-op tile body
``match_block`` (the CPU, escalation widths, thresholdless runs).  Each
shard drops candidates only against its own caps, so counts, per-tile
maxima and drop bounds reduce with a maximum over ``mp`` (not a sum): the
host loop's growth checks see the tightest per-shard values and the
single-device no-drop guarantee holds -- shard count never changes the
returned pair set.  Exact fp64 scoring of the shipped candidates and the
per-row hot-row escalation are the single-device host loop's
(ops/matcher.py ``adaptive_topn``).

The encode stays the host encoder's (:func:`sharded_fit_transform`): one
controller holds the whole corpus, so sharding it would only repeat the
host's work.  :func:`distributed_df_counts` and :func:`replicated_idf` are
the collective form of TfidfVectorizer's DF pass (reference
string_grouper.py:699-707) for callers that hold per-shard counts.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from ..corpus.tfidf import EllMatrix
from ..ops.kernels import p1_fused_closed2
from ..ops.matcher import (
    _ESC_DL_POOL,
    _ROWS_COMPACT_MIN,
    _SHIP_BUDGET_ROWS,
    MatchPairs,
    _compact_cols,
    _consume_stream,
    _finish_rows,
    _gather_pad_rows,
    _join_wire,
    _mark,
    _next_pow2,
    _pack_meta,
    _pad_width,
    _ship_cols,
    _to_device,
    apply_self_join_fixups,
    build_hash_matrix,
    match_block,
    match_with_collapse,
    order_like_reference_csr,
    use_fused,
)
from ..utils.profiling import span
from ..validation import resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "distributed_df_counts",
    "replicated_idf",
    "distributed_topn_cosine_matches",
    "sharded_fit_transform",
    "validate_mesh",
]

_NEG = float("-inf")
MESH_AXES = ("dp", "mp")


class Mesh:
    """A ``(dp, mp)`` grid of ``torch.device`` (the counterpart of a
    ``jax.sharding.Mesh``): ``devices`` is a 2-D numpy object array,
    ``axis_names`` the two axis names, ``shape`` a dict of axis sizes.

    A slot may repeat a device: a virtual mesh runs every shard on that
    device, one after another."""

    def __init__(self, devices, axis_names=MESH_AXES):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("Mesh: devices must be a non-empty 2-D grid")
        arr = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, d in enumerate(row):
                arr[i, j] = d
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 2:
            raise ValueError("Mesh: two axis names are needed")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.devices.tolist()!r}, axis_names={self.axis_names!r})"


def make_mesh(n_devices: Optional[int] = None, dp: int = 1,
              device="cuda") -> Mesh:
    """Build a ``(dp, mp)`` mesh over ``n_devices`` slots.

    ``dp`` splits left rows (data parallel); the remaining factor ``mp``
    shards right rows (candidate parallel).  On ``"cuda"`` the slots are the
    first ``n_devices`` GPUs (default: every visible one); asking for more
    than are visible, or for any without a GPU, raises.  On ``"cpu"`` every
    slot is the CPU (default one slot)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n_vis = torch.cuda.device_count()
        if n_devices is None:
            n_devices = n_vis
        if n_devices > n_vis:
            raise ValueError(
                f"make_mesh: {n_devices} GPUs asked for, {n_vis} visible"
            )
        devs = [torch.device("cuda", k) for k in range(n_devices)]
    else:
        if n_devices is None:
            n_devices = 1
        devs = [torch.device("cpu")] * n_devices
    if n_devices < 1 or n_devices % dp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by dp={dp}")
    mp = n_devices // dp
    return Mesh([devs[i * mp:(i + 1) * mp] for i in range(dp)])


def validate_mesh(mesh, device=None) -> None:
    """``mesh`` is None, or a :class:`Mesh` with axes ("dp", "mp") whose
    slots are all devices of ``device``'s type (default: the type of its
    first slot) that exist here: a ``cuda`` slot without a GPU, or past the
    visible GPUs, raises."""
    if mesh is None:
        return
    hint = "-- see string_grouper_tpu_torch.parallel.make_mesh."
    if not isinstance(mesh, Mesh) or mesh.axis_names != MESH_AXES:
        raise Exception(
            "Invalid option value for mesh: must be a "
            "string_grouper_tpu_torch.parallel.Mesh with axes ('dp', 'mp') "
            + hint
        )
    kind = torch.device(device if device is not None else mesh.devices[0, 0]).type
    for d in set(mesh.devices.flat):
        if d.type != kind:
            raise Exception(
                f"Invalid option value for mesh: slot {d} is not a {kind} "
                f"device (device={kind!r}) " + hint
            )
        resolve_device(d)
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise Exception(
                f"Invalid option value for mesh: slot {d} is not a visible "
                "GPU " + hint
            )


# --------------------------------------------------------------------- TF-IDF
def distributed_df_counts(local_dfs: Iterable[torch.Tensor],
                          mesh: Mesh) -> torch.Tensor:
    """Global document-frequency counts from per-shard counts: the JAX
    tier's ``psum`` over the mesh.  ``local_dfs`` holds one tensor per mesh
    slot (row-major), each on its slot's device; the sum lands on
    ``devices[0, 0]`` in the tensors' dtype."""
    home = mesh.devices[0, 0]
    parts = [df.to(home) for df in local_dfs]
    return torch.stack(parts).sum(0, dtype=parts[0].dtype)


def replicated_idf(df: torch.Tensor, n_docs) -> torch.Tensor:
    """Smooth IDF ``ln((1 + n) / (1 + df)) + 1`` (sklearn parity, reference
    string_grouper.py:699-707 via TfidfVectorizer)."""
    return torch.log((1.0 + n_docs) / (1.0 + df)) + 1.0


def sharded_fit_transform(encoder, master, duplicates, mesh: Mesh):
    """Fit the TF-IDF encoder and encode both sides for a mesh fit (the
    JAX tier's name for its sharded encode).

    One controller holds the whole corpus, so the sharded encode is the
    host encoder's: :meth:`TfidfEncoder.fit_transform_pair`, bitwise, its
    byte-level payload (clean-equality row hashes included) and all, for
    any mesh shape.  The mesh adds no work to the encode."""
    validate_mesh(mesh)
    return encoder.fit_transform_pair(master, duplicates)


# ------------------------------------------------------------------- matching
def _local_block(a_hash, b_loc, thr_eff: float, col_off: int, *, tile: int,
                 chunk_loc: int, cand_c: int, k_tile: int, fused: bool):
    """One shard's phase 1 on its device: its left rows ``a_hash`` against
    its right block ``b_loc`` (global columns from ``col_off``).  Returns
    ``(cols, counts, tmax, bound)``; cols carry global column ids and -1
    sentinels.

    ``fused`` runs the CUDA kernel ``p1_fused_closed2`` once over all the
    shard's rows (rows are independent in it); otherwise the torch-op tile
    body ``match_block`` runs left chunk by left chunk, as the JAX tier's
    scan does."""
    n_loc, d = b_loc.shape
    if fused:
        ship, counts, tmax, bound, _ = p1_fused_closed2(
            a_hash, b_loc, thr_eff, tile=tile, cand_c=cand_c,
        )
        return torch.where(ship >= 0, ship + col_off, -1), counts, tmax, bound
    b_tiles = b_loc.view(n_loc // tile, tile, d)
    outs = []
    for lo in range(0, a_hash.shape[0], chunk_loc):
        w_vals, w_cols, counts, tmax, bound = match_block(
            a_hash[lo:lo + chunk_loc], b_tiles, thr_eff, cand_c, k_tile
        )
        outs.append((torch.where(w_vals > _NEG, w_cols + col_off, -1),
                     counts, tmax, bound))
    return tuple(torch.cat(x) for x in zip(*outs))


def _dist_match(mesh: Mesh, a_loc, b_loc, thr_eff: float, *, tile: int,
                chunk_loc: int, cand_c: int, k_tile: int, fused: bool = False):
    """Sharded phase 1 of a stack of left super-chunks.

    ``a_loc[i][j]`` holds dp shard i's rows of every super-chunk (the JAX
    tier's ``P(None, "dp", None)``: rows ``[k*sc + i*chunk_loc, k*sc +
    (i+1)*chunk_loc)`` of super-chunk k, contiguous) on ``devices[i, j]``;
    ``b_loc[i][j]`` right shard j on the same device.  Per mesh row, the
    shards' columns gather onto ``devices[0, 0]`` along the width in ``mp``
    order (the ``all_gather`` + ``swapaxes``: shard 0's columns first) and
    counts / tmax / bound reduce by an elementwise maximum (the ``pmax``);
    the mesh rows then scatter back into super-chunk row order.  Returns
    ``(cols, bound, counts, tmax)`` on ``devices[0, 0]``."""
    dp, mp = mesh.devices.shape
    home = mesh.devices[0, 0]
    n_loc = b_loc[0][0].shape[0]
    per_row = []
    for i in range(dp):
        parts = [
            [t.to(home) for t in _local_block(
                a_loc[i][j], b_loc[i][j], thr_eff, j * n_loc, tile=tile,
                chunk_loc=chunk_loc, cand_c=cand_c, k_tile=k_tile, fused=fused,
            )]
            for j in range(mp)
        ]
        cols = torch.cat([p[0] for p in parts], 1)
        counts, tmax, bound = (
            torch.stack([p[k] for p in parts]).amax(0) for k in (1, 2, 3)
        )
        per_row.append((cols, counts, tmax, bound))

    def rows_in_order(k):
        """Mesh rows' outputs k back in super-chunk row order."""
        xs = [r[k] for r in per_row]
        if dp == 1:
            return xs[0]
        n_sc = xs[0].shape[0] // chunk_loc
        return torch.stack(
            [x.view(n_sc, chunk_loc, *x.shape[1:]) for x in xs], 1
        ).reshape(n_sc * chunk_loc * dp, *xs[0].shape[1:])

    cols, counts, tmax, bound = (rows_in_order(k) for k in range(4))
    return cols, bound, counts, tmax


def _shard_rows(a_hash: torch.Tensor, mesh: Mesh, chunk_loc: int):
    """``a_loc`` of ``_dist_match``: dp shard i's rows of every super-chunk
    of ``a_hash`` (contiguous), placed on each device of mesh row i (a move
    to the tensor's own device is a no-op)."""
    dp, mp = mesh.devices.shape
    d = a_hash.shape[1]
    blocks = a_hash.view(-1, dp, chunk_loc, d)
    out = []
    for i in range(dp):
        rows_i = blocks[:, i].reshape(-1, d)
        out.append([rows_i.to(mesh.devices[i, j]) for j in range(mp)])
    return out


def _sort_compact(cols: torch.Tensor, budget: int):
    """Ragged-prefix compaction of the mesh-gathered candidate matrix.

    After the gather over ``mp`` each row is a concatenation of per-shard
    prefixes, so the valid entries are NOT one prefix; a per-row descending
    sort (sentinel -1 sinks to the end) restores the prefix invariant
    ``ops.matcher._compact_cols`` needs.  Candidate order within a row is
    irrelevant -- the host rescores every shipped pair exactly."""
    cols = torch.sort(cols, dim=1, descending=True).values
    return _compact_cols(cols, budget)


def _phase1_distributed(
    left: EllMatrix,
    right: EllMatrix,
    is_self: bool,
    mesh: Mesh,
    hash_dim: int,
    left_chunk: int,
    right_tile: int,
    left_sel: Optional[np.ndarray] = None,
    right_sel: Optional[np.ndarray] = None,
):
    """Sharded hash matrices + phase-1 closures for the shared host loop
    ``adaptive_topn``: ``run_stream`` (segmented whole-corpus pass, host scoring
    overlapping device matching) and ``run_rows`` (per-row hot-row
    escalation under the mesh) -- the contract of the single-device
    ``ops.matcher._phase1_single``, including the duplicate-collapse row
    selectors (unique rows gathered on the device).  The geometry is the
    JAX tier's."""
    devs = mesh.devices
    dp, mp = devs.shape
    home = devs[0, 0]
    n_left = left.n_rows if left_sel is None else len(left_sel)
    n_right = right.n_rows if right_sel is None else len(right_sel)

    def gathered(ell, sel, n_valid, n_pad):
        """The selected rows of the full hash matrix, zero-padded."""
        full = build_hash_matrix(ell, ell.n_rows, hash_dim, home)
        idx = np.zeros(n_pad, dtype=np.int64)
        idx[:n_valid] = sel
        return _gather_pad_rows(full, _to_device(idx, home), n_valid, n_pad)

    # Right rows: pad to mp shards of a whole number of tiles each.  The
    # hash builds once on devices[0, 0]; each shard moves to its devices.
    tile = min(right_tile, _next_pow2(max(-(-n_right // mp), 8)))
    n_loc = -(-n_right // (mp * tile)) * tile
    n_right_p = n_loc * mp
    if right_sel is None:
        b_hash = build_hash_matrix(right, n_right_p, hash_dim, home)
    else:
        b_hash = gathered(right, right_sel, n_right, n_right_p)
    b_loc = [[b_hash[j * n_loc:(j + 1) * n_loc].to(devs[i, j])
              for j in range(mp)] for i in range(dp)]

    # Left rows: super-chunks of dp local chunks.
    chunk_loc = min(left_chunk, _next_pow2(max(-(-n_left // dp), 8)))
    sc = chunk_loc * dp
    n_left_p = -(-n_left // sc) * sc
    if is_self and n_left_p <= n_right_p:
        a_hash = b_hash[:n_left_p]
    elif left_sel is None:
        a_hash = build_hash_matrix(left, n_left_p, hash_dim, home)
    else:
        a_hash = gathered(left, left_sel, n_left, n_left_p)

    # Segment the left super-chunks so host-side exact scoring of one
    # segment overlaps the device matching of the next (the single-device
    # policy).
    n_sc = n_left_p // sc
    n_seg = min(8, max(1, n_sc // 8))
    spg = -(-n_sc // n_seg)  # super-chunks per segment
    if n_sc % spg:
        extra = spg - n_sc % spg
        a_hash = torch.cat([a_hash, a_hash.new_zeros((extra * sc, hash_dim))])
        n_sc += extra
    n_seg = n_sc // spg
    seg_rows = spg * sc
    shard_seg = spg * chunk_loc  # one dp shard's rows of a segment
    a_loc = _shard_rows(a_hash, mesh, chunk_loc)
    geom = dict(tile=tile, chunk_loc=chunk_loc)

    def run_stream(thr_eff, cand_c, k_tile):
        """Yield the single-device stream's per-segment tuples; every
        segment (scan, gather and compaction epilogue) is dispatched up
        front."""
        thr = float(thr_eff)
        # The CUDA kernel per shard, once per (segment, shard), at the
        # single-device path's eligibility; the torch-op body otherwise.
        fused = use_fused(home, k_tile, thr_eff, shard_seg, n_loc, hash_dim,
                          tile, cand_c)
        do_compact = thr_eff > 0 and cand_c > _SHIP_BUDGET_ROWS
        budget = -(-seg_rows * _SHIP_BUDGET_ROWS // 1024) * 1024
        futs = []
        for g in range(n_seg):
            seg = [[a[g * shard_seg:(g + 1) * shard_seg] for a in row]
                   for row in a_loc]
            cols2, bound, counts, tmax = _dist_match(
                mesh, seg, b_loc, thr, cand_c=cand_c, k_tile=k_tile,
                fused=fused, **geom,
            )
            if do_compact:
                flat, n_i = _sort_compact(cols2, budget)
                wire = _join_wire(
                    _pack_meta(counts, tmax, bound, n_i),
                    _ship_cols(flat, n_right_p),
                )
            else:
                wire = _pack_meta(counts, tmax, bound)
            futs.append((wire, cols2, do_compact, _mark(wire)))
        yield from _consume_stream(
            futs, budget, n_right_p, seg_rows, n_left, n_right
        )

    def run_rows(row_idx: np.ndarray, thr_eff, cand_c, k_tile,
                 budget_hint: Optional[int] = None, defer: bool = False,
                 stats: Optional[dict] = None):
        """Hot-row escalation under the mesh: gather the unsafe rows' hash
        vectors on the device and re-match only them at larger per-shard
        widths (the torch-op body on every shard, as in the JAX tier), so
        one skewed row never forces a full-corpus re-match.  ``defer=True``
        dispatches now and returns the download as a zero-arg callable.
        No row runs on ``p1_fused_topk``, so ``stats`` gains nothing."""
        m = len(row_idx)
        m_p = -(-m // sc) * sc
        idx = np.zeros(m_p, dtype=np.int64)
        idx[:m] = row_idx
        a_sel = _gather_pad_rows(a_hash, _to_device(idx, home), m, m_p)
        cols2, ub_last, counts, _tmax = _dist_match(
            mesh, _shard_rows(a_sel, mesh, chunk_loc), b_loc, float(thr_eff),
            cand_c=cand_c, k_tile=k_tile, **geom,
        )
        w = cols2.shape[-1]
        wire = None
        budget = 0
        if (
            thr_eff > 0
            and budget_hint is not None
            and m_p * w > _ROWS_COMPACT_MIN
        ):
            # counts are per-shard maxima, so the total valid count can
            # reach mp times the hint; overflow still falls back safely.
            budget = _next_pow2(budget_hint * mp + 8)
            if budget < m_p * w:
                flat, n_i = _sort_compact(cols2, budget)
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

    return run_stream, run_rows, n_loc, tile


def distributed_topn_cosine_matches(
    left: EllMatrix,
    right: Optional[EllMatrix],
    min_similarity: float,
    max_n_matches: Optional[int],
    mesh: Mesh,
    *,
    force_symmetries: bool = True,
    hash_dim: int = 512,
    left_chunk: int = 4096,
    right_tile: int = 4096,
    score_dtype=np.float64,
    left_codes: Optional[np.ndarray] = None,
    right_codes: Optional[np.ndarray] = None,
) -> MatchPairs:
    """Mesh-sharded version of ``ops.matcher.topn_cosine_matches``.

    Produces the identical pair set for any mesh shape (the multi-device
    analog of the reference's blocked == unblocked equivalence, reference
    test_string_grouper.py:191-241).  ``left_codes`` / ``right_codes``
    enable the same duplicate-collapse layer as the single-device matcher:
    the collapse and expansion run on this controller, the unique-row scan
    under the mesh."""
    validate_mesh(mesh)
    is_self = right is None
    right_m = left if is_self else right
    width = -(-max(left.width, right_m.width, 8) // 8) * 8
    left = _pad_width(left, width)
    right_m = left if is_self else _pad_width(right_m, width)
    max_n = right_m.n_rows if max_n_matches is None else max_n_matches

    pairs = match_with_collapse(
        left, right_m, is_self, min_similarity, max_n, score_dtype,
        left_codes, right_codes,
        lambda ls, rs: _phase1_distributed(
            left, right_m, is_self, mesh, hash_dim, left_chunk, right_tile,
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
