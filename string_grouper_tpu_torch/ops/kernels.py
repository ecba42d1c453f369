"""The hand-written CUDA kernels of the matcher, each beside its plain
PyTorch version (the counterpart of ``string_grouper_tpu.ops.
pallas_kernels``).

Every wrapper launches its kernel for CUDA tensors -- or raises: nothing
falls back to the plain version on the card.  The launch (and the TMA
descriptors it encodes) runs with the tensors' device made current, so a
shard on ``cuda:k`` launches on ``cuda:k``.  Tensors on the CPU take the
plain version, which is what the CPU tests run.  ``LAUNCHES`` counts each
wrapper's kernel launches (and nothing else), so a run can show that the
main path went through the kernels; ``LAUNCHES_BY_DEVICE`` counts the same
launches per (wrapper, device), so a mesh run can show where each ran.

* ``p1_fused_closed2`` (csrc/p1_fused_closed2.cu) replaces the Pallas kernel
  of the same name (string_grouper_tpu/ops/pallas_kernels.py:117-179).
* ``p1_fused_chain`` (csrc/p1_fused_chain.cu) replaces the Pallas kernel of
  the same name (pallas_kernels.py:275-358): the same pass over one right
  column chunk, resuming from the previous chunk's state.
* ``p1_tri_fused`` (csrc/p1_tri_fused.cu) replaces the Pallas kernel of the
  same name (pallas_kernels.py:626-726): the triangular self-join, each
  tile pair multiplied once.
  The three share the TMA/wgmma scan of csrc/p1_scan_sm90.cuh.
* ``device_hash_codes`` (csrc/device_hash_codes.cu) replaces the XLA
  program ``_device_hash_codes`` (string_grouper_tpu/ops/matcher.py:398-464).
* ``p1_mm_floor`` (csrc/p1_mm_floor.cu) and ``p1_closed2_variant``
  (csrc/p1_closed2_variant.cu) replace the Pallas A/B probes ``mm_floor``
  and ``variant`` (benchmarks/ab_p1_epilogue.py:65-88, :160-200): the
  scan's product with the qualified count only, and ``p1_fused_closed2``
  under its tie-rule and block-rows switches.  No path of the matcher
  launches them; ``tools/ab_p1_epilogue.py`` and chip_smoke.py time them.

The plain versions multiply f32 upcasts of bf16 inputs under
``ieee_f32_matmul()``: exact products, f32 sums, whatever the caller set
for TF32.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Dict, Iterator, Optional

import torch

from . import _build

_KNUTH = 2654435761  # Knuth multiplicative hash constant (2^32 / phi)
_NEG = float("-inf")

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {name: 0 for name in _build.KERNELS}
#: the same launches per (wrapper, device), e.g. ("p1_fused_closed2", "cuda:1")
LAUNCHES_BY_DEVICE: Counter = Counter()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_DEVICE.clear()


def _launched(name: str, dev: torch.device) -> None:
    """Count one launch of ``name``'s kernel on ``dev``."""
    LAUNCHES[name] += 1
    LAUNCHES_BY_DEVICE[(name, str(dev))] += 1


_PREC_LOCK = threading.Lock()
_PREC_DEPTH = 0
_PREC_SAVED: Optional[tuple] = None


def _get_precision() -> tuple:
    """The caller's float32 matmul setting, in the API it was set with:
    ``("legacy", torch.get_float32_matmul_precision())``, or, when that
    getter refuses (the setting was made through the per-backend
    ``fp32_precision`` API), ``("cuda", backends.cuda.matmul.fp32_precision)``."""
    try:
        return "legacy", torch.get_float32_matmul_precision()
    except RuntimeError:
        return "cuda", torch.backends.cuda.matmul.fp32_precision


def _set_precision(saved: tuple) -> None:
    api, value = saved
    if api == "legacy":
        torch.set_float32_matmul_precision(value)
    else:
        torch.backends.cuda.matmul.fp32_precision = value


@contextlib.contextmanager
def ieee_f32_matmul() -> Iterator[None]:
    """Float32 matrix products in full IEEE float32 (no TF32, no bf16
    passes) inside the block, the caller's setting restored after it.
    Products of bf16 values upcast to f32 are exact in f32; TF32 would
    round the inputs to 10 mantissa bits.  Nothing is written when the
    setting already is full float32.  Blocks on several threads nest: the
    first to enter saves and sets, the last to leave restores."""
    global _PREC_DEPTH, _PREC_SAVED
    with _PREC_LOCK:
        if _PREC_DEPTH == 0:
            saved = _get_precision()
            if saved[1] in ("highest", "ieee"):
                _PREC_SAVED = None
            else:
                _PREC_SAVED = saved
                _set_precision(("legacy", "highest") if saved[0] == "legacy"
                               else ("cuda", "ieee"))
        _PREC_DEPTH += 1
    try:
        yield
    finally:
        with _PREC_LOCK:
            _PREC_DEPTH -= 1
            if _PREC_DEPTH == 0 and _PREC_SAVED is not None:
                _set_precision(_PREC_SAVED)
                _PREC_SAVED = None


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_tensors(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


# ------------------------------------------------------------ kernel 1: p1
def p1_fused_supported(m: int, n_pad: int, d: int, tile: int,
                       cand_c: int) -> bool:
    """Shapes the fused kernel handles (the torch-op scan covers the rest):
    the JAX package's rule (pallas_kernels.py:729-743) plus ``d <= 512``,
    because the CUDA kernels keep their 128 left rows of width d in shared
    memory (128 x 512 bf16 = 128 KB of the block's 227 KB, beside the ring
    of B stages)."""
    return (
        d % 128 == 0
        and d <= 512
        and m >= 256
        and m % min(512, m) == 0
        and n_pad % tile == 0
        and tile % 256 == 0
        and 8 <= cand_c <= 256
        and cand_c % 8 == 0
    )


def _rank_insert2(v, c, p0, p1, q0, q1):
    """Merge two new (value, col) candidates per row -- p0 >= p1, -inf for
    absent -- into the row-major sorted-desc running top-C ``(v, c)`` by
    rank arithmetic (pallas_kernels.py:362-380): ``i0 = #(v > p0)``,
    ``i1 = #(v > p1) + 1``, so new entries go after equal old ones."""
    m, cand_c = v.shape
    i0 = (v > p0[:, None]).sum(1, dtype=torch.int32)[:, None]
    i1 = (v > p1[:, None]).sum(1, dtype=torch.int32)[:, None] + 1
    k = torch.arange(cand_c, dtype=torch.int32, device=v.device)[None, :]
    shift = (k > i0).to(torch.int32) + (k > i1).to(torch.int32)
    v1, v2 = torch.roll(v, 1, 1), torch.roll(v, 2, 1)
    c1, c2 = torch.roll(c, 1, 1), torch.roll(c, 2, 1)
    vs = torch.where(shift == 0, v, torch.where(shift == 1, v1, v2))
    cs = torch.where(shift == 0, c, torch.where(shift == 1, c1, c2))
    new_v = torch.where(k == i0, p0[:, None], torch.where(k == i1, p1[:, None], vs))
    new_c = torch.where(k == i0, q0[:, None], torch.where(k == i1, q1[:, None], cs))
    return new_v, new_c


def _tile_top2(s: torch.Tensor, thr: float, dim: int, minidx: bool = False):
    """Closed-form top-2 of a thresholded score block along ``dim``
    (``_p1_body``'s reductions): ``(cnt, s1, vmax, cmax, vmax2)`` -- the
    qualified count, the sum of the qualified indices, the maximum and its
    first index (``jnp.argmax``), and the maximum with that index masked.
    ``minidx``: the first index written as ``_p1_body_minidx`` does
    (benchmarks/ab_p1_epilogue.py:118-120), the smallest index among the
    maxima, 0 where nothing qualifies."""
    mask = s >= thr
    ubm = torch.where(mask, s, _NEG)
    shape = [1] * s.dim()
    shape[dim] = s.shape[dim]
    idx = torch.arange(s.shape[dim], dtype=torch.int32, device=s.device).view(shape)
    cnt = mask.sum(dim, dtype=torch.int32)
    s1 = torch.where(mask, idx, 0).sum(dim, dtype=torch.int32)
    vmax = ubm.max(dim).values
    if minidx:
        at_max = ubm == vmax.unsqueeze(dim)
        cmax = torch.where(at_max, idx, s.shape[dim]).min(dim).values
        cmax = torch.where(vmax > _NEG, cmax, 0).to(torch.int32)
    else:
        cmax = ubm.argmax(dim).to(torch.int32)  # first maximum, as jnp.argmax
    vmax2 = ubm.scatter(dim, cmax.unsqueeze(dim).long(), _NEG).max(dim).values
    return cnt, s1, vmax, cmax, vmax2


def p1_chain_init(m: int, cand_c: int, device=None):
    """Initial state of the chained phase 1 (``p1_chain_init``,
    pallas_kernels.py:259-272): ``(v, c, meta, tb)`` -- the running top-C
    values (-inf) and columns, the per-row counters ``meta`` (m, 3) int32
    [counts, tmax, nfin] and the per-tile drop bound ``tb`` (-inf).  The
    counters are int32, so they stay exact at any corpus size (the JAX
    kernel packs them into f32, exact below 2^24)."""
    return (
        torch.full((m, cand_c), _NEG, dtype=torch.float32, device=device),
        torch.zeros((m, cand_c), dtype=torch.int32, device=device),
        torch.zeros((m, 3), dtype=torch.int32, device=device),
        torch.full((m,), _NEG, dtype=torch.float32, device=device),
    )


def p1_fused_chain_plain(a_hash, b_chunk, thr_eff: float, col_off: int,
                         state, tile: int = 4096, cand_c: int = 64,
                         minidx: bool = False):
    """Plain PyTorch version of one chained phase-1 pass
    (``_p1_chain_body``, pallas_kernels.py:183-257): ``_p1_body`` over the
    column chunk ``b_chunk`` (global columns ``col_off`` ..), resuming from
    ``state = (v, c, meta, tb)`` (``p1_chain_init``) and writing the new
    state back into those tensors.  Chained passes over tile-aligned chunks
    are bitwise one pass over the concatenated columns.  Returns ``(ship,
    counts, tmax, bound, max_cnt, state)``; ship and bound cover the
    columns seen so far.  ``minidx``: the tile argmax as the smallest column
    among the maxima (``p1_closed2_variant_plain``), the same column."""
    v0, c0, meta, tb0 = state
    a = a_hash.float()
    thr = float(thr_eff)
    v, c, tb = v0, c0, tb0
    counts, tmax, nfin = meta[:, 0], meta[:, 1], meta[:, 2]
    for j in range(b_chunk.shape[0] // tile):
        with ieee_f32_matmul():
            s = a @ b_chunk[j * tile:(j + 1) * tile].float().T
        cnt, s1, vmax, cmax, vmax2 = _tile_top2(s, thr, 1, minidx)
        have1, have2 = cnt >= 1, cnt == 2
        off = col_off + j * tile
        p0 = torch.where(have1, vmax, _NEG)
        p1 = torch.where(have2, vmax2, _NEG)
        q0 = torch.where(have1, cmax, 0) + off
        q1 = torch.where(have2, s1 - cmax, 0) + off
        counts = counts + cnt
        tmax = torch.maximum(tmax, cnt)
        tb = torch.maximum(tb, torch.where(cnt > 2, vmax2, _NEG))
        nfin = nfin + have1.to(torch.int32) + have2.to(torch.int32)
        v, c = _rank_insert2(v, c, p0, p1, q0, q1)
    v0.copy_(v)
    c0.copy_(c)
    meta.copy_(torch.stack([counts, tmax, nfin], 1))
    tb0.copy_(tb)
    trunc = torch.where(nfin > cand_c, v[:, cand_c - 1], _NEG)
    bound = torch.maximum(tb, trunc)
    ship = torch.where(v > _NEG, c, -1)
    return ship, counts, tmax, bound, tmax.max(), state


def p1_fused_closed2_plain(a_hash, b_hash, thr_eff: float, tile: int = 4096,
                           cand_c: int = 64):
    """Plain PyTorch version of the fused phase-1 pass (``_p1_body``,
    pallas_kernels.py:47-114): per logical tile of ``tile`` columns, the
    f32 product of the bf16 inputs, threshold, closed-form top-2, per-row
    counters and drop bound, and the rank insert into a running top-C.
    Returns ``(ship, counts, tmax, bound, max_cnt)``: one chained pass from
    the initial state."""
    state = p1_chain_init(a_hash.shape[0], cand_c, a_hash.device)
    return p1_fused_chain_plain(a_hash, b_hash, thr_eff, 0, state, tile,
                                cand_c)[:5]


def p1_fused_closed2(a_hash: torch.Tensor, b_hash: torch.Tensor,
                     thr_eff: float, tile: int = 4096, cand_c: int = 64):
    """Whole-segment fused phase 1: ``(ship, counts, tmax, bound, max_cnt)``
    -- the (m, cand_c) int32 candidate matrix with -1 sentinels and each
    row's valid entries in a descending-UB prefix, per-row qualified
    counts, per-tile maximum counts, drop bounds, and the segment-wide
    maximum per-tile count (device scalar).  CUDA tensors launch
    csrc/p1_fused_closed2.cu; CPU tensors run the plain version."""
    m, d = a_hash.shape
    n = b_hash.shape[0]
    if not a_hash.is_cuda:
        return p1_fused_closed2_plain(a_hash, b_hash, thr_eff, tile, cand_c)
    _check_tensors("p1_fused_closed2", a_hash, b_hash)
    if a_hash.dtype != torch.bfloat16 or b_hash.dtype != torch.bfloat16:
        raise TypeError("p1_fused_closed2: a_hash and b_hash must be bfloat16")
    if b_hash.shape[1] != d:
        raise ValueError("p1_fused_closed2: hash widths differ")
    if not p1_fused_supported(m, n, d, tile, cand_c):
        raise ValueError(
            f"p1_fused_closed2: unsupported shape m={m} n={n} d={d} "
            f"tile={tile} cand_c={cand_c}"
        )
    lib = _build.load("p1_fused_closed2")
    dev = a_hash.device
    ship = torch.empty((m, cand_c), dtype=torch.int32, device=dev)
    counts = torch.empty(m, dtype=torch.int32, device=dev)
    tmax = torch.empty(m, dtype=torch.int32, device=dev)
    bound = torch.empty(m, dtype=torch.float32, device=dev)
    vbuf = torch.empty((m, cand_c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.p1_fused_closed2(
            a_hash.data_ptr(), b_hash.data_ptr(), float(thr_eff), m, n, d,
            tile, cand_c, ship.data_ptr(), counts.data_ptr(), tmax.data_ptr(),
            bound.data_ptr(), vbuf.data_ptr(), _stream(a_hash),
        )
    _build.check("p1_fused_closed2", err)
    _launched("p1_fused_closed2", dev)
    return ship, counts, tmax, bound, tmax.max()


def p1_fused_chain(a_hash: torch.Tensor, b_chunk: torch.Tensor,
                   thr_eff: float, col_off: int, state, tile: int = 4096,
                   cand_c: int = 64):
    """One chained phase-1 pass over a right column chunk whose first
    global column is ``col_off``: ``(ship, counts, tmax, bound, max_cnt,
    state)``.  The state ``(v, c, meta, tb)`` (``p1_chain_init``) is
    updated in place, as the JAX kernel's ``input_output_aliases`` do; the
    column ids of -inf slots in ``c`` are unspecified (the kernel skips the
    inserts of tiles without a qualified column), every consumer masks
    them.  With tile-aligned chunks, the last pass's results are bitwise
    ``p1_fused_closed2`` over the concatenated chunks.  CUDA tensors launch
    csrc/p1_fused_chain.cu; CPU tensors run the plain version."""
    m, d = a_hash.shape
    n = b_chunk.shape[0]
    if not a_hash.is_cuda:
        return p1_fused_chain_plain(a_hash, b_chunk, thr_eff, col_off, state,
                                    tile, cand_c)
    v, c, meta, tb = state
    _check_tensors("p1_fused_chain", a_hash, b_chunk, v, c, meta, tb)
    if a_hash.dtype != torch.bfloat16 or b_chunk.dtype != torch.bfloat16:
        raise TypeError("p1_fused_chain: a_hash and b_chunk must be bfloat16")
    if (v.dtype, c.dtype, meta.dtype, tb.dtype) != (
        torch.float32, torch.int32, torch.int32, torch.float32
    ):
        raise TypeError("p1_fused_chain: state must be (f32, i32, i32, f32)")
    if (b_chunk.shape[1] != d or v.shape != (m, cand_c)
            or c.shape != (m, cand_c) or meta.shape != (m, 3)
            or tb.shape != (m,)):
        raise ValueError("p1_fused_chain: hash widths or state shapes differ")
    if not p1_fused_supported(m, n, d, tile, cand_c) or col_off + n >= 2 ** 31:
        raise ValueError(
            f"p1_fused_chain: unsupported shape m={m} n={n} d={d} "
            f"tile={tile} cand_c={cand_c} col_off={col_off}"
        )
    lib = _build.load("p1_fused_chain")
    dev = a_hash.device
    ship = torch.empty((m, cand_c), dtype=torch.int32, device=dev)
    counts = torch.empty(m, dtype=torch.int32, device=dev)
    tmax = torch.empty(m, dtype=torch.int32, device=dev)
    bound = torch.empty(m, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.p1_fused_chain(
            a_hash.data_ptr(), b_chunk.data_ptr(), float(thr_eff),
            int(col_off), m, n, d, tile, cand_c, v.data_ptr(), c.data_ptr(),
            meta.data_ptr(), tb.data_ptr(), ship.data_ptr(),
            counts.data_ptr(), tmax.data_ptr(), bound.data_ptr(),
            _stream(a_hash),
        )
    _build.check("p1_fused_chain", err)
    _launched("p1_fused_chain", dev)
    return ship, counts, tmax, bound, tmax.max(), state


# ------------------------------------- the epilogue's A/B: floor and variant
def p1_mm_floor_supported(m: int, n: int, d: int) -> bool:
    """Shapes ``p1_mm_floor`` takes: the scan's (d a multiple of 128 up to
    512, whole pairs of 128-column sub-blocks), any number of rows."""
    return d % 128 == 0 and 0 < d <= 512 and m > 0 and n > 0 and n % 256 == 0


def p1_mm_floor_plain(a_hash, b_hash, thr_eff: float,
                      tile: int = 4096) -> torch.Tensor:
    """Plain PyTorch version of ``p1_mm_floor``: per left row, the count of
    right columns whose f32 product of the bf16 inputs is >= ``thr_eff``
    (``_mm_body``, benchmarks/ab_p1_epilogue.py:56-62), column tile by
    column tile.  (m,) int32."""
    a = a_hash.float()
    thr = float(thr_eff)
    counts = torch.zeros(a.shape[0], dtype=torch.int32, device=a.device)
    for lo in range(0, b_hash.shape[0], tile):
        with ieee_f32_matmul():
            s = a @ b_hash[lo:lo + tile].float().T
        counts += (s >= thr).sum(1, dtype=torch.int32)
    return counts


def p1_mm_floor(a_hash: torch.Tensor, b_hash: torch.Tensor,
                thr_eff: float) -> torch.Tensor:
    """Per left row, the count of right columns with s = A . B^T >= thr
    (bf16 products, f32 accumulation) over all of B: the quantity of
    ``p1_fused_closed2``'s ``counts`` with no candidate work, the floor
    under its epilogue.  Replaces the Pallas A/B probe ``mm_floor``
    (benchmarks/ab_p1_epilogue.py:65-88).  CUDA tensors launch
    csrc/p1_mm_floor.cu (mode kCount of the scan: bitwise
    ``p1_fused_closed2``'s counts on the same inputs); CPU tensors run the
    plain version."""
    if not a_hash.is_cuda:
        return p1_mm_floor_plain(a_hash, b_hash, thr_eff)
    m, d = a_hash.shape
    n = b_hash.shape[0]
    _check_tensors("p1_mm_floor", a_hash, b_hash)
    if a_hash.dtype != torch.bfloat16 or b_hash.dtype != torch.bfloat16:
        raise TypeError("p1_mm_floor: a_hash and b_hash must be bfloat16")
    if b_hash.shape[1] != d:
        raise ValueError("p1_mm_floor: hash widths differ")
    if not p1_mm_floor_supported(m, n, d):
        raise ValueError(f"p1_mm_floor: unsupported shape m={m} n={n} d={d}")
    lib = _build.load("p1_mm_floor")
    dev = a_hash.device
    counts = torch.empty(m, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.p1_mm_floor(a_hash.data_ptr(), b_hash.data_ptr(),
                              float(thr_eff), m, n, d, counts.data_ptr(),
                              _stream(a_hash))
    _build.check("p1_mm_floor", err)
    _launched("p1_mm_floor", dev)
    return counts


#: p1_closed2_variant's switches: the left rows of a block, the tie rule
VARIANT_BLOCK_ROWS = (128, 64)
VARIANT_ARGMAX = ("first", "minidx")


def _variant_switches(block_rows: int, argmax: str) -> None:
    if block_rows not in VARIANT_BLOCK_ROWS or argmax not in VARIANT_ARGMAX:
        raise ValueError(
            f"p1_closed2_variant: block_rows must be one of {VARIANT_BLOCK_ROWS} and "
            f"argmax one of {VARIANT_ARGMAX}, not {block_rows!r}, {argmax!r}"
        )


def p1_closed2_variant_plain(a_hash, b_hash, thr_eff: float, tile: int = 4096,
                             cand_c: int = 64, block_rows: int = 128,
                             argmax: str = "first"):
    """Plain PyTorch version of ``p1_closed2_variant``: ``_p1_body`` per
    logical tile, with the tile argmax written as ``argmax`` says --
    ``"first"``: the first maximum (``jnp.argmax``); ``"minidx"``:
    literally the smallest column among the maxima, 0 where the tile has
    no qualified score (``_p1_body_minidx``, benchmarks/ab_p1_epilogue.py:
    92-157).  Rows are independent, so ``block_rows`` (the kernel's
    schedule) does not change the result; it is checked, not used.
    Returns ``(ship, counts, tmax, bound, max_cnt)``."""
    _variant_switches(block_rows, argmax)
    state = p1_chain_init(a_hash.shape[0], cand_c, a_hash.device)
    return p1_fused_chain_plain(a_hash, b_hash, thr_eff, 0, state, tile,
                                cand_c, minidx=argmax == "minidx")[:5]


def p1_closed2_variant(a_hash: torch.Tensor, b_hash: torch.Tensor,
                       thr_eff: float, tile: int = 4096, cand_c: int = 64,
                       block_rows: int = 128, argmax: str = "first"):
    """``p1_fused_closed2`` under two switches: ``argmax`` ("first": the
    shipped rule; "minidx": the smallest column among the maxima) and
    ``block_rows`` (128: the shipped block; 64: one consumer warpgroup, so
    every block streams all of B for half the rows).  Replaces the Pallas
    A/B probe ``variant`` (benchmarks/ab_p1_epilogue.py:160-200; its
    ``bm`` sweep :207-214).  Returns ``(ship, counts, tmax, bound,
    max_cnt)``, bitwise ``p1_fused_closed2``'s under every switch.  CUDA
    tensors launch csrc/p1_closed2_variant.cu; CPU tensors run the plain
    version."""
    _variant_switches(block_rows, argmax)
    if not a_hash.is_cuda:
        return p1_closed2_variant_plain(a_hash, b_hash, thr_eff, tile, cand_c,
                                        block_rows, argmax)
    m, d = a_hash.shape
    n = b_hash.shape[0]
    _check_tensors("p1_closed2_variant", a_hash, b_hash)
    if a_hash.dtype != torch.bfloat16 or b_hash.dtype != torch.bfloat16:
        raise TypeError("p1_closed2_variant: a_hash and b_hash must be bfloat16")
    if b_hash.shape[1] != d:
        raise ValueError("p1_closed2_variant: hash widths differ")
    if not p1_fused_supported(m, n, d, tile, cand_c):
        raise ValueError(
            f"p1_closed2_variant: unsupported shape m={m} n={n} d={d} "
            f"tile={tile} cand_c={cand_c}"
        )
    lib = _build.load("p1_closed2_variant")
    dev = a_hash.device
    ship = torch.empty((m, cand_c), dtype=torch.int32, device=dev)
    counts = torch.empty(m, dtype=torch.int32, device=dev)
    tmax = torch.empty(m, dtype=torch.int32, device=dev)
    bound = torch.empty(m, dtype=torch.float32, device=dev)
    vbuf = torch.empty((m, cand_c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.p1_closed2_variant(
            a_hash.data_ptr(), b_hash.data_ptr(), float(thr_eff), m, n, d,
            tile, cand_c, block_rows, int(argmax == "minidx"),
            ship.data_ptr(), counts.data_ptr(), tmax.data_ptr(),
            bound.data_ptr(), vbuf.data_ptr(), _stream(a_hash),
        )
    _build.check("p1_closed2_variant", err)
    _launched("p1_closed2_variant", dev)
    return ship, counts, tmax, bound, tmax.max()


# ------------------------------------------------ kernel 3: triangular p1
#: Packed future state: per right row, TRI_FUT_C candidate values, their
#: column ids (int32 bit patterns in f32 slots) and 8 metadata slots
#: [cnt, tmax, bound, nfin, 0, 0, 0, 0] (pallas_kernels.py:384-411).
TRI_FUT_C = 60
_TRI_META_OFF = 2 * TRI_FUT_C


def tri_future_init(n_pad: int, device=None) -> torch.Tensor:
    """Initial packed future state: values -inf, cols 0, meta 0 except the
    bound slot (-inf)."""
    f = torch.zeros((n_pad, 128), dtype=torch.float32, device=device)
    f[:, :TRI_FUT_C] = _NEG
    f[:, _TRI_META_OFF + 2] = _NEG
    return f


def tri_future_unpack(fpack: torch.Tensor):
    """(values, cols, meta) views of the packed future state; cols are the
    int32 view of their f32 slots."""
    return (
        fpack[:, :TRI_FUT_C],
        fpack[:, TRI_FUT_C:_TRI_META_OFF].view(torch.int32),
        fpack[:, _TRI_META_OFF:],
    )


def p1_tri_supported(seg_rows: int, n_pad: int, d: int, tile: int,
                     cand_c: int, block_m: int = 512) -> bool:
    """Shapes the triangular kernel takes: ``p1_fused_supported``'s row
    side, whole tiles per segment, ``block_m`` sub-blocks made of whole
    128-row chunks (the kernel's column statistics merge exactly into
    them), and fewer than 2^24 columns (the packed meta counts in f32)."""
    return (
        p1_fused_supported(seg_rows, n_pad, d, tile, cand_c)
        and seg_rows % tile == 0
        and tile <= seg_rows <= n_pad
        and block_m % 128 == 0
        and tile % block_m == 0
        and n_pad < (1 << 24)
    )


def p1_tri_fused_plain(a_seg, b_hash, fpack, j0: int, thr_eff: float,
                       tile: int = 4096, cand_c: int = 64,
                       block_m: int = 512):
    """Plain PyTorch version of the triangular self-join phase 1 for one
    segment (``_p1_tri_body``, pallas_kernels.py:414-623): the segment's
    rows (global rows from ``j0 * tile``) against right tiles j >= j0, each
    (tile I, tile j) product once.  Row side: ``_p1_body``'s closed form
    per (row, tile j), rank-inserted in j order; meta [cnt, tmax, bound,
    nfin].  Column side (j >= j0 + cpg): the closed form per column over
    each ``block_m``-row sub-block k, sorted-pair merged over k, then
    rank-inserted into future block j of ``fpack`` in I order (in place).
    Returns ``(rv, rc, rmeta, fpack)``."""
    seg_rows = a_seg.shape[0]
    n_pad = b_hash.shape[0]
    dev = a_seg.device
    nt = n_pad // tile
    bm = min(block_m, tile)
    tpb = tile // bm
    cpg = seg_rows // tile
    thr = float(thr_eff)
    a = a_seg.float()
    rv = torch.full((seg_rows, cand_c), _NEG, dtype=torch.float32, device=dev)
    rc = torch.zeros((seg_rows, cand_c), dtype=torch.int32, device=dev)
    rmeta = torch.zeros((seg_rows, 8), dtype=torch.float32, device=dev)
    rmeta[:, 2] = _NEG
    fv, fc, fm = tri_future_unpack(fpack)
    neg = torch.full((tile,), _NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros(tile, dtype=torch.int32, device=dev)
    for i in range(cpg):
        rows = slice(i * tile, (i + 1) * tile)
        v, c = rv[rows], rc[rows]
        m_cnt, m_tmax, m_bnd, m_nfin = rmeta[rows, :4].unbind(1)
        for j in range(j0, nt):
            with ieee_f32_matmul():
                s = a[rows] @ b_hash[j * tile:(j + 1) * tile].float().T
            # row side
            cnt, s1, vmax, cmax, vmax2 = _tile_top2(s, thr, 1)
            have1, have2 = cnt >= 1, cnt == 2
            off = j * tile
            v, c = _rank_insert2(
                v, c,
                torch.where(have1, vmax, _NEG), torch.where(have2, vmax2, _NEG),
                torch.where(have1, cmax, 0) + off,
                torch.where(have2, s1 - cmax, 0) + off,
            )
            cntf = cnt.float()
            m_cnt = m_cnt + cntf
            m_tmax = torch.maximum(m_tmax, cntf)
            m_bnd = torch.maximum(m_bnd, torch.where(cnt > 2, vmax2, _NEG))
            m_nfin = m_nfin + (have1.to(torch.int32) + have2.to(torch.int32)).float()
            if j < j0 + cpg:
                continue
            # column side: per block_m-row sub-block k, merged in k order
            ccnt, cs1, cvmax, ccmax, cvmax2 = _tile_top2(
                s.view(tpb, bm, tile), thr, 1
            )
            a0, a1, ca0, ca1 = neg, neg, zero, zero
            cm0 = torch.zeros(tile, dtype=torch.float32, device=dev)
            cm1 = neg
            for k in range(tpb):
                ch1, ch2 = ccnt[k] >= 1, ccnt[k] == 2
                roff = j0 * tile + i * tile + k * bm
                b0 = torch.where(ch1, cvmax[k], _NEG)
                b1 = torch.where(ch2, cvmax2[k], _NEG)
                d0 = torch.where(ch1, ccmax[k], 0) + roff
                d1 = torch.where(ch2, cs1[k] - ccmax[k], 0) + roff
                awins = a0 >= b0
                l0v = torch.where(awins, b0, a0)
                l0c = torch.where(awins, d0, ca0)
                wsv = torch.where(awins, a1, b1)
                wsc = torch.where(awins, ca1, d1)
                lwins = l0v >= wsv
                a0, ca0 = torch.where(awins, a0, b0), torch.where(awins, ca0, d0)
                a1 = torch.where(lwins, l0v, wsv)
                ca1 = torch.where(lwins, l0c, wsc)
                cm0 = cm0 + ccnt[k].float()
                cm1 = torch.maximum(cm1, torch.where(ccnt[k] > 2, cvmax2[k], _NEG))
            # fold tile I's column results into future block j
            cols = slice(j * tile, (j + 1) * tile)
            bnd_tile = torch.maximum(torch.where(cm0 > 2, a1, _NEG), cm1)
            nv, nc = _rank_insert2(fv[cols], fc[cols], a0, a1, ca0, ca1)
            f = fm[cols]
            nm = torch.stack([
                f[:, 0] + cm0,
                torch.maximum(f[:, 1], cm0),
                torch.maximum(f[:, 2], bnd_tile),
                f[:, 3] + (cm0 >= 1).float() + (cm0 >= 2).float(),
            ], 1)
            fv[cols] = nv
            fc[cols] = nc
            fm[cols, :4] = nm
        rv[rows] = v
        rc[rows] = c
        rmeta[rows, :4] = torch.stack([m_cnt, m_tmax, m_bnd, m_nfin], 1)
    return rv, rc, rmeta, fpack


def p1_tri_fused(a_seg: torch.Tensor, b_hash: torch.Tensor,
                 fpack: torch.Tensor, j0: int, thr_eff: float,
                 tile: int = 4096, cand_c: int = 64, block_m: int = 512):
    """Triangular self-join phase 1 for one segment (see
    ``p1_tri_fused_plain``): ``(rv, rc, rmeta, fpack)``, ``fpack`` updated
    in place.  Segments must run in order (s = 0, 1, ..., j0 = s * cpg):
    after segment s, the future rows of segment s are final.  Column ids of
    -inf slots in ``rc`` and in ``fpack`` are unspecified (the kernel skips
    inserts without a qualified score).  CUDA tensors launch
    csrc/p1_tri_fused.cu (two kernels, counted as one launch); CPU tensors
    run the plain version."""
    if not a_seg.is_cuda:
        return p1_tri_fused_plain(a_seg, b_hash, fpack, j0, thr_eff, tile,
                                  cand_c, block_m)
    seg_rows, d = a_seg.shape
    n_pad = b_hash.shape[0]
    _check_tensors("p1_tri_fused", a_seg, b_hash, fpack)
    if a_seg.dtype != torch.bfloat16 or b_hash.dtype != torch.bfloat16:
        raise TypeError("p1_tri_fused: a_seg and b_hash must be bfloat16")
    if fpack.dtype != torch.float32 or fpack.shape != (n_pad, 128):
        raise ValueError("p1_tri_fused: fpack must be (n_pad, 128) float32")
    if b_hash.shape[1] != d:
        raise ValueError("p1_tri_fused: hash widths differ")
    bm = min(block_m, tile)
    if (not p1_tri_supported(seg_rows, n_pad, d, tile, cand_c, bm)
            or not 0 <= j0 <= (n_pad - seg_rows) // tile):
        raise ValueError(
            f"p1_tri_fused: unsupported shape seg_rows={seg_rows} "
            f"n_pad={n_pad} d={d} tile={tile} cand_c={cand_c} "
            f"block_m={block_m} j0={j0}"
        )
    lib = _build.load("p1_tri_fused")
    dev = a_seg.device
    rv = torch.empty((seg_rows, cand_c), dtype=torch.float32, device=dev)
    rc = torch.empty((seg_rows, cand_c), dtype=torch.int32, device=dev)
    rmeta = torch.empty((seg_rows, 8), dtype=torch.float32, device=dev)
    # per-(128-row chunk, future column) statistics of the column side
    n_fut = n_pad - j0 * tile - seg_rows
    size = (seg_rows // 128) * n_fut
    st_i = torch.empty((3, size), dtype=torch.int32, device=dev)
    st_f = torch.empty((2, size), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.p1_tri_fused(
            a_seg.data_ptr(), b_hash.data_ptr(), float(thr_eff), int(j0),
            seg_rows, n_pad, d, tile, cand_c, bm, rv.data_ptr(),
            rc.data_ptr(), rmeta.data_ptr(), fpack.data_ptr(),
            st_i.data_ptr(), st_f.data_ptr(), _stream(a_seg),
        )
    _build.check("p1_tri_fused", err)
    _launched("p1_tri_fused", dev)
    return rv, rc, rmeta, fpack


# ---------------------------------------------------- kernel 2: device hash
def _unpack_codes(codes: torch.Tensor, width: Optional[int]) -> torch.Tensor:
    """(rows, W) int64 codes from raw uint8 rows or 6-bit-packed int32
    words (5 codes per word, ``matcher._pack_codes6``)."""
    if width is None:
        return codes.long()
    w = codes.long() & 0xFFFFFFFF
    parts = [(w >> (6 * k)) & 63 for k in range(5)]
    return torch.stack(parts, 2).reshape(codes.shape[0], -1)[:, :width]


def device_hash_codes_plain(codes, inv_norm, table_id, idf, dim: int,
                            base: int, ngram: int,
                            width: Optional[int] = None,
                            row_tile: int = 4096) -> torch.Tensor:
    """Plain PyTorch version of the projection
    ``h[i, b] = inv_norm[i] * sum_p idf[t_p] * [bucket(t_p) == b]`` over the
    row's n-gram windows p (t_p = table_id[rolling key], -1 out of
    vocabulary), as bf16: ``index_add_`` in window order, row tile by row
    tile."""
    n = codes.shape[0]
    dev = codes.device
    w = width if width is not None else codes.shape[1]
    out = torch.zeros((n, dim), dtype=torch.bfloat16, device=dev)
    if w < ngram:  # every row shorter than the n-gram size: no windows
        return out
    win = w - ngram + 1
    shift = 32 - int(dim).bit_length() + 1
    table = table_id.long()
    for lo in range(0, n, row_tile):
        c = _unpack_codes(codes[lo:lo + row_tile], width)
        r = c.shape[0]
        key = torch.zeros((r, win), dtype=torch.int64, device=dev)
        for j in range(ngram):
            key = key * base + c[:, j:j + win]
        ids = table[key]
        valid = ids >= 0
        val = torch.where(valid, idf[ids.clamp(min=0)], 0.0)
        bucket = ((ids * _KNUTH) & 0xFFFFFFFF) >> shift
        flat = torch.arange(r, device=dev)[:, None] * dim + bucket
        h = torch.zeros(r * dim, dtype=torch.float32, device=dev)
        h.index_add_(0, flat[valid], val[valid])
        h = h.view(r, dim) * inv_norm[lo:lo + r, None]
        out[lo:lo + r] = h.to(torch.bfloat16)
    return out


def device_hash_codes(codes: torch.Tensor, inv_norm: torch.Tensor,
                      table_id: torch.Tensor, idf: torch.Tensor, dim: int,
                      base: int, ngram: int,
                      width: Optional[int] = None) -> torch.Tensor:
    """(n, dim) bf16 hashed TF-IDF projection straight from cleaned
    character codes: raw uint8 (n, W) rows, or with ``width`` 6-bit-packed
    (n, ceil(width / 5)) int32 words.  CUDA tensors launch
    csrc/device_hash_codes.cu; CPU tensors run the plain version."""
    if not codes.is_cuda:
        return device_hash_codes_plain(
            codes, inv_norm, table_id, idf, dim, base, ngram, width
        )
    _check_tensors("device_hash_codes", codes, inv_norm, table_id, idf)
    packed = width is not None
    want = torch.int32 if packed else torch.uint8
    if codes.dtype != want:
        raise TypeError(f"device_hash_codes: codes must be {want}")
    if (inv_norm.dtype, table_id.dtype, idf.dtype) != (
        torch.float32, torch.int32, torch.float32
    ):
        raise TypeError("device_hash_codes: inv_norm/idf float32, table_id int32")
    if dim < 2 or dim & (dim - 1) or dim > (1 << 15):
        raise ValueError("device_hash_codes: dim must be a power of two <= 32768")
    n, stride = codes.shape
    w = width if packed else stride
    if packed and stride != -(-w // 5):
        raise ValueError("device_hash_codes: packed row stride != ceil(width/5)")
    if base ** ngram > table_id.numel():
        raise ValueError("device_hash_codes: table smaller than base**ngram")
    if not 1 <= ngram <= 32:
        raise ValueError("device_hash_codes: ngram must be 1..32")
    out = torch.empty((n, dim), dtype=torch.bfloat16, device=codes.device)
    if n == 0:
        return out
    lib = _build.load("device_hash_codes")
    with torch.cuda.device(codes.device):
        err = lib.device_hash_codes(
            codes.data_ptr(), int(packed), stride, w, inv_norm.data_ptr(),
            table_id.data_ptr(), idf.data_ptr(), n, dim, base, ngram,
            out.data_ptr(), _stream(codes),
        )
    _build.check("device_hash_codes", err)
    _launched("device_hash_codes", codes.device)
    return out
