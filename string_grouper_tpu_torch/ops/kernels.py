"""The hand-written CUDA kernels of the matcher, each beside its plain
PyTorch version (the counterpart of ``string_grouper_tpu.ops.
pallas_kernels``).

Every wrapper launches its kernel for CUDA tensors -- or raises: nothing
falls back to the plain version on the card.  Tensors on the CPU take the
plain version, which is what the CPU tests run.  ``LAUNCHES`` counts each
wrapper's kernel launches (and nothing else), so a run can show that the
main path went through the kernels.

* ``p1_fused_closed2`` (csrc/p1_fused_closed2.cu) replaces the Pallas kernel
  of the same name (string_grouper_tpu/ops/pallas_kernels.py:117-179).
* ``device_hash_codes`` (csrc/device_hash_codes.cu) replaces the XLA
  program ``_device_hash_codes`` (string_grouper_tpu/ops/matcher.py:398-464).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build

_KNUTH = 2654435761  # Knuth multiplicative hash constant (2^32 / phi)
_NEG = float("-inf")

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {name: 0 for name in _build.KERNELS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    because the CUDA kernel keeps its 128 left rows of width d in shared
    memory (128 x 520 bf16 = 133 KB of the block's 227 KB)."""
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


def p1_fused_closed2_plain(a_hash, b_hash, thr_eff: float, tile: int = 4096,
                           cand_c: int = 64):
    """Plain PyTorch version of the fused phase-1 pass (``_p1_body``,
    pallas_kernels.py:47-114): per logical tile of ``tile`` columns, the
    f32 product of the bf16 inputs, threshold, closed-form top-2, per-row
    counters and drop bound, and the rank insert into a running top-C.
    Returns ``(ship, counts, tmax, bound, max_cnt)``."""
    m = a_hash.shape[0]
    n = b_hash.shape[0]
    dev = a_hash.device
    a = a_hash.float()
    thr = float(thr_eff)
    v = torch.full((m, cand_c), _NEG, dtype=torch.float32, device=dev)
    c = torch.zeros((m, cand_c), dtype=torch.int32, device=dev)
    counts = torch.zeros(m, dtype=torch.int32, device=dev)
    tmax = torch.zeros(m, dtype=torch.int32, device=dev)
    nfin = torch.zeros(m, dtype=torch.int32, device=dev)
    tb = torch.full((m,), _NEG, dtype=torch.float32, device=dev)
    col = torch.arange(tile, dtype=torch.int32, device=dev)
    for j in range(n // tile):
        s = a @ b_hash[j * tile:(j + 1) * tile].float().T
        mask = s >= thr
        ubm = torch.where(mask, s, _NEG)
        cnt = mask.sum(1, dtype=torch.int32)
        s1 = torch.where(mask, col, 0).sum(1, dtype=torch.int32)
        vmax = ubm.max(1).values
        cmax = ubm.argmax(1).to(torch.int32)  # first maximum, as jnp.argmax
        vmax2 = ubm.scatter(1, cmax[:, None].long(), _NEG).max(1).values
        have1, have2 = cnt >= 1, cnt == 2
        off = j * tile
        p0 = torch.where(have1, vmax, _NEG)
        p1 = torch.where(have2, vmax2, _NEG)
        q0 = torch.where(have1, cmax, 0) + off
        q1 = torch.where(have2, s1 - cmax, 0) + off
        counts += cnt
        tmax = torch.maximum(tmax, cnt)
        tb = torch.maximum(tb, torch.where(cnt > 2, vmax2, _NEG))
        nfin += have1.to(torch.int32) + have2.to(torch.int32)
        v, c = _rank_insert2(v, c, p0, p1, q0, q1)
    trunc = torch.where(nfin > cand_c, v[:, cand_c - 1], _NEG)
    bound = torch.maximum(tb, trunc)
    ship = torch.where(v > _NEG, c, -1)
    return ship, counts, tmax, bound, tmax.max()


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
    err = lib.p1_fused_closed2(
        a_hash.data_ptr(), b_hash.data_ptr(), float(thr_eff), m, n, d, tile,
        cand_c, ship.data_ptr(), counts.data_ptr(), tmax.data_ptr(),
        bound.data_ptr(), vbuf.data_ptr(), _stream(a_hash),
    )
    _build.check("p1_fused_closed2", err)
    LAUNCHES["p1_fused_closed2"] += 1
    return ship, counts, tmax, bound, tmax.max()


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
    out = torch.empty((n, dim), dtype=torch.bfloat16, device=codes.device)
    if n == 0:
        return out
    lib = _build.load("device_hash_codes")
    err = lib.device_hash_codes(
        codes.data_ptr(), int(packed), stride, w, inv_norm.data_ptr(),
        table_id.data_ptr(), idf.data_ptr(), n, dim, base, ngram,
        out.data_ptr(), _stream(codes),
    )
    _build.check("device_hash_codes", err)
    LAUNCHES["device_hash_codes"] += 1
    return out
