"""The port's ``ops/hashing.py`` against the JAX package's (the port's form
of tests/test_hashing.py): ``bucket_of`` bitwise at dims 128 and 512, the
torch op ``hashed_projection`` bitwise JAX's ``.at[].add`` (f32) and, rounded
to bf16, bitwise JAX's host form ``hashed_projection_host`` with the native
library and with its numpy fallback, and the device, host and packed-slot
forms agreeing as JAX's test requires."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from string_grouper_tpu.corpus.tfidf import EllMatrix as JEll
from string_grouper_tpu.ops import hashing as JH
from string_grouper_tpu.ops.matcher import build_hash_matrix as j_build
from string_grouper_tpu_torch import ops as TOps
from string_grouper_tpu_torch.corpus.tfidf import EllMatrix
from string_grouper_tpu_torch.ops import hashing as TH
from string_grouper_tpu_torch.ops.matcher import build_hash_matrix

CPU = torch.device("cpu")


def _rand_ell(n=64, width=16, n_terms=500, seed=0):
    """tests/test_hashing.py's corpus, element for element."""
    rng = np.random.default_rng(seed)
    ids = np.full((n, width), -1, np.int32)
    vals = np.zeros((n, width), np.float64)
    for i in range(n):
        k = int(rng.integers(3, width))
        ids[i, :k] = np.sort(rng.choice(n_terms, size=k, replace=False))
        v = rng.random(k) + 0.1
        vals[i, :k] = v / np.sqrt((v * v).sum())
    return ids, vals, n_terms


def _u32(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("dim", [128, 512])
def test_bucket_of_bitwise_jax(dim):
    rng = np.random.default_rng(dim)
    ids = np.concatenate([
        rng.integers(0, 1 << 31, 5000), [0, 1, -1, -2, (1 << 31) - 1],
        rng.integers(-(1 << 31), 0, 500),
    ]).astype(np.int32)
    got = TH.bucket_of(torch.from_numpy(ids), dim)
    want = np.asarray(JH.bucket_of(jnp.asarray(ids), dim))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < dim


@pytest.mark.parametrize("dim", [64, 256])
def test_hashed_projection_bitwise_jax(dim):
    ids, vals, _ = _rand_ell()
    v32 = vals.astype(np.float32)
    got = TH.hashed_projection(torch.from_numpy(ids), torch.from_numpy(v32),
                               dim)
    want = JH.hashed_projection(jnp.asarray(ids), jnp.asarray(v32), dim)
    assert got.dtype == torch.float32 and got.shape == (len(ids), dim)
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))


def test_hashed_projection_colliding_buckets_sum_in_slot_order():
    """Many slots of one row in one bucket (dim 2): the sums are JAX's to
    the bit, so the order is JAX's slot order."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 1000, (32, 40)).astype(np.int32)
    vals = rng.random((32, 40)).astype(np.float32) * 10 ** rng.uniform(
        -4, 2, (32, 40)).astype(np.float32)
    got = TH.hashed_projection(torch.from_numpy(ids), torch.from_numpy(vals), 2)
    want = JH.hashed_projection(jnp.asarray(ids), jnp.asarray(vals), 2)
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("dim", [128, 512])
def test_hashed_projection_host_bitwise_jax(monkeypatch, dim, native):
    """The torch op rounded to bf16 is bitwise JAX's host form, with the
    native library and with its numpy fallback (``get_scorer_lib`` patched
    to None)."""
    ids, vals, _ = _rand_ell(seed=dim)
    if not native:
        import string_grouper_tpu.native as JN

        monkeypatch.setattr(JN, "get_scorer_lib", lambda: None)
    got = TH.hashed_projection(torch.from_numpy(ids),
                               torch.from_numpy(vals.astype(np.float32)), dim)
    want = JH.hashed_projection_host(ids, vals, dim)
    np.testing.assert_array_equal(_bf16_bits(got.to(torch.bfloat16)),
                                  np.asarray(want).view(np.uint16))


def test_hash_paths_agree():
    """tests/test_hashing.py's case on the port: the torch op, JAX's host
    form and the packed-slot matrix share buckets; host is bf16 of the
    torch op's sums."""
    ids, vals, n_terms = _rand_ell()
    dim = 256
    dev = TH.hashed_projection(torch.from_numpy(ids),
                               torch.from_numpy(vals.astype(np.float32)),
                               dim).numpy()
    host = np.asarray(JH.hashed_projection_host(ids, vals, dim)).astype(np.float32)
    ell = EllMatrix(ids=ids, vals64=vals, n_terms=n_terms)
    packed = build_hash_matrix(ell, ell.n_rows, dim, CPU).float().numpy()
    np.testing.assert_array_equal(dev != 0, host != 0)
    np.testing.assert_array_equal(dev != 0, packed != 0)
    np.testing.assert_allclose(host, dev, rtol=1e-2, atol=1e-3)
    assert (packed >= dev * (1 - 0.01) - 1e-3).all()
    assert (packed <= dev * (1 + 0.01) + 1e-2).all()
    j_packed = np.asarray(j_build(JEll(ids=ids, vals64=vals, n_terms=n_terms),
                                  ell.n_rows, dim)).astype(np.float32)
    np.testing.assert_array_equal(_u32(packed), _u32(j_packed))


def test_padding_rows_hash_to_zero():
    ids, vals, n_terms = _rand_ell(n=10)
    h = build_hash_matrix(EllMatrix(ids=ids, vals64=vals, n_terms=n_terms),
                          16, 64, CPU)
    assert h.shape == (16, 64) and (h[10:] == 0).all() and (h[:10] != 0).any()
    d = TH.hashed_projection(torch.full((3, 4), -1, dtype=torch.int32),
                             torch.ones((3, 4)), 64)
    assert (d == 0).all()


def test_hashed_projection_exported_like_jax():
    assert TOps.hashed_projection is TH.hashed_projection
    assert "hashed_projection" in TOps.__all__


def test_hashed_projection_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        TH.bucket_of(torch.zeros(3, dtype=torch.int32), 100)
