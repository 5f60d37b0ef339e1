"""Parity of the port's mod-2^32 helpers and Bloom-filter primitives with
the reference (``repro.core.bloom``), on random tags and on the edge
values 0, 2^31 and 2^32-1."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bloom as j_bloom  # noqa: E402
from repro_torch import _u32  # noqa: E402
from repro_torch.core import bloom as t_bloom  # noqa: E402

EDGES = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint32)


def _tags(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, 2 ** 32, size=n,
                                               dtype=np.uint32)])


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint32).view(np.int32))


def test_u32_round_trip_and_arithmetic():
    a = _tags(seed=1)
    b = _tags(seed=2)
    ta, tb = _i32(a), _i32(b)
    np.testing.assert_array_equal(_u32.to_u(ta).numpy(), a.astype(np.int64))
    np.testing.assert_array_equal(_u32.to_i32(_u32.to_u(ta)).numpy(),
                                  a.view(np.int32))
    for m in (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0xFFFFFFFF, 1):
        want = (a.astype(np.uint64) * np.uint64(m)) & np.uint64(0xFFFFFFFF)
        np.testing.assert_array_equal(_u32.mul(_u32.to_u(ta), m).numpy(),
                                      want.astype(np.int64))
    np.testing.assert_array_equal(_u32.shr(_u32.to_u(ta), 15).numpy(),
                                  (a >> 15).astype(np.int64))
    np.testing.assert_array_equal(_u32.ult(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal(
        _u32.sat_dec(ta).numpy(),
        (np.maximum(a, np.uint32(1)) - np.uint32(1)).view(np.int32))


@pytest.mark.parametrize("num_bits", [256, 64])
def test_hash_bits_match_reference(num_bits):
    tags = _tags(seed=num_bits)
    ref = np.stack([np.asarray(j_bloom._hash_bits(jnp.uint32(t), num_bits))
                    for t in tags])
    got = t_bloom._hash_bits(_i32(tags), num_bits).numpy()
    np.testing.assert_array_equal(got, ref)


def test_bit_mask_and_test_match_reference():
    rng = np.random.default_rng(5)
    words = 8
    for t in _tags(n=25, seed=3):
        bits_j = j_bloom._hash_bits(jnp.uint32(t), words * 32)
        bits_t = t_bloom._hash_bits(_i32(np.array(t, np.uint32)), words * 32)
        np.testing.assert_array_equal(
            t_bloom._bit_mask(bits_t, words).numpy().view(np.uint32),
            np.asarray(j_bloom._bit_mask(bits_j, words)))
        filt = rng.integers(0, 2 ** 32, size=words, dtype=np.uint32)
        filt &= rng.integers(0, 2 ** 32, size=words, dtype=np.uint32)
        for f in (filt, filt | np.asarray(j_bloom._bit_mask(bits_j, words))):
            want = bool(j_bloom._test(jnp.asarray(f), bits_j))
            got = bool(t_bloom._test(_i32(f), bits_t))
            assert got == want, (int(t), f)
