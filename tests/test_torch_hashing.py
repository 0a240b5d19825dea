"""The port's hash functions against the JAX package's, bit for bit, on the
same numpy keys (negatives, zero and the int32 extremes included)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.ops import hashing as jh
from aqp_tpu_torch.ops import hashing as th


def _keys32():
    rng = np.random.default_rng(17)
    edge = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**30 - 2, 2**30 - 1,
                     0x9E3779B1 - 2**32], dtype=np.int64)
    return np.concatenate([edge, rng.integers(-2**31, 2**31, 5000)]
                          ).astype(np.int32)


def _same(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    got = t.numpy()
    if j.dtype == np.uint32:       # the port holds uint32 values in int64
        assert got.dtype == np.int64
        assert got.min() >= 0 and got.max() < 2**32
        j = j.astype(np.int64)
    else:
        assert got.dtype == j.dtype
    np.testing.assert_array_equal(got, j)


@pytest.mark.parametrize("bits", [1, 4, 13, 24, 31])
def test_fib_hash32(bits):
    k = _keys32()
    _same(th.fib_hash32(torch.from_numpy(k), bits),
          jh.fib_hash32(jnp.asarray(k), bits))


def test_murmur_mix32():
    k = _keys32()
    _same(th.murmur_mix32(torch.from_numpy(k)),
          jh.murmur_mix32(jnp.asarray(k)))


@pytest.mark.parametrize("bits,salt", [(3, 0), (10, 0), (10, 12345),
                                       (16, 0xDEADBEEF)])
def test_partition_hash(bits, salt):
    k = _keys32()
    _same(th.partition_hash(torch.from_numpy(k), bits, salt),
          jh.partition_hash(jnp.asarray(k), bits, salt))


@pytest.mark.parametrize("shift,bits", [(0, 4), (5, 11), (20, 10), (28, 3)])
def test_radix_bits_int32(shift, bits):
    k = _keys32()
    _same(th.radix_bits(torch.from_numpy(k), shift, bits),
          jh.radix_bits(jnp.asarray(k), shift, bits))


@pytest.mark.parametrize("shift,bits", [(0, 8), (30, 6), (36, 5)])
def test_radix_bits_int64(shift, bits):
    rng = np.random.default_rng(5)
    k = np.concatenate([np.array([0, -1, 2**40 + 3, -2**50]),
                        rng.integers(-2**62, 2**62, 3000)])
    with jax.enable_x64(True):
        want = np.asarray(jh.radix_bits(jnp.asarray(k), shift, bits))
    _same(th.radix_bits(torch.from_numpy(k), shift, bits), want)
