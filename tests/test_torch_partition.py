"""The port's partition primitives (ops/partition.py, ops/segops.py) and
the radix frame's pass and planner (joins/radix.py) against the JAX
package's, on the CPU, on the same numpy inputs.  Every comparison is
exact: these are integers."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.config import JoinConfig as JConfig
from aqp_tpu.joins import radix as jradix
from aqp_tpu.ops import partition as jpart
from aqp_tpu.ops import segops as jseg
from aqp_tpu_torch.config import JoinConfig as TConfig
from aqp_tpu_torch.joins import radix as tradix
from aqp_tpu_torch.ops import partition as tpart
from aqp_tpu_torch.ops import segops as tseg


def _keys(n, seed, lo=-(1 << 31), hi=1 << 31):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32),
            rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
            .astype(np.int32))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [1, 4, 9])
def test_radix_histogram_and_offsets(bits):
    rng = np.random.default_rng(bits)
    # in-range buckets, plus values the histogram must not count
    b = np.concatenate([rng.integers(0, 1 << bits, 5000),
                        [-1, 1 << bits, (1 << bits) + 7]]).astype(np.int32)
    h = tpart.radix_histogram(torch.from_numpy(b), bits)
    assert h.dtype == torch.int32
    _eq(h, jpart.radix_histogram(jnp.asarray(b), bits))
    _eq(tpart.partition_offsets(h), jpart.partition_offsets(jnp.asarray(
        h.numpy())))


@pytest.mark.parametrize("shift,bits", [(0, 4), (5, 8), (28, 4)])
def test_radix_partition_is_stable_and_equal(shift, bits):
    key, pay = _keys(6000, shift + bits)
    jk, jp, jh = jpart.radix_partition(jnp.asarray(key), jnp.asarray(pay),
                                       shift, bits)
    tk, tp, th = tpart.radix_partition(torch.from_numpy(key),
                                       torch.from_numpy(pay), shift, bits)
    for g, w in ((tk, jk), (tp, jp), (th, jh)):
        _eq(g, w)


@pytest.mark.parametrize("shift,bits", [(0, 1), (0, 7), (7, 6), (3, 0)])
def test_partition_pass_matches_reference(shift, bits):
    key, pay = _keys(5000, 40 + bits, 0, 1 << 30)
    want = jradix._partition_pass_jit(jnp.asarray(key), jnp.asarray(pay),
                                      shift, bits)
    got = tradix._partition_pass(torch.from_numpy(key),
                                 torch.from_numpy(pay), shift, bits)
    for g, w in zip(got, want):
        _eq(g, w)


PLANS = [
    (0, {}), (1, {}), (8192, {}), (8193, {}), (13_107_200, {}),
    (1 << 30, {}), (100_000, {"radix_bits": 10}),
    (100_000, {"passes": 2}), (100_000, {"radix_bits": 14, "passes": 1}),
    (50_000, {"partition_rows": 1000}),
]


@pytest.mark.parametrize("num_r,fields", PLANS,
                         ids=[f"{n}-{'-'.join(f) or 'default'}"
                              for n, f in PLANS])
def test_plan_radix_matches_reference(num_r, fields):
    assert tradix.plan_radix(num_r, TConfig(**fields)) == \
        jradix.plan_radix(num_r, JConfig(**fields))


@pytest.mark.parametrize("bits", [1, 11, 24])
def test_rotation_matches_reference(bits):
    key, _ = _keys(4000, bits, -5, 1 << 30)
    key[:3] = (-3, 0, (1 << 30) - 1)
    got = tradix._rot(torch.from_numpy(key), bits)
    _eq(got, jradix._rot(jnp.asarray(key), bits))
    _eq(tradix._rot_inv(got, bits), key)


def test_exclusive_cumsum_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.integers(-1000, 1000, (5, 300)).astype(np.int32)
    for axis in (0, -1):
        got = tseg.exclusive_cumsum(torch.from_numpy(x), axis)
        assert got.dtype == torch.int32
        _eq(got, jseg.exclusive_cumsum(jnp.asarray(x), axis))
    m = rng.random(500) < 0.3
    _eq(tseg.exclusive_cumsum(torch.from_numpy(m)),
        jseg.exclusive_cumsum(jnp.asarray(m)))


def test_histogram_matches_reference():
    rng = np.random.default_rng(3)
    b = np.concatenate([rng.integers(0, 64, 3000), [-2, -1, 64, 99]])
    b = b.astype(np.int32)
    got = tseg.histogram(torch.from_numpy(b), 64)
    assert got.dtype == torch.int32
    _eq(got, jseg.histogram(jnp.asarray(b), 64))


@pytest.mark.parametrize("capacity", [50, 700, 2000])
def test_compact_matches_reference(capacity):
    rng = np.random.default_rng(capacity)
    mask = rng.random(1500) < 0.4
    a = rng.integers(-(1 << 31), 1 << 31, 1500, dtype=np.int64)
    a = a.astype(np.int32)
    b = rng.integers(0, 255, 1500).astype(np.uint8)
    out, cnt = tseg.compact(torch.from_numpy(mask), torch.from_numpy(a),
                            capacity, fill=-7)
    jout, jcnt = jseg.compact(jnp.asarray(mask), jnp.asarray(a), capacity,
                              fill=-7)
    _eq(out, jout)
    assert int(cnt) == int(jcnt)
    outs, cnt = tseg.compact_many(torch.from_numpy(mask),
                                  (torch.from_numpy(a), torch.from_numpy(b)),
                                  capacity)
    jouts, jcnt = jseg.compact_many(jnp.asarray(mask),
                                    (jnp.asarray(a), jnp.asarray(b)),
                                    capacity)
    assert int(cnt) == int(jcnt)
    for g, w in zip(outs, jouts):
        assert g.numpy().dtype == np.asarray(w).dtype
        _eq(g, w)
