"""The port's rho_join_count_v3 against the JAX package's, on the CPU.

Both packages get the same numpy inputs; the JAX side runs its Pallas
kernels in interpret mode at the small geometries of tests/test_rho3.py.
Matches, checksum and the overflow verdict must agree exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.ops.pallas import rho3 as jrho3
from aqp_tpu_torch.ops.kernels import rho3 as trho3

GEOMS = {
    "small": dict(block_rows=64, slot_rows=8, f1=16, f2=4, kd_slot_rows=16),
    "hybrid": dict(block_rows=128, slot_rows=8, f1=20, f2=4, kd_slot_rows=16),
}
NR, NS = 4096, 16384   # one shape for every JAX call: one compile each


def _dataset(name, seed=7):
    rng = np.random.default_rng(seed)
    if name == "nondense":
        # unique R keys spread over [1, 2^29); half of S hits R
        rk = rng.choice(1 << 29, NR, replace=False).astype(np.int32) + 1
        sk = np.where(rng.random(NS) < 0.5, rng.choice(rk, NS),
                      rng.integers(1, 1 << 29, NS)).astype(np.int32)
    else:
        rk = rng.permutation(NR).astype(np.int32) + 1
        if name == "fk":
            sk = np.concatenate([rng.permutation(NR) + 1
                                 for _ in range(NS // NR)]).astype(np.int32)
        else:  # selective: about a third of S hits R
            sk = rng.integers(1, 3 * NR, NS, dtype=np.int32)
    rp = rng.integers(-(1 << 31), 1 << 31, NR, dtype=np.int64).astype(np.int32)
    sp = rng.integers(-(1 << 31), 1 << 31, NS, dtype=np.int64).astype(np.int32)
    return rk, rp, sk, sp


def _oracle(rk, rp, sk, sp):
    lut = dict(zip(rk.tolist(), rp.tolist()))
    m = c = 0
    for k, p in zip(sk.tolist(), sp.tolist()):
        if k in lut:
            m += 1
            c = (c + lut[k] + p) & 0xFFFFFFFF
    return m, c


def _both(data, geom, with_checksum):
    jprm = jrho3.Rho3Params(**GEOMS[geom])
    tprm = trho3.Rho3Params(**GEOMS[geom])
    jm, jc, jovf = jrho3.rho_join_count_v3(
        *map(jnp.asarray, data), prm=jprm, interpret=True,
        with_checksum=with_checksum)
    tm, tc, tovf = trho3.rho_join_count_v3(
        *map(torch.from_numpy, data), prm=tprm, with_checksum=with_checksum)
    return (int(jm), int(jc), int(jovf)), (int(tm), int(tc), int(tovf))


@pytest.mark.parametrize("with_checksum", [True, False],
                         ids=["checksum", "keys"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
@pytest.mark.parametrize("name", ["fk", "selective", "nondense"])
def test_count_v3_matches_reference(name, geom, with_checksum):
    data = _dataset(name)
    (jm, jc, jovf), (tm, tc, tovf) = _both(data, geom, with_checksum)
    assert jovf == 0
    assert tovf == 0
    assert (tm, tc) == (jm, jc)
    m, c = _oracle(*data)
    assert tm == m
    assert tc == (c if with_checksum else 0)


@pytest.mark.parametrize("copies", [NS, 3000, 600])
def test_duplicate_heavy_s_reported_or_exact(copies):
    """S with `copies` rows of one key: the reference overflows at SMALL
    (test_rho3.py's skew case); the port reports an overflow too, or
    answers exactly.  Never a wrong answer with overflow == 0."""
    rng = np.random.default_rng(5)
    rk, rp, sk, sp = _dataset("fk", seed=5)
    sk = sk.copy()
    sk[rng.choice(NS, copies, replace=False)] = 77
    data = (rk, rp, sk, sp)
    (jm, jc, jovf), (tm, tc, tovf) = _both(data, "small", True)
    if jovf == 0:
        assert tovf == 0
        assert (tm, tc) == (jm, jc)
    if tovf == 0:
        assert (tm, tc) == _oracle(*data)
    if copies == NS:
        assert jovf > 0
        assert tovf > 0     # 16384 copies of one key exceed any slot
