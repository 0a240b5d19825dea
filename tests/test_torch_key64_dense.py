"""Dense int64 keys (R = a permutation of 1..|R|, S drawn from it) through
every join name of the port on the CPU, with RHO's dense path on and off
(off, RHO goes past its ladder to the radix frame), held to the JAX package
(int64 under jax_enable_x64, scoped to this module) and to the Python
truth; and every name's int64 answer equal to its int32 twin's, which
takes the kernels' plain versions where int64 takes none."""

import numpy as np
import pytest

from key64_cases import (MODES, NAMES, NR, NS, check_against, port,
                         reference, truth, x64)

_x64 = pytest.fixture(scope="module", autouse=True)(x64)


def dense_arrays(seed=7):
    rng = np.random.default_rng(seed)
    rk = rng.permutation(NR).astype(np.int64) + 1
    rp = rng.integers(-(1 << 40), 1 << 40, NR)
    sk = rk[rng.integers(0, NR, NS)]
    sp = rng.integers(-(1 << 40), 1 << 40, NS)
    return rk, rp, sk, sp


DENSE = dense_arrays()


@pytest.mark.parametrize("dense_path", [True, False], ids=["dense", "ladder"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", NAMES)
def test_dense_int64_keys(name, mode, dense_path):
    res = port(name, DENSE, dense_path=dense_path, **MODES[mode])
    want = truth(*DENSE)
    assert want[0] == NS
    check_against(res, mode, want, reference(name, mode, DENSE), name)


def _twins(seed):
    """A relation with misses (S keys past |R|), as int64 and as its int32
    twin (payloads in int32's range)."""
    rk, rp, sk, sp = dense_arrays(seed)
    sk[::7] += NR
    rp, sp = rp >> 9, sp >> 9
    return (rk, rp, sk, sp), tuple(a.astype(np.int32)
                                   for a in (rk, rp, sk, sp))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", NAMES)
def test_int64_equals_its_int32_twin(name, mode):
    wide, narrow = _twins(11)
    a = port(name, wide, dense_path=False, **MODES[mode])
    b = port(name, narrow, dense_path=False, **MODES[mode])
    assert int(a.matches) == int(b.matches) == truth(*wide)[0]
    if mode != "keys":   # keys-only: a staged engine may sum all the same
        assert int(a.checksum) == int(b.checksum) == truth(*wide)[1]
    if mode == "materialize":
        live = [sorted(zip(*(c.numpy()[r.key.numpy() != -3].tolist()
                             for c in (r.key, r.r_payload, r.s_payload))))
                for r in (a, b)]
        assert live[0] == live[1]
        assert str(b.key.dtype) == "torch.int32"
