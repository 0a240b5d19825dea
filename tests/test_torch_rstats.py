"""The port's R-side candidate statistics (RSTATS's plain version, which a
CPU tensor takes) against the JAX package's r_cand_stats (XLA) and
r_cand_stats_pallas run in interpret mode, on the same numpy inputs:
candidate slots of -1, repeated slots, absent keys, an R length that is
not a whole Pallas block.  The Pallas form is exact only for unique R
keys, so a duplicate-R input is held against the XLA form alone."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.joins import skewtier as jst
from aqp_tpu_torch.joins import skewtier as tst
from aqp_tpu_torch.ops.kernels import rstats

NR = (1 << 17) + 4093        # two Pallas blocks, the second one partial


def _unique_r():
    rng = np.random.default_rng(23)
    rk = (rng.permutation(NR) + 1).astype(np.int32)
    rp = rng.integers(-2**31, 2**31, NR, dtype=np.int64).astype(np.int32)
    return rk, rp


def _candidates(rk, seed):
    """64 slots: 10 of -1, 46 present keys (one of them four times), 5 keys
    absent from R, in no order."""
    rng = np.random.default_rng(seed)
    present = rng.choice(rk, 46, replace=False)
    absent = [NR + 5, NR + 9, 2**30 - 3, 0, 7 * NR]
    hk = np.concatenate([np.full(10, -1), present, np.repeat(present[:1], 3),
                         absent]).astype(np.int32)
    return rng.permutation(hk)


def _want(rk, rp, hk, with_pay):
    cnt = np.array([(rk == h).sum() if h >= 0 else 0 for h in hk])
    pay = np.array([(rp[rk == h].astype(np.int64) & 0xFFFFFFFF).sum()
                    & 0xFFFFFFFF if h >= 0 and with_pay else 0 for h in hk])
    return cnt, pay


def _port(rk, rp, hk, with_pay):
    c, p = tst.r_cand_stats(torch.from_numpy(rk), torch.from_numpy(rp),
                            torch.from_numpy(hk), with_pay=with_pay)
    assert c.dtype == p.dtype == torch.int64
    return c.numpy(), p.numpy()


@pytest.mark.parametrize("with_pay,mxu", [(True, True), (False, False)],
                         ids=["pay-mxu", "keys-vpu"])
def test_r_cand_stats_matches_pallas_reference(with_pay, mxu):
    rk, rp = _unique_r()
    hk = _candidates(rk, 1)
    assert hk.size == 64
    jc, jp = jst.r_cand_stats_pallas(
        *(jnp.asarray(a) for a in (rk, rp, hk)), with_pay=with_pay, mxu=mxu,
        interpret=True)
    tc, tp = _port(rk, rp, hk, with_pay)
    np.testing.assert_array_equal(tc, np.asarray(jc).astype(np.int64))
    np.testing.assert_array_equal(tp, np.asarray(jp).astype(np.int64))
    wc, wp = _want(rk, rp, hk, with_pay)
    np.testing.assert_array_equal(tc, wc)
    np.testing.assert_array_equal(tp, wp)
    assert (tc[hk == hk[hk >= 0][0]] > 0).all()


@pytest.mark.parametrize("with_pay", [True, False], ids=["pay", "keys"])
@pytest.mark.parametrize("unique", [True, False], ids=["unique", "dupR"])
def test_r_cand_stats_matches_xla_reference(with_pay, unique):
    rk, rp = _unique_r()
    if not unique:
        rng = np.random.default_rng(4)
        rk = rng.integers(-5, 3000, NR).astype(np.int32)   # duplicates, < 0
    hk = _candidates(rk[rk >= 0], 2)
    hk[0] = -5 if not unique else hk[0]    # a negative key R holds
    jc, jp = jst.r_cand_stats(*(jnp.asarray(a) for a in (rk, rp, hk)),
                              with_pay=with_pay)
    tc, tp = _port(rk, rp, hk, with_pay)
    want_c = np.asarray(jc).astype(np.int64)
    want_p = np.asarray(jp).astype(np.int64)
    np.testing.assert_array_equal(tc, want_c)
    np.testing.assert_array_equal(tp, want_p)
    np.testing.assert_array_equal((tc, tp), _want(rk, rp, hk, with_pay))


def _dup_heavy():
    """R drawn from few values (every key ~64 times, sorted runs and
    shuffled halves), payloads near 2^31 so the sums wrap mod 2^32."""
    rng = np.random.default_rng(31)
    vals = rng.integers(0, 2048, NR).astype(np.int32)
    half = NR // 2
    rk = np.concatenate([np.sort(vals[:half]), vals[half:]])
    rp = rng.integers(2**30, 2**31, NR).astype(np.int32)
    return rk, rp


EDGE = {
    # name: (R, candidate slots)
    "h1-present": ("unique", [777]),
    "h1-minus-one": ("unique", [-1]),
    "h1-absent": ("unique", [NR + 3]),
    "dup-heavy": ("dup", [5, -1, 17, 5, 2047, 3000, -1, 17, 0, 1024]),
    "dup-heavy-h64": ("dup", list(range(-6, 116, 2))
                      + [8, 8, -1]),
}


@pytest.mark.parametrize("with_pay", [True, False], ids=["pay", "keys"])
@pytest.mark.parametrize("case", sorted(EDGE))
def test_r_cand_stats_edge_cases_match_xla_reference(case, with_pay):
    """One candidate slot (present, -1, absent), and R drawn from few
    values against repeated and -1 slots, with payload sums past 2^32."""
    which, hk = EDGE[case]
    rk, rp = _unique_r() if which == "unique" else _dup_heavy()
    hk = np.array(hk, np.int32)
    jc, jp = jst.r_cand_stats(*(jnp.asarray(a) for a in (rk, rp, hk)),
                              with_pay=with_pay)
    tc, tp = _port(rk, rp, hk, with_pay)
    np.testing.assert_array_equal(tc, np.asarray(jc).astype(np.int64))
    np.testing.assert_array_equal(tp, np.asarray(jp).astype(np.int64))
    np.testing.assert_array_equal((tc, tp), _want(rk, rp, hk, with_pay))
    if which == "dup" and with_pay:
        assert int(rp[rk == 5].astype(np.int64).sum()) > 1 << 32


def test_pallas_name_is_the_same_function():
    assert tst.r_cand_stats_pallas is tst.r_cand_stats


def test_cpu_call_launches_no_kernel():
    rk, rp = _unique_r()
    before = dict(rstats.LAUNCHES)
    _port(rk, rp, _candidates(rk, 3), True)
    assert rstats.LAUNCHES == before
