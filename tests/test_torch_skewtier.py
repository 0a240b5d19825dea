"""The port's heavy-split skew tier against the JAX package's, on the CPU.

Both packages get the same numpy Zipf keys (|S| = 2^20 at z = 1.5 over a
16K alphabet: HINT_MIN_RUN = 512 runs in a stride-128 sample need at least
65,536 keys).  The JAX skew_fused_count calls its pipeline without
interpret mode, so it cannot run here; the port's is held against a
composition of the same JAX pieces with the interpret-mode compactor and
pipeline at a small geometry, and against the exact core.  Every
comparison is exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.data.generator import _zipf_cdf_lut
from aqp_tpu.joins import skewtier as jst
from aqp_tpu.ops import mergejoin as jmj
from aqp_tpu.ops.pallas import lanecompact as jlc
from aqp_tpu.ops.pallas import rho3 as jrho3
from aqp_tpu_torch.joins import skewtier as tst
from aqp_tpu_torch.ops import mergejoin as tmj

NR, NS, ALPHA = 1 << 14, 1 << 20, 1 << 14
# an interpret-mode geometry whose slots hold a compacted Zipf residual
SMALL = jrho3.Rho3Params(block_rows=64, slot_rows=16, f1=16, f2=4,
                         kd_slot_rows=32)


def _zipf(rng, n, alphabet, z):
    cdf = _zipf_cdf_lut(alphabet, z).astype(np.float32)
    u = rng.random(n, dtype=np.float32)
    ranks = np.clip(np.searchsorted(cdf, u, side="left"), 0, alphabet - 1)
    return (rng.permutation(alphabet) + 1)[ranks].astype(np.int32)


def _payloads(rng, n):
    return rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(
        np.int32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1500)
    rk = (rng.permutation(NR) + 1).astype(np.int32)
    sk = _zipf(rng, NS, ALPHA, 1.5)
    return rk, _payloads(rng, NR), sk, _payloads(rng, NS)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_constants_match():
    for name in ("H", "SAMPLE_STRIDE", "MIN_SAMPLE_RUN", "HINT_MIN_RUN",
                 "_TIER_FRACS"):
        assert getattr(tst, name) == getattr(jst, name), name
    assert tst._skew_prm() == tst._skew_prm().__class__(
        **vars(jst._skew_prm()))


@pytest.mark.parametrize("stride", [128, 4])
def test_heavy_candidates(data, stride):
    sk = data[2].copy()
    sk[:3] = [-1, -3, 0]        # a hole key and negatives never qualify
    want = np.asarray(jst.heavy_candidates(jnp.asarray(sk), stride=stride))
    got = tst.heavy_candidates(torch.from_numpy(sk), stride=stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 8


def test_heavy_candidates_ties_keep_the_lower_index():
    """Many runs of one length: jax.lax.top_k keeps the lower index, so the
    smallest keys win; the port must pick the same ones."""
    sk = np.repeat(np.arange(1, 201, dtype=np.int32), 16 * 4)
    np.random.default_rng(3).shuffle(sk)
    want = np.asarray(jst.heavy_candidates(jnp.asarray(sk), stride=4))
    got = tst.heavy_candidates(torch.from_numpy(sk), stride=4).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_pay", [True, False], ids=["pay", "keys"])
def test_r_cand_stats(data, with_pay):
    rk, rp, sk, _ = data
    hk = np.asarray(jst.heavy_candidates(jnp.asarray(sk)))
    # duplicate and absent candidates, and a -1 slot next to a -1 R key
    hk = np.concatenate([hk[:-4], [hk[-1], 1 << 29, -1, hk[-2]]]).astype(
        np.int32)
    rk = rk.copy()
    rk[0] = -1
    jc, jp = jst.r_cand_stats(*_j(rk, rp, hk), with_pay=with_pay)
    tc, tp = tst.r_cand_stats(*_t(rk, rp, hk), with_pay=with_pay)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).astype(np.int64))


@pytest.mark.parametrize("with_pay", [True, False], ids=["pay", "keys"])
def test_heavy_split_pass(data, with_pay):
    rk, rp, sk, sp = data
    hk = np.asarray(jst.heavy_candidates(jnp.asarray(sk)))
    hk = np.concatenate([hk[:-2], [hk[-1], hk[-3]]]).astype(np.int32)
    cnt, rph = jst.r_cand_stats(*_j(rk, rp, hk))
    pres = np.array((jnp.asarray(hk) >= 0) & (cnt > 0))
    pres[5] = False                            # a candidate absent from R
    rph = np.asarray(rph)
    jm, jc, jres = jst.heavy_split_pass(*_j(sk, sp, hk, pres, rph),
                                        with_pay=with_pay)
    tm, tc, tres = tst.heavy_split_pass(
        *_t(sk, sp, hk, pres), torch.from_numpy(rph.astype(np.int64)),
        with_pay=with_pay)
    assert (int(tm), int(tc)) == (int(jm), int(jc))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))


def test_heavy_materialize(data):
    rk, rp, sk, sp = data
    hk = np.asarray(jst.heavy_candidates(jnp.asarray(sk)))
    jout = jst.heavy_materialize(*_j(rk, rp, sk, sp, hk))
    tout = tst.heavy_materialize(*_t(rk, rp, sk, sp, hk))
    assert (int(tout[0]), int(tout[1])) == (int(jout[0]), int(jout[1]))
    for t, j in zip(tout[2:], jout[2:]):   # in place: equal by position
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_sample_stats_and_plan(data):
    _, _, sk, _ = data
    want = tuple(int(x) for x in jst._sample_stats(jnp.asarray(sk)))
    assert tst._sample_stats(torch.from_numpy(sk)) == want
    jplan = jst.skew_plan(jnp.asarray(sk))
    tplan = tst.skew_plan(torch.from_numpy(sk))
    assert tplan == jplan
    assert tplan[0] and tplan[1] > 0


def test_skew_plan_cache_and_demote_resid(data):
    _, _, sk, _ = data
    t = torch.from_numpy(sk.copy())
    plan = tst.skew_plan(t)
    assert plan[0] and plan[1] > 0
    tst.demote_resid(t)
    assert tst.skew_plan(t) == (True, 0)
    assert tst.skew_hint(t)
    # another tensor of the same keys has its own plan
    assert tst.skew_plan(t.clone()) == plan
    # an in-place write makes the plan stale: it is computed anew
    t[:] = torch.arange(1, NS + 1, dtype=torch.int32)
    assert tst.skew_plan(t) == (False, 0)
    tst.demote_resid(torch.zeros(4, dtype=torch.int32))   # no entry: no-op


def test_demoted_plan_survives_a_full_cache(data):
    """Entries of dead tensors make room; a live tensor's plan stays, so a
    demoted plan is not recomputed (and its failed tier not retried)."""
    _, _, sk, _ = data
    t = torch.from_numpy(sk.copy())
    tst.skew_plan(t)
    tst.demote_resid(t)
    small = np.arange(1, 257, dtype=np.int32)
    live = [torch.from_numpy(small.copy()) for _ in range(40)]
    for x in live:
        tst.skew_plan(x)
    for _ in range(40):
        tst.skew_plan(torch.from_numpy(small.copy()))   # dies at once
    assert tst.skew_plan(t) == (True, 0)
    assert all(id(x) in tst._HINT_CACHE for x in live)
    assert len(tst._HINT_CACHE) <= len(live) + 32


def _reference_fused(rk, rp, sk, sp, salt, with_checksum, cap_rows,
                     r_dense):
    """jax skew_fused_count, piece by piece, with the interpret-mode
    compactor and pipeline at the SMALL geometry."""
    rk, rp, sk, sp = _j(rk, rp, sk, sp)
    hk = jst.heavy_candidates(sk)
    if r_dense and not with_checksum:
        pres = (hk >= 1) & (hk <= rk.shape[0])
        rph = jnp.zeros_like(hk).astype(jnp.uint32)
    else:
        rcnt, rph = jst.r_cand_stats(rk, rp, hk, with_pay=with_checksum)
        pres = (hk >= 0) & (rcnt > 0)
    mh, ch, sk_res = jst.heavy_split_pass(sk, sp, hk, pres, rph,
                                          with_pay=with_checksum)
    covf = 0
    if cap_rows:
        kf = min(1.0, cap_rows * 128 / sk.shape[0])
        if with_checksum:
            sk_res, sp, covf = jlc.compact_kp_fast(
                sk_res, sp, cap_rows, keep_frac=kf, interpret=True)
        else:
            sk_res, covf = jlc.compact_k_fast(sk_res, cap_rows, keep_frac=kf,
                                              interpret=True)
            sp = jnp.zeros_like(sk_res)
    m, c, ovf = jrho3.rho_join_count_v3(rk, rp, sk_res, sp, prm=SMALL,
                                        salt=salt,
                                        with_checksum=with_checksum,
                                        interpret=True)
    return (int(m) + int(mh), (int(c) + int(ch)) & 0xFFFFFFFF,
            int(ovf) + int(covf))


FUSED = [
    # (with_checksum, compacted residual, r_dense)
    (True, False, False),
    (True, True, False),
    (False, True, False),
    (False, True, True),
    (False, False, True),
]


@pytest.mark.parametrize("with_checksum,resid,r_dense", FUSED,
                         ids=["sum-full", "sum-resid", "keys-resid",
                              "keys-resid-rdense", "keys-full-rdense"])
def test_skew_fused_count(with_checksum, resid, r_dense):
    # small enough for the interpret-mode pipeline, so below the hint's
    # size: the residual capacity is the light mass with a margin, as
    # skew_plan would size it
    rng = np.random.default_rng(77)
    nr, ns = 1024, 1 << 14
    rk = (rng.permutation(nr) + 1).astype(np.int32)
    sk = _zipf(rng, ns, nr, 1.5)
    rp, sp = _payloads(rng, nr), _payloads(rng, ns)
    hk = np.asarray(jst.heavy_candidates(jnp.asarray(sk)))
    light = int(np.sum(~np.isin(sk, hk)))
    assert light < ns // 2
    cap = -(-int(light * 1.15) // 128) if resid else 0
    salt = jrho3.RETRY_SALTS[0]
    want = _reference_fused(rk, rp, sk, sp, salt, with_checksum, cap,
                            r_dense)
    m, c, ovf = tst.skew_fused_count(*_t(rk, rp, sk, sp), salt,
                                     with_checksum=with_checksum,
                                     resid_cap_rows=cap, r_dense=r_dense)
    assert want[2] == 0 and int(ovf) == 0
    assert (int(m), int(c)) == want[:2]
    exact = jmj.merge_join_count(*_j(rk, rp, sk, sp))
    assert int(m) == int(exact.matches) == ns
    if with_checksum:
        assert int(c) == int(exact.checksum)
    else:
        assert int(c) == 0


def test_skew_split_count_and_materialize(data):
    """The default-geometry heavy-split tiers against the exact cores."""
    rk, rp, sk, sp = data
    t = _t(rk, rp, sk, sp)
    salt = jrho3.RETRY_SALTS[0]
    m, c, ovf = tst.rho_skew_split_count(*t, salt)
    exact = tmj.merge_join_count(*t)
    assert int(ovf) == 0
    assert (int(m), int(c)) == (int(exact.matches), int(exact.checksum))
    m, c, k, a, b, ovf = tst.rho_skew_split_materialize(*t, salt)
    assert int(ovf) == 0
    assert (int(m), int(c)) == (int(exact.matches), int(exact.checksum))
    ref = jmj.merge_join_materialize(*_j(rk, rp, sk, sp), NS)
    live = k.numpy() != -3

    def rows(kk, aa, bb, mask):
        return sorted(zip(kk[mask].tolist(), aa[mask].tolist(),
                          bb[mask].tolist()))

    rk_, ra, rb = (np.asarray(x) for x in (ref.key, ref.r_payload,
                                           ref.s_payload))
    assert rows(k.numpy(), a.numpy(), b.numpy(), live) == rows(
        rk_, ra, rb, rk_ != -3)
