"""The port's sort_hist (B12), _plan and compact_kp against the JAX
package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode (about 4 s a call at
sub = 128); the port's wrappers take their plain versions for CPU tensors.
Sorted keys and `starts` must be equal by position, and each block must
hold the same (key, payload) pairs (the two packages order the payloads of
equal keys differently; tests/test_torch_blocksort.py has the port's
rule).  compact_kp's cases are those of tests/test_compact.py.  Every
comparison is exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.ops.pallas import compact as jc
from aqp_tpu_torch.ops.kernels import compact as tc

LANES = 128
SUB = 128
NB = 2
N = SUB * LANES * NB


def _packed_like(seed):
    """Keys as compact_kp and partition_bench hand them over: mostly in
    [0, 2^31 - 4), some negative, a quarter from 40 values, an eighth of
    them the two pads >= PACKED_PAD_MIN."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, jc.PACKED_PAD_MIN, N, dtype=np.int64)
    key[rng.random(N) < 0.05] = -rng.integers(1, 1 << 20)
    few = rng.random(N) < 0.25
    key[few] = rng.integers(0, 40, int(few.sum())) << 24
    pad = rng.random(N) < 0.125
    key[pad] = rng.choice([jc.PACKED_PAD_MIN, jc.KEY_PAD_INT],
                          int(pad.sum()))
    pay = rng.integers(-(1 << 31), 1 << 31, N, dtype=np.int64)
    return key.astype(np.int32), pay.astype(np.int32)


def _scale(F):
    return 0.0 if F == 1 else float(np.float32(F) / np.float32(1 << 30))


@pytest.fixture(scope="module", params=[1, 16], ids=["F1", "F16"])
def hist_both(request):
    F = request.param
    key, pay = _packed_like(F)
    scale = _scale(F)
    jks, jps, jst = jc.sort_hist(jnp.asarray(key), jnp.asarray(pay),
                                 jnp.float32(scale), SUB, F, interpret=True)
    tks, tps, tst = tc.sort_hist(torch.from_numpy(key),
                                 torch.from_numpy(pay), scale, SUB, F)
    return F, key, pay, tuple(map(np.asarray, (jks, jps, jst))), (
        tks.numpy(), tps.numpy(), tst.numpy())


def test_sorted_keys_and_starts_equal(hist_both):
    F, _, _, (jks, _, jst), (tks, tps, tst) = hist_both
    assert tks.shape == tps.shape == (N // LANES, LANES)
    assert tst.shape == (NB, F + 1) and tst.dtype == np.int32
    np.testing.assert_array_equal(tks, jks)
    np.testing.assert_array_equal(tst, jst)
    if F == 16:     # every bucket boundary is exercised
        assert len(np.unique(tst[0])) > 8


def test_each_block_holds_the_same_pairs(hist_both):
    _, key, pay, (jks, jps, _), (tks, tps, _) = hist_both
    rows = SUB
    for b in range(NB):
        sl = slice(b * rows * LANES, (b + 1) * rows * LANES)
        want = sorted(zip(key[sl].tolist(), pay[sl].tolist()))
        for ks, ps in ((jks, jps), (tks, tps)):
            got = sorted(zip(ks.reshape(-1)[sl].tolist(),
                             ps.reshape(-1)[sl].tolist()))
            assert got == want


def test_row_buckets_follow_float32():
    """clamp(int(float32(lead >> 1) * scale), 0, F - 1), F for a pad:
    the reference's expression, evaluated by jnp on the same leads."""
    rng = np.random.default_rng(4)
    lead = np.concatenate([
        rng.integers(-(1 << 31), 1 << 31, 20000, dtype=np.int64),
        [0, 1, -1, jc.PACKED_PAD_MIN - 1, jc.PACKED_PAD_MIN,
         jc.KEY_PAD_INT, -(1 << 31)]]).astype(np.int32)
    for F, scale in ((1, 0.0), (16, _scale(16)), (127, _scale(127)),
                     (5, 3.7e-9)):
        jl = jnp.asarray(lead)
        g = jnp.minimum(((jl >> 1).astype(jnp.float32)
                         * jnp.float32(scale)).astype(jnp.int32), F - 1)
        want = jnp.where(jl >= jc.PACKED_PAD_MIN, F, jnp.maximum(g, 0))
        got = tc.row_buckets(torch.from_numpy(lead), scale, F)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("F", [1, 128])
def test_bad_bucket_count_raises(F):
    key = torch.zeros(SUB * LANES, dtype=torch.int32)
    if F == 1:
        with pytest.raises(ValueError):
            tc.sort_hist(key[:-1], key[:-1], 0.0, SUB, F)
    else:
        with pytest.raises(ValueError):
            tc.sort_hist(key, key, 0.0, SUB, F)


def test_plan_matches_reference():
    rng = np.random.default_rng(5)
    nb, sub, nb_f = 6, 128, 16
    starts = np.sort(rng.integers(0, sub + 1, (nb, nb_f + 1)), axis=1)
    starts[:, 0] = 0
    starts = starts.astype(np.int32)
    for cap_rows, overflows in ((20, True), (120, False)):
        want = jc._plan(nb, sub, jnp.asarray(starts), nb_f, cap_rows)
        got = tc._plan(nb, sub, torch.from_numpy(starts), nb_f, cap_rows)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (int(got[3]) > 0) == overflows


def test_constants_match():
    for name in ("PACKED_PAD_MIN", "PAD_R_INPUT", "PAD_S_INPUT",
                 "KEY_PAD_INT"):
        assert getattr(tc, name) == getattr(jc, name), name


def _masked(n, sel, seed):
    """tests/test_compact.py's input: keys and payloads below 2^20, the
    rows not kept carry PAD_S_INPUT."""
    rng = np.random.default_rng(seed)
    key = rng.integers(1, 1 << 20, n).astype(np.int32)
    pay = rng.integers(0, 1 << 20, n).astype(np.int32)
    keep = rng.random(n) < sel
    mkey = np.where(keep, key, jc.PAD_S_INPUT).astype(np.int32)
    mpay = np.where(keep, pay, 0).astype(np.int32)
    return mkey, mpay, key[keep], pay[keep]


def _cap_fit(vk):
    return vk.size // 128 + 4


def _cap_short(vk):
    return max(1, vk.size // 128 // 2)


COMPACT_CASES = {
    # name: (rows, kept fraction, seed, cap_rows from the kept keys)
    "30pct-kept": (128 * 256, 0.3, 5, _cap_fit),
    "cap-too-small": (128 * 256, 0.9, 6, _cap_short),
    "all-pads": (128 * 128, 0.0, 7, lambda vk: 4),
}


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_compact_kp_matches_reference(case):
    n, sel, seed, cap_of = COMPACT_CASES[case]
    mkey, mpay, vk, vp = _masked(n, sel, seed)
    if case == "all-pads":
        mkey[:] = jc.PAD_R_INPUT
    cap = cap_of(vk)
    jk, jp, jovf = jc.compact_kp(jnp.asarray(mkey), jnp.asarray(mpay), cap,
                                 sub=128, interpret=True)
    tk, tp, tovf = tc.compact_kp(torch.from_numpy(mkey),
                                 torch.from_numpy(mpay), cap, sub=128)
    jk, jp, tk, tp = np.asarray(jk), np.asarray(jp), tk.numpy(), tp.numpy()
    assert tk.shape == tp.shape == (cap * 128,)
    np.testing.assert_array_equal(tk, jk)
    assert int(tovf) == int(jovf)
    live = tk < jc.PAD_R_INPUT
    got = sorted(zip(tk[live].tolist(), tp[live].tolist()))
    if case == "cap-too-small":
        assert int(tovf) > 0
        want = sorted(zip(vk.tolist(), vp.tolist()))
        assert len(got) < len(want)
        assert not (set(got) - set(want))
    else:
        assert int(tovf) == 0
        assert got == sorted(zip(vk.tolist(), vp.tolist()))
        assert got == sorted(zip(jk[live].tolist(), jp[live].tolist()))
