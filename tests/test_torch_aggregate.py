"""The port's group-by aggregates against the JAX package's, on the CPU.

The same seeded numpy (key, value) rows go to both.  The JAX side runs the
routed aggregate in Pallas interpret mode at a small Rho3Params geometry, as
tests/test_aggpipe.py does; the port takes its plain versions for CPU
tensors.  Integers must agree exactly (sums mod 2^32: the port returns them
as int64 in [0, 2^32), the reference as uint32).  The routed outputs are
compared as their live rows (key != -3) and num_groups: their length
depends on the branch (ROADMAP "Quirks").
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.ops import aggregate as jagg
from aqp_tpu.ops.pallas import aggpipe as jpipe
from aqp_tpu.ops.pallas.rho3 import Rho3Params as JParams
from aqp_tpu_torch.ops import aggregate as tagg
from aqp_tpu_torch.ops.kernels import aggpipe as tpipe
from aqp_tpu_torch.ops.kernels.rho3 import Rho3Params as TParams

GEOM = dict(block_rows=64, slot_rows=16, f1=6, f2=4, kd_slot_rows=32)
JPRM, TPRM = JParams(**GEOM), TParams(**GEOM)
U32 = 0xFFFFFFFF


def _rows(res):
    """{key: (count, sum mod 2^32, min, max)} of the live rows."""
    k = np.asarray(res.key).astype(np.int64)
    cols = [np.asarray(c).astype(np.int64) for c in
            (res.count, res.sum, res.min, res.max)]
    live = np.nonzero(k != -3)[0]
    out = {}
    for i in live:
        assert int(k[i]) not in out, "a group appears twice"
        out[int(k[i])] = (int(cols[0][i]), int(cols[1][i]) & U32,
                          int(cols[2][i]), int(cols[3][i]))
    return out


def _data(n, ngroups, seed, holes=0.0, wide=True):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, ngroups, n).astype(np.int32) * 3   # sparse keys
    if wide:
        val = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    else:
        val = rng.integers(-1000, 1000, n)
    key[rng.random(n) < holes] = -3
    return key, val.astype(np.int32)


@pytest.mark.parametrize("n,ngroups,cap", [(5000, 700, 1024),
                                           (5000, 700, 300),
                                           (3000, 3, 16)])
def test_groupby_aggregate_matches_reference(n, ngroups, cap):
    key, val = _data(n, ngroups, seed=n + cap)
    key[:3] = [-(1 << 31), 5, -(1 << 31)]   # the reference's first-run quirk
    j = jagg.groupby_aggregate(jnp.asarray(key), jnp.asarray(val), cap)
    t = tagg.groupby_aggregate(torch.from_numpy(key), torch.from_numpy(val),
                               cap, device="cpu")
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy().astype(np.int64),
                                      np.asarray(a).astype(np.int64))
    assert t.sum.dtype == torch.int64 and int(t.sum.min()) >= 0


def test_radix_sort_pairs_matches_reference():
    rng = np.random.default_rng(2)
    key = rng.permutation(4000).astype(np.int32) - 2000
    pay = rng.integers(-(1 << 31), 1 << 31, 4000, dtype=np.int64).astype(
        np.int32)
    jk, jp = jagg.radix_sort_pairs(jnp.asarray(key), jnp.asarray(pay))
    tk, tp = tagg.radix_sort_pairs(torch.from_numpy(key),
                                   torch.from_numpy(pay), device="cpu")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("n,ngroups,holes", [(1 << 13, 64, 0.0),
                                             ((1 << 13) + 321, 17, 0.0),
                                             (1 << 14, 1000, 0.4)])
def test_routed_aggregate_matches_reference(n, ngroups, holes):
    key, val = _data(n, ngroups, seed=5, holes=holes)
    cap = 4096
    j = jpipe.groupby_aggregate_routed(jnp.asarray(key), jnp.asarray(val),
                                       cap, prm=JPRM, interpret=True)
    t = tpipe.groupby_aggregate_routed(torch.from_numpy(key),
                                       torch.from_numpy(val), cap, prm=TPRM,
                                       device="cpu")
    oracle = tagg.groupby_aggregate(torch.from_numpy(key),
                                    torch.from_numpy(val), cap,
                                    device="cpu")
    want = _rows(oracle)
    want.pop(-3, None)         # the sort-based one groups the holes
    assert int(t.num_groups) == int(j.num_groups) == len(want)
    assert _rows(t) == _rows(j) == want
    live = t.key[t.key != -3]
    assert torch.equal(live, live.sort().values)    # ascending
    assert t.key.numel() == cap


@pytest.mark.parametrize("cap,ngroups", [(64, 8), (512, 8)])
def test_routed_auto_jittered_matches_reference(cap, ngroups):
    """capacity 64 and 512 give jitter 512 and 64: each key splits into
    pseudo-groups that the second level recombines."""
    key, val = _data(1 << 14, ngroups, seed=3, wide=cap == 64)
    j = jpipe.groupby_aggregate_routed_auto(jnp.asarray(key),
                                            jnp.asarray(val), cap, prm=JPRM,
                                            interpret=True)
    t = tpipe.groupby_aggregate_routed_auto(torch.from_numpy(key),
                                            torch.from_numpy(val), cap,
                                            prm=TPRM, device="cpu")
    oracle = tagg.groupby_aggregate(torch.from_numpy(key),
                                    torch.from_numpy(val), cap,
                                    device="cpu")
    assert int(t.num_groups) == int(j.num_groups) == ngroups
    assert _rows(t) == _rows(j) == _rows(oracle)
    assert t.key.numel() == cap


def test_routed_auto_plain_branch_pads_its_capacity():
    """Above the jitter threshold _auto is the plain pipeline with a
    capacity padded by one row per region, so its output is that long."""
    key, val = _data(6000, 300, seed=8)
    cap = 40000
    t = tpipe.groupby_aggregate_routed_auto(torch.from_numpy(key),
                                            torch.from_numpy(val), cap,
                                            prm=TPRM, device="cpu")
    assert t.key.numel() == cap + 128 * TPRM.f1 * TPRM.f2 + 128
    oracle = tagg.groupby_aggregate(torch.from_numpy(key),
                                    torch.from_numpy(val), cap,
                                    device="cpu")
    assert _rows(t) == _rows(oracle)
    assert int(t.num_groups) == int(oracle.num_groups)


@pytest.mark.parametrize("why", ["slot overflow", "capacity cut"])
def test_routed_overflow_poisons_num_groups(why):
    """One key on every row overflows the fixed slots; a capacity below
    the groups' rows cuts them.  Both packages report num_groups = 2^30."""
    if why == "slot overflow":
        key = np.full(1 << 14, 5, np.int32)
        val = np.arange(1 << 14, dtype=np.int32)
        cap = 4096
    else:
        key, val = _data(1 << 13, 1000, seed=6)
        cap = 256
    j = jpipe.groupby_aggregate_routed(jnp.asarray(key), jnp.asarray(val),
                                       cap, prm=JPRM, interpret=True)
    t = tpipe.groupby_aggregate_routed(torch.from_numpy(key),
                                       torch.from_numpy(val), cap, prm=TPRM,
                                       device="cpu")
    assert int(t.num_groups) == int(j.num_groups) == 1 << 30


def test_k3agg_plain_rows_are_the_regions_groups():
    """The kernel's plain version on routed slots: per region, its distinct
    keys ascending, then (HOLE, 0, 0, 0, 0); the counts add up."""
    key, val = _data(5000, 400, seed=11)
    before = dict(tpipe.LAUNCHES)
    tk = torch.from_numpy(key)
    packed, _ = tpipe.pack_keys(tk, torch.zeros_like(tk), 1)
    k2, v2, cnt2, nbg, ovf = tpipe.route_2level(
        packed, torch.from_numpy(val), TPRM, True,
        scale=tpipe._range_scale(tk, TPRM))
    assert int(ovf) == 0
    okey, ocnt, osum, omin, omax, counts = tpipe.k3agg_plain(k2, v2, cnt2)
    assert okey.shape == (TPRM.f1 * TPRM.f2, nbg * TPRM.cap2)
    assert int(counts.sum()) == len(np.unique(key))
    assert int(ocnt.sum()) == key.size
    for r in range(okey.shape[0]):
        c = int(counts[r])
        row = okey[r, :c]
        assert torch.equal(row, row.sort().values)
        assert (okey[r, c:] == tpipe.HOLE).all()
        for o in (ocnt, osum, omin, omax):
            assert not o[r, c:].any()
    assert tpipe.LAUNCHES == before


def _c8_rows(keys_counts, seed):
    rng = np.random.default_rng(seed)
    key = np.repeat(np.array([k for k, _ in keys_counts], np.int64),
                    [c for _, c in keys_counts]).astype(np.int32)
    rng.shuffle(key)
    val = rng.integers(-(1 << 31), 1 << 31, key.size,
                       dtype=np.int64).astype(np.int32)
    return key, val


@pytest.mark.parametrize("case", ["key 2^23 + 3", "keys 3, 2^21, 9",
                                  "pad keys"])
def test_routed_auto_keeps_groups_above_max_key_over_jitter(case):
    """A key at or above MAX_KEY / J used to wrap key * J and merge into
    another group (or drop); J now shrinks until (kmax + 1) * J <= MAX_KEY,
    so every group comes out exact, and keys at or above MAX_KEY are
    dropped as the plain branch drops them.  Held to the sort-based
    aggregate of the live rows and to a numpy truth; the reference is
    compared on the small keys only, where it is right."""
    cap = 64                                   # jitter_for(64) = 512
    if case == "key 2^23 + 3":
        small = [(k, 5) for k in range(10, 50)]
        spec = [(3, 300), ((1 << 23) + 3, 300)] + small
    elif case == "keys 3, 2^21, 9":
        small = [(3, 200), (9, 200)]
        spec = [(3, 200), (1 << 21, 200), (9, 200)]
    else:
        small = [(3, 200), (9, 200)]
        spec = small + [(tpipe.MAX_KEY, 50), ((1 << 30) + 5, 50), (-3, 50)]
    key, val = _c8_rows(spec, seed=len(spec))
    live = (key >= 0) & (key < tpipe.MAX_KEY)
    t = tpipe.groupby_aggregate_routed_auto(torch.from_numpy(key),
                                            torch.from_numpy(val), cap,
                                            prm=TPRM, device="cpu")
    oracle = tagg.groupby_aggregate(torch.from_numpy(key[live]),
                                    torch.from_numpy(val[live]), cap,
                                    device="cpu")
    truth = {}
    for k in np.unique(key[live]):
        v = val[key == k].astype(np.int64)
        truth[int(k)] = (v.size, int(v.sum()) & U32, int(v.min()),
                         int(v.max()))
    assert int(t.num_groups) == int(oracle.num_groups) == len(truth)
    assert _rows(t) == _rows(oracle) == truth
    # the reference, on the rows whose keys stay below MAX_KEY / 512
    keep = np.isin(key, [k for k, _ in small])
    j = jpipe.groupby_aggregate_routed_auto(jnp.asarray(key[keep]),
                                            jnp.asarray(val[keep]), cap,
                                            prm=JPRM, interpret=True)
    want = {k: v for k, v in truth.items() if k in dict(small)}
    assert _rows(j) == want
    assert {k: v for k, v in _rows(t).items() if k in want} == want
