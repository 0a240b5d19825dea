"""The port's exact sort core against aqp_tpu.ops.mergejoin, on the CPU.

Same numpy inputs to both; matches and checksum must be equal bitwise,
once the reference's phantom matches are taken out: its propagate cores
mark "no R row yet" with the key -1, so an S row keyed -1 with no R key at
or below -1 "matches" (with R payload -1).  The port's cores use a mask
and do not (ROADMAP, deliberate differences).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.ops import mergejoin as jmj
from aqp_tpu_torch.ops import mergejoin as tmj


def _data(seed, nr=3000, ns=9000, dup_r=False):
    rng = np.random.default_rng(seed)
    if dup_r:
        rk = rng.integers(1, nr // 3, nr)
    else:
        rk = rng.permutation(nr) + 1
    # keys from -5 up, so S keys below every R key (and -1) occur too
    sk = rng.integers(-5, 2 * nr, ns)
    rp = rng.integers(-(1 << 31), 1 << 31, nr, dtype=np.int64)
    sp = rng.integers(-(1 << 31), 1 << 31, ns, dtype=np.int64)
    return [a.astype(np.int32) for a in (rk, rp, sk, sp)]


U32 = 0xFFFFFFFF


def _phantom(rk, sk, sp=None):
    """(matches, checksum) of the reference's phantom matches: the S rows
    keyed -1 when no R key is at or below -1, each with R payload -1."""
    if rk.size and rk.min() <= -1:
        return 0, 0
    hit = sk == -1
    pay = np.zeros(int(hit.sum()), np.int64) if sp is None else \
        sp[hit].astype(np.int64) & U32
    return int(hit.sum()), int(((U32 + pay) & U32).sum()) & U32


def _same(j, t, phantom=(0, 0)):
    assert int(t.matches) == int(j.matches) - phantom[0]
    assert int(t.checksum) == (int(j.checksum) - phantom[1]) & U32
    assert 0 <= int(t.checksum) < (1 << 32)


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_join_count(seed):
    d = _data(seed)
    _same(jmj.merge_join_count(*map(jnp.asarray, d)),
          tmj.merge_join_count(*map(torch.from_numpy, d)),
          _phantom(d[0], d[2], d[3]))


@pytest.mark.parametrize("dup_r", [False, True], ids=["unique", "dup"])
def test_merge_join_count_keys(dup_r):
    rk, _, sk, _ = _data(2, dup_r=dup_r)
    j = jmj.merge_join_count_keys(jnp.asarray(rk), jnp.asarray(sk))
    t = tmj.merge_join_count_keys(torch.from_numpy(rk), torch.from_numpy(sk))
    _same(j, t, (_phantom(rk, sk)[0], 0))
    assert int(t.checksum) == 0


@pytest.mark.parametrize("dup_r", [False, True], ids=["unique", "dup"])
def test_merge_join_count_general(dup_r):
    d = _data(3, dup_r=dup_r)
    j = jmj.merge_join_count_general(*map(jnp.asarray, d))
    t = tmj.merge_join_count_general(*map(torch.from_numpy, d))
    _same(j, t)
    if dup_r:   # multiplicity-exact: more pairs than S rows can match once
        assert int(t.matches) > int(
            tmj.merge_join_count_keys(torch.from_numpy(d[0]),
                                      torch.from_numpy(d[2])).matches)


@pytest.mark.parametrize("dup_r", [False, True], ids=["unique", "dup"])
def test_merge_join_count_general_keys(dup_r):
    rk, _, sk, _ = _data(4, dup_r=dup_r)
    j = jmj.merge_join_count_general_keys(jnp.asarray(rk), jnp.asarray(sk))
    t = tmj.merge_join_count_general_keys(torch.from_numpy(rk),
                                          torch.from_numpy(sk))
    _same(j, t)


def test_general_equals_propagate_core_for_unique_r():
    # non-negative keys: the propagate core's "no R yet" sentinel is -1
    rk, rp, sk, sp = _data(5)
    d = [torch.from_numpy(a) for a in (rk, rp, np.abs(sk), sp)]
    a = tmj.merge_join_count(*d)
    b = tmj.merge_join_count_general(*d)
    assert (int(a.matches), int(a.checksum)) == (int(b.matches),
                                                 int(b.checksum))


def _rows(k, a, b, n=None):
    k, a, b = (np.asarray(x)[:n] for x in (k, a, b))
    return sorted(zip(k.tolist(), a.tolist(), b.tolist()))


@pytest.mark.parametrize("capacity", [9000, 4000, 12000],
                         ids=["exact", "cut", "padded"])
def test_merge_join_materialize(capacity):
    """Live rows first (as a multiset: the two sorts order ties
    differently), then holes keyed -3 with zero payloads; the same length
    and scalars."""
    d = _data(4)
    ph = _phantom(d[0], d[2], d[3])
    # the reference's phantom rows (-1, -1, s) sort first: give it room for
    # them, then take them out
    j = jmj.merge_join_materialize(*map(jnp.asarray, d), capacity + ph[0])
    t = tmj.merge_join_materialize(*map(torch.from_numpy, d), capacity)
    _same(j, t, ph)
    m = int(t.matches)
    assert t.key.shape == (capacity,) and t.key.dtype == torch.int32
    live = min(m, capacity)
    jk = np.asarray(j.key)
    assert (jk[:ph[0]] == -1).all() and (np.asarray(j.r_payload)[:ph[0]]
                                         == -1).all()
    assert _rows(t.key, t.r_payload, t.s_payload, live) == _rows(
        *(np.asarray(c)[ph[0]:] for c in (j.key, j.r_payload, j.s_payload)),
        live)
    for col, hole in ((t.key, -3), (t.r_payload, 0), (t.s_payload, 0)):
        assert (col[live:] == hole).all()
    assert (t.key[:live] != -3).all()


def test_compact_matches():
    rng = np.random.default_rng(6)
    n = 5000
    hit = rng.random(n) < 0.4
    key, rp, sp = (rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
                   .astype(np.int32) for _ in range(3))
    for cap in (n, 1000):
        j = jmj.compact_matches(jnp.asarray(hit), *map(jnp.asarray,
                                                       (key, rp, sp)), cap)
        t = tmj.compact_matches(torch.from_numpy(hit),
                                *map(torch.from_numpy, (key, rp, sp)), cap)
        _same(j, t)
        live = min(int(t.matches), cap)
        # the port keeps the hit rows in their order (a stable sort)
        np.testing.assert_array_equal(t.key[:live].numpy(), key[hit][:live])
        assert _rows(t.key, t.r_payload, t.s_payload) == _rows(
            j.key, j.r_payload, j.s_payload)


@pytest.mark.parametrize("core", ["count", "keys", "materialize"])
def test_s_key_minus_one_has_no_phantom_match(core):
    """R = {10, 20, 30}, S = {-1, 10}: exactly one match.  The reference's
    -1 "no R row yet" sentinel matches the S key -1 and gives two, the
    phantom row being (-1, R payload -1, S payload)."""
    rk = np.array([10, 20, 30], np.int32)
    rp = np.array([7, 8, 9], np.int32)
    sk = np.array([-1, 10], np.int32)
    sp = np.array([100, 200], np.int32)
    tj = [jnp.asarray(a) for a in (rk, rp, sk, sp)]
    tt = [torch.from_numpy(a) for a in (rk, rp, sk, sp)]
    if core == "count":
        j, t = jmj.merge_join_count(*tj), tmj.merge_join_count(*tt)
        assert int(t.checksum) == 7 + 200
        assert int(j.checksum) == (7 + 200 + U32 + 100) & U32
    elif core == "keys":
        j = jmj.merge_join_count_keys(tj[0], tj[2])
        t = tmj.merge_join_count_keys(tt[0], tt[2])
    else:
        j = jmj.merge_join_materialize(*tj, 4)
        t = tmj.merge_join_materialize(*tt, 4)
        assert _rows(t.key, t.r_payload, t.s_payload, 1) == [(10, 7, 200)]
        assert _rows(j.key, j.r_payload, j.s_payload, 2) == [
            (-1, -1, 100), (10, 7, 200)]
    assert int(t.matches) == 1
    assert int(j.matches) == 2       # the reference's phantom match


@pytest.mark.parametrize("fill", [0.0, 0.01, 0.5, 1.0])
def test_last_index_equals_a_running_max(fill):
    """last_index (a count and a scatter) against the running
    max of the valid positions' indices."""
    rng = np.random.default_rng(int(fill * 100))
    for n in (0, 1, 7, 10_000):
        valid = torch.from_numpy(rng.random(n) < fill)
        idx = torch.arange(n)
        want = torch.where(valid, idx, -1).cummax(0).values if n else idx
        got = tmj.last_index(valid)
        assert got.dtype == torch.int64 and torch.equal(got, want)
