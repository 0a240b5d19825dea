"""A CPU model of RSTATS's kernel (csrc/rstats.cu, rstats_kernel), step for
step, held exactly against the port's plain version
(rstats.r_cand_stats_plain).

The model follows the kernel's arithmetic for each CTA of `nt` threads:
  table   hk in shared memory, its non-negative keys inserted (in any
          order: the model shuffles it, as the CAS race may) into an
          open-addressed table of 2^b >= 4h entries, b >= 11: linear
          probing from key * 0x9E3779B1 >> (32 - b); an entry holds a key
          and its group, the least slot that holds the key (atomicMin);
  rows    R's head (the (4 - o) % 4 elements before its first 16-byte
          boundary, o = data_ptr % 16 / 4) and tail (after its last whole
          vector) in CTA 0's warp 0, lanes 0-3 and 4-7; whole 4-element
          vectors grid-strided, `u_n` a thread a step (the next step's
          loading meanwhile), a warp's loop running alike in every lane;
  lookup  one read of the key's home entry, then on along the probe
          sequence until the key or a free entry: the model counts the
          reads of every miss; a lane keeps its step's hits as bits, and
          the warp visits the step's elements only when a lane has one;
  hits    a warp's lanes that hit in one element of the step grouped by
          group (__match_any_sync); the lowest lane of each group adds the
          lane count and the 32-bit payload sum (wrapping mod 2^32) to the
          CTA's shared totals, one atomic each;
  flush   each slot t whose group the CTA touched gets the group's count
          (64-bit) and its sum added to the low 32 bits of the slot's
          zeroed int64 payload output, wrapping mod 2^32.
Every element of R is counted as it is visited: each exactly once.  The
kernel runs 256 threads, 2 vectors a thread a step and a grid of at most
132 x 4 CTAs; the tests also run it scaled down, so that a thread loops.
"""

import numpy as np
import pytest
import torch

from aqp_tpu_torch.ops.kernels import rstats

M32 = (1 << 32) - 1
EMPTY = -1
INT_MAX = (1 << 31) - 1


def fib_home(k, bits):
    return ((k & M32) * 0x9E3779B1 & M32) >> (32 - bits)


def table_bits(h):
    bits = 11
    while (1 << bits) < 4 * h:
        bits += 1
    return bits


class Table:
    """The shared-memory table of one CTA."""

    def __init__(self, hk, bits, home, rng):
        self.bits, self.home = bits, home
        self.key = [EMPTY] * (1 << bits)
        self.group = [INT_MAX] * (1 << bits)
        self.miss_reads = []
        for t in rng.permutation(len(hk)):       # the CAS race's order
            k = int(hk[t])
            if k < 0:
                continue
            s = self.home(k, bits)
            while self.key[s] not in (EMPTY, k):
                s = (s + 1) % (1 << bits)
            self.key[s] = k
            self.group[s] = min(self.group[s], int(t))

    def find(self, k, record=False):
        if k < 0:
            return -1
        s, reads = self.home(k, self.bits), 0
        while True:
            reads += 1
            if self.key[s] == k:
                return self.group[s]
            if self.key[s] == EMPTY:
                if record:
                    self.miss_reads.append(reads)
                return -1
            s = (s + 1) % (1 << self.bits)


def model_rstats(rk, rp, hk, with_pay, o=0, nt=256, u_n=2, wave=132 * 4,
                 home=fib_home, seed=0):
    """The kernel on numpy rk (rp), hk, rk starting o elements past a
    16-byte boundary.  Returns (cnt, pay) int64 and the run's statistics."""
    rng = np.random.default_rng(seed)
    n, h = rk.size, hk.size
    assert 1 <= h <= 1024
    head = min((4 - o) % 4, n)
    nv = (n - head) // 4
    blocks = max(min(-(-nv // (nt * u_n)), wave), -(-n // (1 << 31)), 1)
    stride = blocks * nt
    bits = table_bits(h)
    cnt = np.zeros(h, np.int64)
    pay_lo = np.zeros(h, np.int64)
    seen = np.zeros(n, np.int64)
    stats = {"hits": 0, "atomics": 0, "miss_reads": [], "blocks": blocks,
             "steps": 0, "visited_steps": 0}

    for b in range(blocks):
        tab = Table(hk, bits, home, rng)
        groups = {int(t): tab.find(int(hk[t])) for t in range(h)}
        for t in range(h):                # each key's group: its least slot
            if hk[t] >= 0:
                assert groups[t] == int(np.flatnonzero(hk == hk[t])[0])
        assert sorted(k for k in tab.key if k != EMPTY) == sorted(
            set(int(k) for k in hk if k >= 0))
        s_cnt = [0] * h
        s_pay = [0] * h

        def warp_visit(lanes):
            """lanes: 32 (key, row) pairs, row -1 for no element."""
            gs = [tab.find(k) if i >= 0 else -1 for k, i in lanes]
            hit = [l for l in range(32) if gs[l] >= 0]
            for g in sorted(set(gs[l] for l in hit)):
                peers = [l for l in hit if gs[l] == g]
                stats["hits"] += len(peers)
                stats["atomics"] += 1
                s_cnt[g] = (s_cnt[g] + len(peers)) & M32
                if with_pay:
                    p = sum(int(rp[lanes[l][1]]) & M32 for l in peers)
                    s_pay[g] = (s_pay[g] + p) & M32

        if b == 0:
            t0 = head + nv * 4
            lanes = [(-1, -1)] * 32
            for l in range(4):
                if l < head:
                    lanes[l] = (int(rk[l]), l)
                if t0 + l < n:
                    lanes[4 + l] = (int(rk[t0 + l]), t0 + l)
            for k, i in lanes:
                if i >= 0:
                    seen[i] += 1
                    tab.find(k, record=True)
            warp_visit(lanes)
        for w in range(nt // 32):
            v0 = b * nt + w * 32                  # the warp's first vector
            while v0 < nv:
                batch = []
                for u in range(u_n):
                    row = []
                    for l in range(32):
                        x = v0 + l + u * stride
                        if x < nv:
                            e = head + 4 * x
                            assert (o + e) % 4 == 0    # an aligned vector
                            row.append([(int(rk[e + j]), e + j)
                                        for j in range(4)])
                        else:
                            row.append([(-1, -1)] * 4)
                    batch.append(row)
                # each lane's hits as bits, one lookup an element
                lane_bits = [0] * 32
                for u in range(u_n):
                    for j in range(4):
                        for l, (k, i) in enumerate(batch[u][l2][j]
                                                   for l2 in range(32)):
                            if i >= 0:
                                seen[i] += 1
                                if tab.find(k, record=True) >= 0:
                                    lane_bits[l] |= 1 << (4 * u + j)
                stats["steps"] += 1
                if any(lane_bits):
                    stats["visited_steps"] += 1
                    for u in range(u_n):
                        for j in range(4):
                            warp_visit([
                                batch[u][l][j]
                                if lane_bits[l] >> (4 * u + j) & 1
                                else (-1, -1) for l in range(32)])
                v0 += stride * u_n
        stats["miss_reads"] += tab.miss_reads
        for t in range(h):
            g = tab.find(int(hk[t]))
            if g < 0 or s_cnt[g] == 0:
                continue
            cnt[t] += s_cnt[g]
            pay_lo[t] = (pay_lo[t] + s_pay[g]) & M32
    assert (seen == 1).all()
    return cnt, pay_lo, stats


def check(rk, rp, hk, o=0, **kw):
    """Model == r_cand_stats_plain, with and without payloads."""
    for with_pay in (True, False):
        cnt, pay, stats = model_rstats(rk, rp, hk, with_pay, o, **kw)
        want = rstats.r_cand_stats_plain(
            torch.from_numpy(rk), torch.from_numpy(rp),
            torch.from_numpy(hk.astype(np.int32)), with_pay)
        np.testing.assert_array_equal(cnt, want[0].numpy())
        np.testing.assert_array_equal(pay, want[1].numpy())
    return stats


def unique_r(n, seed):
    rng = np.random.default_rng(seed)
    rk = (rng.permutation(n) + 1).astype(np.int32)
    rp = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return rk, rp


def candidates(rk, h, seed, minus=10, repeats=3, absent=(0, 2**30 - 3)):
    """h slots: -1s, keys of R (the first repeated), keys R lacks."""
    rng = np.random.default_rng(seed)
    present = rng.choice(rk, h - minus - repeats - len(absent),
                         replace=False)
    hk = np.concatenate([np.full(minus, -1), present,
                         np.repeat(present[:1], repeats), list(absent)])
    return rng.permutation(hk).astype(np.int32)


@pytest.mark.parametrize("o", [0, 1, 2, 3])
def test_kernel_geometry_unique_r_at_every_misalignment(o):
    """256 threads, 4 vectors a thread, 64 candidates (-1, repeated and
    absent slots), n ragged: a unique R's misses each read one entry but
    where a candidate sits on their home entry."""
    rk, rp = unique_r(33 * 1024 + 13 + o, seed=o)
    stats = check(rk, rp, candidates(rk, 64, seed=o), o)
    reads = np.array(stats["miss_reads"])
    assert reads.size + stats["hits"] == rk.size    # every row looked up
    assert (reads == 1).mean() > 0.95 and reads.max() <= 8
    # a warp visits only the steps where a lane hit
    assert stats["visited_steps"] <= stats["hits"] < stats["steps"]


@pytest.mark.parametrize("nt,u_n,wave", [(32, 2, 3), (64, 1, 2), (32, 4, 1)])
def test_scaled_down_grid_loops_over_r(nt, u_n, wave):
    """Few small CTAs, so that each thread loops: head, tail and the
    loop's last partial step."""
    rk, rp = unique_r(3 * 1024 + 7, seed=nt + u_n)
    stats = check(rk[1:], rp[1:], candidates(rk, 64, seed=5), 1, nt=nt,
                  u_n=u_n, wave=wave)
    assert stats["blocks"] == wave


def colliding_keys(count, bits, start=1):
    """`count` keys whose home entry is one and the same at 2^bits."""
    ks = np.arange(start, start + (1 << 22), dtype=np.int64)
    homes = ((ks * 0x9E3779B1) & M32) >> (32 - bits)
    return ks[homes == homes[0]][:count].astype(np.int32)


def test_forced_collisions_probe_on_exactly():
    """40 candidates on one home entry (a probe run of 40) and R holding
    them, their neighbours and keys homed on the run: exact, and misses
    that land in the run read on past it."""
    bits = table_bits(64)
    coll = colliding_keys(60, bits)
    hk = np.concatenate([coll[:40], np.full(20, -1), coll[:4]]).astype(
        np.int32)
    rng = np.random.default_rng(1)
    rk = np.concatenate([coll, coll[:10], coll + 1,
                         rng.integers(0, 1 << 20, 3000)]).astype(np.int32)
    rk = rng.permutation(rk)
    rp = rng.integers(-2**31, 2**31, rk.size).astype(np.int32)
    stats = check(rk, rp, hk, nt=32, u_n=2, wave=4)
    assert max(stats["miss_reads"]) > 40


def test_degenerate_hash_all_candidates_collide():
    """Every key homed on entry 0 (the whole table one probe run) at h =
    1,024: the table holds 4,096 entries and the answer stays exact."""
    rng = np.random.default_rng(2)
    rk = rng.integers(-3, 2000, 2500).astype(np.int32)
    rp = rng.integers(-2**31, 2**31, rk.size).astype(np.int32)
    hk = np.concatenate([np.arange(0, 1900, 2), np.full(50, -1),
                         np.arange(0, 48, 2)]).astype(np.int32)
    assert hk.size == 1024 and table_bits(1024) == 12
    check(rk, rp, hk, nt=64, u_n=2, wave=2, home=lambda k, bits: 0)


@pytest.mark.parametrize("hk", [[5], [-1], [0], [10_000]],
                         ids=["present", "minus-one", "zero", "absent"])
def test_one_candidate(hk):
    rk, rp = unique_r(2 * 1024 + 3, seed=4)
    check(rk, rp, np.array(hk, np.int32), 2, nt=64, u_n=2, wave=3)


def test_1024_candidates():
    """h = 1,024 (the most RSTATS takes): a 4,096-entry table, candidates
    with -1s and repeats, R with duplicates."""
    rng = np.random.default_rng(6)
    rk = rng.integers(0, 5000, 6000).astype(np.int32)
    rp = rng.integers(-2**31, 2**31, rk.size).astype(np.int32)
    hk = candidates(np.unique(rk), 1024, seed=7, minus=30, repeats=40)
    check(rk, rp, hk, o=3, nt=64, u_n=4, wave=4)


def test_duplicate_heavy_r_aggregates_a_warps_hits():
    """R sorted into runs of one key (a warp's 32 lanes on one key in a
    step) and R drawn from few values: one atomic for a warp's lanes on a
    group, and payload sums past 2^32 wrap exactly."""
    rng = np.random.default_rng(8)
    keys = np.repeat(np.arange(1, 13), 700).astype(np.int32)
    rp = rng.integers(2**30, 2**31, keys.size).astype(np.int32)
    hk = np.array([3, 7, -1, 3, 11, 12, 99], np.int32)
    stats = check(keys, rp, hk, nt=64, u_n=2, wave=2)
    assert stats["hits"] >= 20 * stats["atomics"]
    assert int(rp[keys == 3].astype(np.int64).sum()) > 1 << 32
    drawn = rng.integers(0, 40, 4000).astype(np.int32)
    check(drawn, rp[:4000], np.arange(-2, 40, 3).astype(np.int32), o=2,
          nt=32, u_n=2, wave=3)


def test_negative_keys_never_hit():
    """R keys of -1 (the free entry's key) and other negatives, against a
    -1 slot: nothing counts."""
    rk = np.array([-1, -1, -5, 3, -1, 3, 2**31 - 1, -2**31] * 300, np.int32)
    rp = np.arange(rk.size, dtype=np.int32)
    check(rk, rp, np.array([-1, 3, -5, 2**31 - 1], np.int32), 1, nt=32,
          u_n=1, wave=2)


def test_two_calls_in_a_row_keep_nothing():
    """The kernel holds no state between calls: a second call on other
    candidates gets its own answer."""
    rk, rp = unique_r(4 * 1024, seed=9)
    for seed in (10, 11):
        check(rk, rp, candidates(rk, 64, seed=seed), nt=64, u_n=2, wave=3)
