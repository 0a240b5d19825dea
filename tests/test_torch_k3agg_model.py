"""A CPU model of K3AGG's sub-range aggregate (csrc/aggpipe.cu), step for
step, held exactly against the port's plain version (aggpipe.k3agg_plain).

The model follows the kernel's arithmetic:
  pass 1, one CTA per (region, key sub-range p of P):
    interval   the region's smallest and largest key, from the first and
               last real element of each run (an empty region has no rows);
    bounds     the interval cut into P equal widths at even keys (as K3's);
    pieces     each run's positions of the piece [A, B) (as K3's); the
               sub-range's scratch offset is its first piece's start in
               every run, summed; the piece's smallest and largest key,
               pmin and pmax, from its stretches' ends;
    direct     keys spanning at most `table` values (pmax - pmin < table):
               a table entry a key value, each element's value folded into
               its key's entry (count, sum mod 2^32, min, max), the used
               entries the rows in key order;
    merge      else a piece of at most `rcap` elements: its runs merged in
               run order, the first element of each valid key (k >= 0, k !=
               KEY_PAD_INT) a group head, each group reduced;
    halving    else the piece is cut at pmin + (pmax - pmin + 1) // 2, the
               left half done first and the right one stacked (a halving);
    rows       ((k >> 1) & (2^30 - 1), count, sum mod 2^32, min, max);
  pass 2, one CTA per (region, sub-range): the rows of the region's
    earlier sub-ranges give this one's place, its rows are copied there,
    and the region's fill [count, w) is split evenly among its P CTAs.
Every output position must be written exactly once.  The kernel's rcap is
4,096 elements (SR_RCAP) and its table 4,096 key values (AGG_TABLE); the
tests also run them scaled down, so that pieces halve, down to single keys,
and take each path.
"""

import numpy as np
import pytest
import torch

from aqp_tpu_torch.ops.kernels import aggpipe, rho3

U32 = 0xFFFFFFFF
KEY_PAD_INT = rho3.KEY_PAD_INT
RCAP = 4096          # the kernel's elements a merged piece
TABLE = 4096         # the kernel's key values a direct table spans
HOLE = aggpipe.HOLE

# tests/test_torch_aggregate.py's small geometry: cap2 = 4,096, window =
# 4 blocks of 8,192 rows, gmax = 24
PRM = rho3.Rho3Params(block_rows=64, slot_rows=16, f1=6, f2=4,
                      kd_slot_rows=32)


def sub_bounds(kmin, kmax, p, P):
    """Sub-range p of P of [kmin, kmax]: [A, B), both even."""
    width = kmax - kmin + 1
    a = kmin & ~1 if p == 0 else (kmin + p * width // P) & ~1
    b = (kmax & ~1) + 2 if p == P - 1 else (kmin + (p + 1) * width // P) & ~1
    return a, b


def run_piece(keys, A, B, kmin, kmax):
    """Positions [lo, hi) of the piece [A, B) in one run's real keys."""
    lo = 0 if A <= kmin else int(np.searchsorted(keys, A, side="left"))
    hi = keys.size if B > kmax else int(np.searchsorted(keys, B,
                                                        side="left"))
    return lo, hi


def is_group(k):
    return (k >= 0) & (k != KEY_PAD_INT)


def row(key, vals):
    """One group's row: ((key >> 1) & mask, count, sum mod 2^32 as int32
    bits, min, max)."""
    s = int(vals.sum()) & U32
    return ((int(key) >> 1) & rho3.HASH_MASK, vals.size,
            s - (1 << 32) if s >= 1 << 31 else s, int(vals.min()),
            int(vals.max()))


def direct_piece(runs, pos, pmin, span):
    """The rows of a piece whose keys lie in [pmin, pmin + span): a table
    entry a key value, the used entries in key order."""
    cnt = np.zeros(span, np.int64)
    tot = np.zeros(span, np.int64)
    mn = np.full(span, 2 ** 31 - 1, np.int64)
    mx = np.full(span, -2 ** 31, np.int64)
    for (keys, vals), (lo, hi) in zip(runs, pos):
        k, v = keys[lo:hi], vals[lo:hi]
        ok = is_group(k)
        i = k[ok] - pmin
        np.add.at(cnt, i, 1)
        np.add.at(tot, i, v[ok])
        np.minimum.at(mn, i, v[ok])
        np.maximum.at(mx, i, v[ok])
    rows = []
    for i in np.flatnonzero(cnt):
        s = int(tot[i]) & U32
        rows.append((((pmin + int(i)) >> 1) & rho3.HASH_MASK, int(cnt[i]),
                     s - (1 << 32) if s >= 1 << 31 else s, int(mn[i]),
                     int(mx[i])))
    return rows


def merge_piece(runs, pos):
    """The rows of a piece of at most rcap elements: its runs merged in
    run order (a stable merge of the key-sorted stretches), heads at each
    valid key's first element, one row a group."""
    keys = np.concatenate([r[0][lo:hi] for r, (lo, hi) in zip(runs, pos)])
    vals = np.concatenate([r[1][lo:hi] for r, (lo, hi) in zip(runs, pos)])
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    head = is_group(keys)
    head[1:] &= keys[1:] != keys[:-1]
    starts = np.flatnonzero(head)
    end = int(np.flatnonzero(is_group(keys))[-1]) + 1 if head.any() else 0
    bounds = np.append(starts, end)
    return [row(keys[e0], vals[e0:e1])
            for e0, e1 in zip(bounds[:-1], bounds[1:])]


def model_region(runs, P, rcap, table):
    """Pass 1 for one region: per sub-range (rows, scratch offset), and the
    pieces (halved, reduced through a table, merged)."""
    real = [r[0] for r in runs if r[0].size]
    if not real:
        return [([], 0)] * P, (0, 0, 0)
    kmin = min(int(r[0]) for r in real)
    kmax = max(int(r[-1]) for r in real)
    out, halved, direct, merged = [], 0, 0, 0
    for part in range(P):
        A, B = sub_bounds(kmin, kmax, part, P)
        stack, rows, at = [], [], None
        while True:
            if A < B:
                pos = [run_piece(r[0], A, B, kmin, kmax) for r in runs]
                if at is None:
                    at = sum(lo for lo, _ in pos)
                v = sum(hi - lo for lo, hi in pos)
                if v > 0:
                    pmin = min(int(r[0][lo]) for r, (lo, hi) in
                               zip(runs, pos) if hi > lo)
                    pmax = max(int(r[0][hi - 1]) for r, (lo, hi) in
                               zip(runs, pos) if hi > lo)
                    span = pmax - pmin + 1
                    if span <= table:
                        rows += direct_piece(runs, pos, pmin, span)
                        direct += 1
                    elif v <= rcap:
                        rows += merge_piece(runs, pos)
                        merged += 1
                    else:
                        stack.append(B)
                        B = pmin + (span >> 1)
                        halved += 1
                        continue
            if not stack:
                break
            A, B = B, stack.pop()
        out.append((rows, at or 0))
    return out, (halved, direct, merged)


def region_runs(k, p, cnt, a, b):
    """A region's runs as (keys, values) int64 of real elements."""
    return [(k[a, i, b, :cnt[a, i, b]].astype(np.int64),
             p[a, i, b, :cnt[a, i, b]].astype(np.int64))
            for i in range(k.shape[1])]


def model_k3agg(k, p, cnt, P=None, rcap=RCAP, table=TABLE):
    """K3AGG's six outputs from the model, the writes of each output
    position, and the pieces (halved, through a table, merged)."""
    f1, nbg, f2, cap2 = k.shape
    nreg, w = f1 * f2, nbg * cap2
    P = P or rho3.subranges(nbg, cap2)
    blocks = [np.zeros((nreg, w), np.int64) for _ in range(5)]
    writes = np.zeros((nreg, w), np.int64)
    counts = np.zeros(nreg, np.int64)
    stats = np.zeros(3, np.int64)
    for a in range(f1):
        for b in range(f2):
            reg = a * f2 + b
            subs, st = model_region(region_runs(k, p, cnt, a, b), P, rcap,
                                    table)
            stats += st
            # the scratch rows of the sub-ranges never overlap
            spans = sorted((at, at + len(rows)) for rows, at in subs if rows)
            assert all(e0 <= s1 for (_, e0), (s1, _) in zip(spans,
                                                            spans[1:]))
            total = sum(len(rows) for rows, _ in subs)
            before = 0
            for part, (rows, _) in enumerate(subs):   # pass 2
                for i, r in enumerate(rows):
                    for blk, x in zip(blocks, r):
                        blk[reg, before + i] = x
                    writes[reg, before + i] += 1
                before += len(rows)
                f0 = total + (w - total) * part // P
                f1_ = total + (w - total) * (part + 1) // P
                for blk, fill in zip(blocks, (HOLE, 0, 0, 0, 0)):
                    blk[reg, f0:f1_] = fill
                writes[reg, f0:f1_] += 1
            counts[reg] = total
    return (*blocks, counts), writes, tuple(int(x) for x in stats)


def check(k, p, cnt, P=None, rcap=RCAP, table=TABLE):
    """Model == k3agg_plain, all six outputs, each position written once.
    Returns the pieces (halved, through a table, merged)."""
    got, writes, stats = model_k3agg(k, p, cnt, P, rcap, table)
    assert (writes == 1).all()
    want = aggpipe.k3agg_plain(*(torch.from_numpy(np.ascontiguousarray(x))
                                 for x in (k, p, cnt)))
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g, wv.numpy().astype(np.int64))
    return stats


def routed(key, val, prm=PRM):
    """K3AGG's inputs as groupby_aggregate_routed makes them, from the
    plain pipeline, as numpy arrays."""
    key = torch.from_numpy(np.asarray(key, np.int32))
    val = torch.from_numpy(np.asarray(val, np.int32))
    key = torch.where(key < 0, rho3.MAX_KEY, key)
    scale = aggpipe._range_scale(key, prm)
    packed, _ = rho3.pack_keys(key, torch.zeros_like(key), 1)
    k2, v2, cnt2, _, ovf = rho3.route_2level(packed, val, prm, True,
                                             scale=scale)
    assert int(ovf) == 0
    return k2.numpy(), v2.numpy(), cnt2.numpy()


def wide(rng, n):
    return rng.integers(-(1 << 31), 1 << 31, n)


def holes(rng, key, frac):
    return np.where(rng.random(key.size) < frac, -3, key)


@pytest.mark.parametrize("groups", [1 << 4, 1 << 10, 1 << 14])
def test_model_equals_plain_on_2k_groups(groups):
    """2^k groups (keys 3 apart) with holes and wide values: at the
    kernel's sizes nothing halves; with smaller tables and arrays the
    pieces halve (but 16 groups: a key a region), and take both paths."""
    rng = np.random.default_rng(groups)
    n = 60_000
    k, p, cnt = routed(holes(rng, rng.integers(0, groups, n) * 3, 0.1),
                       wide(rng, n))
    assert check(k, p, cnt)[0] == 0
    stats = np.array([check(k, p, cnt, P=3, rcap=rcap, table=table)
                      for rcap, table in ((64, 8), (256, 8), (8, 16),
                                          (64, 2))])
    assert stats[:, 1].sum() > 0
    if groups > 16:
        assert (stats[:, 0] > 0).all() and stats[:, 2].sum() > 0


def test_model_equals_plain_on_64_jittered_groups():
    """The 64-group leg's first level: 64 keys jittered into 32,768
    pseudo-groups (holes stay holes)."""
    rng = np.random.default_rng(64)
    n = 90_000
    jit = aggpipe.jitter_for(64)
    key = aggpipe.jittered_keys(torch.from_numpy(
        holes(rng, rng.integers(0, 64, n), 0.1).astype(np.int32)), jit)
    k, p, cnt = routed(key.numpy(), wide(rng, n))
    assert check(k, p, cnt)[0] == 0
    assert min(check(k, p, cnt, P=2, rcap=16, table=4)) > 0


def test_one_key_filling_a_region_takes_a_one_entry_table():
    """Key 0 fills region (0, 0): cap2 rows in each of two windows, the
    other keys past its level-1 bucket.  Its piece holds more elements than
    a CTA's array, in one key: a table of one entry, no halving."""
    rng = np.random.default_rng(0)
    win = PRM.group * PRM.block
    key = rng.integers(1 << 18, 1 << 20, 2 * win)
    for w0 in (0, win):
        key[rng.choice(win, PRM.cap2, replace=False) + w0] = 0
    k, p, cnt = routed(key, wide(rng, key.size))
    assert (cnt[0, :, 0] == PRM.cap2).all() and (k[0, :, 0] == 0).all()
    for table in (TABLE, 1):
        halved, direct, _ = check(k, p, cnt, table=table)
        assert halved == 0 and direct > 0


def test_sparse_keys_merge_and_halve():
    """Keys spread over [0, 2^30 - 2), half of them on 64 keys near the
    start of each region's key range: pieces span too many key values for
    a table, so they merge, and halve where they hold more than a CTA's
    array."""
    rng = np.random.default_rng(30)
    n = 60_000
    width = (1 << 30) // PRM.gmax
    near = rng.integers(0, PRM.gmax, n) * width + width // 8 + \
        rng.integers(0, 64, n)
    key = np.where(rng.random(n) < 0.5, rng.integers(0, rho3.MAX_KEY, n),
                   near)
    k, p, cnt = routed(key, wide(rng, n))
    assert check(k, p, cnt)[2] > 0
    assert min(check(k, p, cnt, rcap=1024)) > 0
    assert min(check(k, p, cnt, P=2, rcap=512)) > 0


def test_empty_regions_and_a_region_of_holes():
    """Keys below 3 * 2^14 and a few at 2^16 - 1: five regions are empty;
    and slots holding only negative keys and KEY_PAD_INT as real elements
    (no group)."""
    rng = np.random.default_rng(5)
    n = 40_000
    key = holes(rng, rng.integers(0, 3 << 14, n), 0.3)
    key[rng.choice(n, 50, replace=False)] = (1 << 16) - 1
    k, p, cnt = routed(key, rng.integers(-1000, 1000, n))
    assert (cnt.sum(axis=1) == 0).any()
    check(k, p, cnt)
    # hand-made: negative keys first and KEY_PAD_INT last in a slot's real
    # elements, a slot of them only, and one key repeated among them
    k = np.full((1, 3, 2, 64), KEY_PAD_INT, np.int32)
    p = np.zeros_like(k)
    cnt = np.zeros((1, 3, 2), np.int32)
    slots = {(0, 0, 0): [-9, -9, -2, 4, 4, 6, KEY_PAD_INT],
             (0, 1, 0): [-5, 4, 8, 8, 8, KEY_PAD_INT, KEY_PAD_INT],
             (0, 2, 0): [-1, KEY_PAD_INT],
             (0, 1, 1): [-7, -3]}
    for (a, j, b), keys in slots.items():
        k[a, j, b, :len(keys)] = keys
        p[a, j, b, :len(keys)] = rng.integers(-50, 50, len(keys))
        cnt[a, j, b] = len(keys)
    check(k, p, cnt)
    check(k, p, cnt, P=3, rcap=2, table=2)
    k[0, 0, 0, :3] = [0, 1, 2]      # no negative key: a table spans [0, 8]
    p[0, 0, 0, :cnt[0, 0, 0]] = rng.integers(-50, 50, cnt[0, 0, 0])
    cnt[0, :, 0] = [6, 5, 0]        # and no KEY_PAD_INT
    assert check(k, p, cnt, P=1, table=16)[1] > 0


def test_scratch_offsets_and_fill_at_the_leg_geometry():
    """At the wrapper's sub-range count (K3's: 8 for a region of 16 runs
    of 8,192, 1 at this geometry) and at any other P, a region's
    sub-ranges write their rows at disjoint scratch offsets, and the fill
    covers what the rows leave."""
    assert rho3.subranges(16, 8192) == 8
    rng = np.random.default_rng(7)
    n = 30_000
    k, p, cnt = routed(rng.integers(0, 1 << 12, n), wide(rng, n))
    for P in (1, 2, 7, 32):
        check(k, p, cnt, P=P)
        check(k, p, cnt, P=P, table=64)
