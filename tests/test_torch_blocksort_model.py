"""A CPU model of the block sort's kernels (csrc/blocksort.cu), step for
step at a scaled-down tile, held against the port's plain versions.

The model follows the kernels' arithmetic, vectorised with numpy over
tiles, warps and CTAs:
  tile sort   values warp-striped (warp w's lane l holds positions
              w * 32 * ITEMS + i * 32 + l); an AND/OR reduction finds the
              8-bit digits that vary, and the payload digits are dropped
              when the payloads ascend in position order.  A tile whose
              keys and payloads both vary, and whose warps' first keys show
              no repeated key, sorts its key digits first, then checks that
              it is in order, and otherwise sorts every varying digit from
              where it stands.  Each digit
              takes one LSD pass: the digit matched over a warp's lanes (a
              bit a lane in a per-warp mask word), a rank from one counter
              per (digit, warp) read and bumped item by item, one exclusive
              scan of the counters in (digit, warp) order, a scatter by
              offset + rank and a read-back in position order;
  merges      log2(block / TILE) levels; each CTA's range of MERGE_SPAN
              outputs is split by the kernels' 32-probe warp search, its
              windows staged, and each thread's MERGE_ITEMS outputs split
              by binary search and merged, the left run first on ties.
The kernels' TILE is 16 Ki (16 warps of 32 values a lane) and MERGE_SPAN
4,096; here TILE = 256 and MERGE_SPAN = 32, so that blocks of sub = 128
and 512 go through 6 and 8 merge levels and many tiles and CTAs.  Every
comparison is exact.
"""

import sys

import numpy as np
import pytest
import torch

from aqp_tpu_torch.ops.kernels import blocksort, compact

LANES = 128
WARP = 32
TILE_WARPS, ITEMS = 2, 4
TILE = TILE_WARPS * WARP * ITEMS
MERGE_THREADS, MERGE_ITEMS = 4, 8
MERGE_SPAN = MERGE_THREADS * MERGE_ITEMS
U64 = np.uint64
LANE = np.arange(WARP, dtype=np.uint32)
BELOW = (np.uint32(1) << LANE) - np.uint32(1)   # lanes below each lane


def pack(key, pay):
    """The kernels' 64-bit order: (key ^ 0x80000000) << 32 | uint32(pay)."""
    hi = (key.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000
    return (hi.astype(U64) << U64(32)) | (pay.astype(np.int64)
                                          & 0xFFFFFFFF).astype(U64)


def unpack(v):
    key = ((v >> U64(32)).astype(np.int64) ^ 0x80000000).astype(np.uint32)
    return key.view(np.int32), (v & U64(0xFFFFFFFF)).astype(
        np.uint32).view(np.int32)


LOWEST = np.array([(x & -x).bit_length() - 1 if x else 0
                   for x in range(256)])


def match_digit(dig):
    """The lanes of each lane's warp that share its digit: the bits the
    lanes set in their digit's mask word (over the last axis, 32 lanes)."""
    eq = dig[..., :, None] == dig[..., None, :]
    return (eq.astype(np.uint32) << LANE).sum(-1, dtype=np.uint32)


def radix_pass(t, shift, active):
    """One stable LSD pass, on the digit at shift[tile], of the active
    tiles of t [tile, warp, item, lane].  Returns the new t."""
    nt = t.shape[0]
    flat = t.reshape(nt, -1)
    dig = ((t >> shift.astype(U64)[:, None, None, None])
           & U64(0xFF)).astype(np.int64)
    cnt = np.zeros((nt, TILE_WARPS, 256), dtype=np.int64)
    rank = np.zeros(t.shape, dtype=np.int64)
    for i in range(ITEMS):
        d = dig[:, :, i, :]
        peers = match_digit(d)
        below = np.bitwise_count(peers & BELOW).astype(np.int64)
        c = np.take_along_axis(cnt, d, axis=2)
        rank[:, :, i, :] = c + below
        # the leader (no peer below) bumps the counter; every peer would
        # write the same value
        np.put_along_axis(cnt, d, c + np.bitwise_count(peers), axis=2)
    per_dw = cnt.transpose(0, 2, 1).reshape(nt, -1)   # (digit, warp) order
    offset = (np.cumsum(per_dw, axis=1) - per_dw).reshape(nt, 256,
                                                          TILE_WARPS)
    tiles = np.arange(nt)[:, None, None, None]
    warps = np.arange(TILE_WARPS)[None, :, None, None]
    pos = offset[tiles, dig, warps] + rank
    out = np.empty_like(flat)
    np.put_along_axis(out, pos.reshape(nt, -1), flat, axis=1)
    return np.where(active[:, None], out, flat).reshape(t.shape)


def ascends(x):
    """Per tile (rows of x): never decreasing in position order."""
    return (x[:, 1:] >= x[:, :-1]).all(axis=1)


def tile_sort(v):
    """tile_sort_kernel on each tile of the flat uint64 array v.  Returns
    the sorted array and the number of LSD passes each tile took."""
    t = v.reshape(-1, TILE_WARPS, ITEMS, WARP)        # [tile, w, i, lane]
    nt = t.shape[0]
    flat = t.reshape(nt, -1)
    vary = (np.bitwise_or.reduce(flat, axis=1)
            ^ np.bitwise_and.reduce(flat, axis=1))
    digits = sum(((((vary >> U64(8 * j)) & U64(0xFF)) != 0).astype(np.int64)
                  << j) for j in range(8))
    digits = np.where(ascends(flat & U64(0xFFFFFFFF)), digits & 0xF0,
                      digits)
    # a warp whose first 32 keys mostly equal its lane 0's marks a key that
    # repeats; a quarter of the warps marking one skips the key-first order
    k0 = t[:, :, 0, :] >> U64(32)
    marks = (k0 == k0[:, :, :1]).sum(axis=2) > 16
    repeats = 4 * marks.sum(axis=1) >= TILE_WARPS
    keys_first = ((digits & 0x0F) != 0) & ((digits & 0xF0) != 0) & ~repeats
    queue = np.where(keys_first, digits & 0xF0, digits)
    passes = np.zeros(nt, dtype=np.int64)
    while (queue != 0).any():
        active = queue != 0
        shift = 8 * LOWEST[queue]
        queue = np.where(active, queue & (queue - 1), queue)
        t = radix_pass(t, shift, active)
        passes += active
        check = keys_first & (queue == 0)
        keys_first &= ~check
        unsorted = check & ~ascends(t.reshape(nt, -1))
        queue = np.where(unsorted, digits, queue)
    return t.reshape(-1), passes


def co_rank_warp(a, b, length, k):
    """co_rank_warp for many (a, b, k) at once: a and b are (m, length)
    runs, k (m,).  Returns how many of a's values the first k outputs of
    the merge take, the left run first on ties."""
    m = a.shape[0]
    rows = np.arange(m)[:, None]
    lo = np.maximum(0, k - length)
    hi = np.minimum(k, length)

    def before(q, live=True):
        ok = (q < hi[:, None]) & live
        qa = np.where(ok, q, 0)
        qb = np.where(ok, k[:, None] - 1 - q, 0)
        return ok & (a[rows, qa] <= b[rows, qb])

    while (hi - lo > WARP).any():
        wide = hi - lo > WARP                        # warps still searching
        step = (hi - lo + 31) >> 5
        q = lo[:, None] + (np.arange(WARP) + 1) * step[:, None] - 1
        c = before(q, wide[:, None]).sum(1)
        nlo = lo + c * step
        nhi = np.minimum(lo + (c + 1) * step - 1, hi)
        lo = np.where(wide, nlo, lo)
        hi = np.where(wide, nhi, hi)
    return lo + before(lo[:, None] + np.arange(WARP)).sum(1)


def merge_level(src, run):
    """merge_kernel: every pair of sorted runs of `run` values merged."""
    n = src.size
    o = np.arange(0, n, MERGE_SPAN)
    pair0 = o - o % (2 * run)
    k0 = o - pair0
    ab = src.reshape(-1, 2, run)[pair0 // (2 * run)]  # each CTA's pair
    a, b = ab[:, 0], ab[:, 1]
    a0 = co_rank_warp(a, b, run, k0)
    a1 = co_rank_warp(a, b, run, k0 + MERGE_SPAN)
    na = a1 - a0
    b0 = k0 - a0
    x = np.arange(MERGE_SPAN)[None, :]
    rows = np.arange(o.size)[:, None]
    win = np.where(x < na[:, None], a[rows, np.minimum(a0[:, None] + x,
                                                       run - 1)],
                   b[rows, np.clip(b0[:, None] + x - na[:, None], 0,
                                   run - 1)])
    # each thread's split of the window, by binary search
    d = np.arange(0, MERGE_SPAN, MERGE_ITEMS)[None, :]
    lo = np.maximum(0, d - (MERGE_SPAN - na[:, None]))
    hi = np.minimum(d, na[:, None])
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        left = win[rows, np.where(act, mid, 0)]
        right = win[rows, np.where(act, na[:, None] + d - 1 - mid, 0)]
        le = left <= right
        lo = np.where(act & le, mid + 1, lo)
        hi = np.where(act & ~le, mid, hi)
    ia, ib = lo, na[:, None] + d - lo
    out = np.empty((o.size, MERGE_THREADS, MERGE_ITEMS), dtype=U64)
    for j in range(MERGE_ITEMS):
        xa = win[rows, np.minimum(ia, MERGE_SPAN - 1)]
        yb = win[rows, np.minimum(ib, MERGE_SPAN - 1)]
        take_a = (ib >= MERGE_SPAN) | ((ia < na[:, None]) & (xa <= yb))
        out[:, :, j] = np.where(take_a, xa, yb)
        ia = ia + take_a
        ib = ib + ~take_a
    return out.reshape(-1)


def model_sort_blocks(key, pay, sub):
    """The kernels' sort of each sub*128-pair block.  Returns (keys,
    payloads, passes per tile, merge levels)."""
    block = sub * LANES
    assert key.size % block == 0
    v, passes = tile_sort(pack(key, pay))
    levels = 0
    run = TILE
    while run < block:
        v = merge_level(v, run)
        run *= 2
        levels += 1
    k, p = unpack(v)
    return k, p, passes, levels


def _case(name, n, sub, seed):
    """Inputs that the new design can get wrong: ties, pads, arange
    payloads, constant digits, and one digit that varies."""
    rng = np.random.default_rng(seed)
    i32 = lambda lo, hi: rng.integers(lo, hi, n, dtype=np.int64)  # noqa
    if name == "random":
        key, pay = i32(-(1 << 31), 1 << 31), i32(-(1 << 31), 1 << 31)
    elif name == "ties":
        key, pay = i32(0, 5), i32(0, 4)
    elif name == "pads":
        key = np.where(rng.random(n) < 0.7, blocksort.KEY_PAD_INT,
                       i32(-(1 << 31), 1 << 31))
        pay = np.where(key == blocksort.KEY_PAD_INT, 3,
                       i32(-(1 << 31), 1 << 31))
        key[:sub * LANES] = blocksort.KEY_PAD_INT     # one block all pads
        pay[:sub * LANES] = 3
    elif name == "arange":
        key, pay = i32(0, 1 << 30), np.arange(n)
    elif name == "arange, few keys":
        key, pay = i32(0, 3), np.arange(n)[::-1].copy()
    elif name == "all equal":
        key, pay = np.full(n, 7), np.full(n, -2)
    elif name == "payload top digit":
        key, pay = np.full(n, 7), (i32(0, 256) << 24) | 0x5A5A5A
    elif name == "key top digit":
        key, pay = (i32(0, 256) << 24) | 0x123456, np.full(n, 5)
    elif name == "repeated":
        # one key on 90% of the values (every position but those = 3 mod
        # 10, which no warp's first key holds), the rest in 0..255;
        # payloads in 0..255, not ascending
        key = np.where(np.arange(n) % 10 == 3, i32(0, 256), 77)
        pay = i32(0, 256)
    elif name == "pairs":
        # every key twice, side by side, payloads descending in each pair:
        # in order by key only after the payload digits
        key = np.repeat(rng.permutation(n // 2) * 3 - n, 2)
        pay = np.tile([1 << 20, 7], n // 2)
    else:
        raise KeyError(name)
    return key.astype(np.int32), pay.astype(np.int32)


CASES = ("random", "ties", "pads", "arange", "arange, few keys",
         "all equal", "payload top digit", "key top digit", "repeated",
         "pairs")


@pytest.mark.parametrize("sub", [128, 512])
@pytest.mark.parametrize("name", CASES)
def test_model_equals_sort_blocks_plain(name, sub):
    nb = 2 if sub == 128 else 1
    key, pay = _case(name, nb * sub * LANES, sub, seed=CASES.index(name))
    mk, mp, _, levels = model_sort_blocks(key, pay, sub)
    wk, wp = blocksort.sort_blocks_plain(torch.from_numpy(key),
                                         torch.from_numpy(pay), sub)
    assert levels == (sub * LANES // TILE).bit_length() - 1
    np.testing.assert_array_equal(mk, wk.numpy())
    np.testing.assert_array_equal(mp, wp.numpy())


@pytest.mark.parametrize("F", [1, 16, 127])
@pytest.mark.parametrize("name", ["ties", "pads", "arange"])
def test_model_with_the_row_epilogue_equals_sort_hist_plain(name, F):
    sub = 128
    key, pay = _case(name, 2 * sub * LANES, sub, seed=40 + F)
    key = np.where(key == blocksort.KEY_PAD_INT, key, key & 0x7FFFFFFF)
    scale = 0.0 if F == 1 else float(np.float32(F) / np.float32(1 << 30))
    mk, mp, _, _ = model_sort_blocks(key, pay, sub)
    ks, ps, starts = compact.sort_hist_plain(
        torch.from_numpy(key), torch.from_numpy(pay), scale, sub, F)
    np.testing.assert_array_equal(mk.reshape(-1, LANES), ks.numpy())
    np.testing.assert_array_equal(mp.reshape(-1, LANES), ps.numpy())
    # row_starts_kernel's epilogue on the model's rows
    lead = torch.from_numpy(mk.reshape(-1, sub, LANES)[:, :, 0].copy())
    b = compact.row_buckets(lead.long(), scale, F)
    want = torch.stack([(b < f).sum(1) for f in range(F + 1)], 1)
    np.testing.assert_array_equal(want.numpy(), starts.numpy())


def test_each_tile_takes_the_passes_of_its_digit_plan():
    """A tile of equal values takes no pass; one varying digit, one pass;
    arange payloads (ascending in position order) leave only the key
    digits; random keys and payloads are in order after the four key
    digits; keys in 0..4 with payloads in 0..3 are not in order after
    their key digit, so they take every digit (one key pass wasted); a key
    on most values shows before any pass, so no pass is wasted; pairs of equal keys with payloads out of
    order fail the check after the key digits, then take every digit."""
    n = 2 * 128 * LANES
    want = {"all equal": 0, "payload top digit": 1, "key top digit": 1,
            "random": 4, "arange": 4, "ties": 3, "repeated": 2,
            # keys around 0 vary in 4 digits, payloads (7, 2^20) in 2
            "pairs": 4 + 2 + 4}
    for name, passes in want.items():
        key, pay = _case(name, n, 128, seed=5)
        got = model_sort_blocks(key, pay, 128)[2]
        assert (got == passes).all(), (name, np.unique(got))
    key = np.full(n, 9, dtype=np.int32)
    pay = np.arange(n, dtype=np.int32)
    assert (tile_sort(pack(key, pay))[1] == 0).all()


@pytest.mark.parametrize("run", [TILE, 4 * TILE])
def test_co_rank_at_run_edges_and_ties(run):
    """Splits at k = 0, k = 2 * run, at the ends of a run, and inside long
    runs of equal values equal a merge of the two runs (left first)."""
    rng = np.random.default_rng(run)
    a = np.sort(rng.integers(0, 6, run).astype(U64))
    b = np.sort(rng.integers(0, 6, run).astype(U64))
    # a stable sort of a then b takes a's value first on ties
    order = np.argsort(np.concatenate([a, b]), kind="stable")
    merged_from_a = order < run
    ks = np.array([0, 1, run - 1, run, run + 1, 2 * run - 1, 2 * run,
                   *rng.integers(0, 2 * run, 24)])
    got = co_rank_warp(np.broadcast_to(a, (ks.size, run)),
                       np.broadcast_to(b, (ks.size, run)), run, ks)
    want = np.array([merged_from_a[:k].sum() for k in ks])
    np.testing.assert_array_equal(got, want)
    # a merge level over that pair equals the sorted union
    np.testing.assert_array_equal(merge_level(np.concatenate([a, b]), run),
                                  np.sort(np.concatenate([a, b])))


def _plan_tiles():
    """Five tiles of the kernels' TILE, one plan each: equal values; random
    distinct keys and payloads; every key twice, its payloads out of
    order; one key on 90% of the values; random keys, arange payloads."""
    rng = np.random.default_rng(77)
    t = blocksort.TILE
    distinct = rng.choice(1 << 32, t, replace=False) - (1 << 31)
    pairs = np.repeat(rng.permutation(t // 2) * 3 + (1 << 20), 2)
    keys = [np.full(t, 7), distinct, pairs,
            np.where(np.arange(t) % 10 == 3, rng.integers(0, 256, t), 77),
            rng.integers(-(1 << 31), 1 << 31, t)]
    pays = [np.full(t, 3), rng.integers(-(1 << 31), 1 << 31, t),
            np.tile([1 << 20, 7], t // 2), rng.integers(0, 256, t),
            np.arange(t)]
    return (torch.from_numpy(np.concatenate(keys).astype(np.int32)),
            torch.from_numpy(np.concatenate(pays).astype(np.int32)))


def test_tile_plan_counts_each_tile_by_its_plan():
    """The counts the kernel records (csrc/blocksort.cu's Plan), from the
    values: no pass for equal values; 4 key passes kept for distinct keys;
    2 key passes, failed, then the 4 varying digits (key digits 4 and 5,
    payload digits 0 and 2) for pairs; the repeated key seen before any
    pass, 2 digits; arange payloads skipped, 4 key digits."""
    key, pay = _plan_tiles()
    want = {"tiles": 5, "passes": 0 + 4 + 6 + 2 + 4, "direct": 2,
            "key-first kept": 1, "key-first failed": 1, "repeated keys": 1}
    assert blocksort.tile_plan_plain(key, pay) == want
    assert blocksort.tile_plan(key, pay) == want      # a CPU tensor
    with pytest.raises(ValueError, match="whole number"):
        blocksort.tile_plan_plain(key[:-128], pay[:-128])


@pytest.mark.parametrize("name", CASES)
def test_tile_plan_passes_equal_the_models_at_the_kernels_tile(
        name, monkeypatch):
    """The model run at the kernels' own tile (16 warps of 32 values a
    lane, sub = 128: one tile a block, no merge level) sorts as
    sort_blocks_plain does, and takes the passes tile_plan_plain counts."""
    model = sys.modules[__name__]
    monkeypatch.setattr(model, "TILE_WARPS", blocksort.TILE_WARPS)
    monkeypatch.setattr(model, "ITEMS", blocksort.TILE // (
        blocksort.TILE_WARPS * WARP))
    monkeypatch.setattr(model, "TILE", blocksort.TILE)
    key, pay = _case(name, 2 * blocksort.TILE, 128, seed=9)
    mk, mp, passes, levels = model_sort_blocks(key, pay, 128)
    wk, wp = blocksort.sort_blocks_plain(torch.from_numpy(key),
                                         torch.from_numpy(pay), 128)
    np.testing.assert_array_equal(mk, wk.numpy())
    np.testing.assert_array_equal(mp, wp.numpy())
    plan = blocksort.tile_plan_plain(torch.from_numpy(key),
                                     torch.from_numpy(pay))
    assert (plan["tiles"], plan["passes"], levels) == (2, passes.sum(), 0)
