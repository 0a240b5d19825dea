"""A CPU model of K1 and K2's kernels (csrc/rho3.cu), step for step at a
scaled-down chunk, slot and window, held against the port's plain
versions (rho3.k1_plain, rho3.k2_plain).

The model follows the kernels' arithmetic, vectorised with numpy over
chunks, slots, warps and threads:
  K1 scatter  each chunk of SC_THREADS * SC_ITEMS keys ranks its keys by
              level-1 bucket (the lanes of a warp that share a bucket take
              consecutive places from one counter a bucket; warps in any
              order), stages them by bucket, and reserves each bucket's run
              in its slot from the slot's count, chunks in any order (a
              seeded shuffle here: the sort must not depend on it);
  K1 sort     one CTA a slot, values warp-striped (warp w's lane l holds
              position w * WARP_SPAN + i * 32 + l); 8-bit LSD passes over
              the bits that vary in (key - the slot's smallest key), each
              digit ranked over a warp's lanes (a bit a lane in a mask word
              per digit), one counter per (digit, warp) read and bumped
              item by item, one exclusive scan in (digit, warp) order, a
              scatter and a read-back; with payloads, each run of equal
              keys then ordered by payload in place, unless a run is longer
              than RUN_MAX: then the keys stay where they stand and (run
              index, payload) is sorted, 32 + log2(runs) bits;
  K2 merge    one CTA a fine slot: each sub-run's bounds found by binary
              search with the fine bucket, the sub-runs staged one after
              another, log2(group) pairwise merge levels in which each
              thread finds its first output's split by binary search
              (variable-length runs; a thread's outputs may cross into the
              next pair) and merges ITEMS outputs, the left run first on
              ties; a window past cap2 merges its sub-runs one at a time
              into its first cap2 values.
A slot of cap values takes 8 or 16 warps of ITEMS values a thread, a fine
slot up to 32.  The kernels'
constants are SC_THREADS = 512, SC_ITEMS = 16, ITEMS = 16 and RUN_MAX =
32; here SC_THREADS = 64, SC_ITEMS = 2, ITEMS = 8 and RUN_MAX = 8, so that
a slot of 1,024 values is 8 warps (half of them idle), one of 4,096 16
warps, a fine slot of 8,192 32 warps, and a block many chunks.  One test
runs the kernels' own constants on one default-geometry window.  Every
comparison is exact, except that a K1 slot that overflows keeps the
values its scatter placed first, so there only counts and overflow are
compared (and K2 on the model's K1 output, exactly).
"""

import sys

import numpy as np
import pytest
import torch

from aqp_tpu_torch.ops.kernels import rho3

WARP = 32
SC_THREADS, SC_ITEMS = 64, 2
ITEMS = 8
RUN_MAX = 8
RADIX_BITS = 8
RADIX = 1 << RADIX_BITS
U64 = np.uint64
LANE = np.arange(WARP, dtype=np.uint32)
BELOW = (np.uint32(1) << LANE) - np.uint32(1)   # lanes below each lane
KEY_PAD_INT = rho3.KEY_PAD_INT

GEOMS = {
    "128/8/20/4/16": rho3.Rho3Params(block_rows=128, slot_rows=8, f1=20,
                                     f2=4, kd_slot_rows=16),
    "64/8/12/8/16": rho3.Rho3Params(block_rows=64, slot_rows=8, f1=12,
                                    f2=8, kd_slot_rows=16),
    "128/32/8/2/8": rho3.Rho3Params(block_rows=128, slot_rows=32, f1=8,
                                    f2=2, kd_slot_rows=8),
    # fine slots past 16 warps of ITEMS: 32 warps
    "128/16/12/2/64": rho3.Rho3Params(block_rows=128, slot_rows=16, f1=12,
                                      f2=2, kd_slot_rows=64),
}


def pack(key, pay):
    """The kernels' 64-bit order: (key ^ 0x80000000) << 32 | uint32(pay)."""
    hi = (key.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000
    return (hi.astype(U64) << U64(32)) | (pay.astype(np.int64)
                                          & 0xFFFFFFFF).astype(U64)


def unpack(v):
    key = ((v >> U64(32)).astype(np.int64) ^ 0x80000000).astype(np.uint32)
    return key.view(np.int32), (v & U64(0xFFFFFFFF)).astype(
        np.uint32).view(np.int32)


def bit_len(x):
    """Bits of each uint64 in x (0 for 0)."""
    x = np.asarray(x, dtype=U64)
    out = np.zeros(x.shape, dtype=np.int64)
    for b in range(64):
        out = np.where((x >> U64(b)) != 0, b + 1, out)
    return out


def fine_bucket(packed, scale, gmax):
    """The kernels' fine_bucket, through the plain version's float32."""
    return rho3._fine_bucket(torch.from_numpy(np.asarray(packed, np.int32)),
                             rho3._f32(scale), gmax).numpy().astype(np.int64)


def shape_for(cap, k=2):
    """The CTA a slot of cap values takes in K<k>, (warps, values a
    thread): 8 or 16 warps of ITEMS a thread, or (K2 only) 32."""
    for w in (8, 16, 32) if k == 2 else (8, 16):
        if cap <= w * WARP * ITEMS:
            return w, ITEMS
    raise ValueError(cap)


# ---------------------------------------------------------------------------
# K1


def k1_scatter(packed, pay, nb, prm, scale, rng):
    """k1_scatter_kernel: returns the slots before their sort ((nb * f1,
    cap1) keys, payloads or None) and fill, the keys each slot was sent."""
    chunk = SC_THREADS * SC_ITEMS
    block = prm.block
    chunks = -(-block // chunk)
    n = packed.size
    f1, cap1 = prm.f1, prm.cap1
    g = fine_bucket(packed, scale, prm.gmax)
    bucket = np.where((g >= 0) & (g < prm.gmax), g // prm.f2, -1)
    slot_k = np.zeros((nb * f1, cap1), dtype=np.int64)
    slot_p = None if pay is None else np.zeros_like(slot_k)
    fill = np.zeros(nb * f1, dtype=np.int64)
    # the CTAs reserve their runs in a slot in any order
    for cta in rng.permutation(nb * chunks):
        blk, c = divmod(int(cta), chunks)
        base = blk * block + c * chunk
        lim = min(chunk, block - c * chunk, n - base)
        if lim <= 0:
            continue
        e = np.arange(lim)
        warp, rest = divmod(e, WARP * SC_ITEMS)
        item, lane = divmod(rest, WARP)
        f = bucket[base:base + lim]
        # ranks: item by item, the warps' leaders in any order, a warp's
        # lanes that share a bucket consecutive below their leader's
        worder = rng.permutation(SC_THREADS // WARP)
        order = np.lexsort((lane, worder[warp], item))
        rank = np.empty(lim, dtype=np.int64)
        srt = order[np.argsort(f[order], kind="stable")]
        fs = f[srt]
        first = np.searchsorted(fs, fs, side="left")
        rank[srt] = np.arange(lim) - first
        live = f >= 0
        cnt = np.bincount(f[live], minlength=f1)
        off = np.cumsum(cnt) - cnt
        stage = np.empty(live.sum(), dtype=np.int64)
        at = off[f[live]] + rank[live]
        stage[at] = e[live]
        sb = f[live][np.argsort(at)]
        dst0 = fill[blk * f1:(blk + 1) * f1].copy()
        fill[blk * f1:(blk + 1) * f1] += cnt
        x = np.arange(stage.size)
        dst = dst0[sb] + x - off[sb]
        keep = dst < cap1
        slots = blk * f1 + sb[keep]
        slot_k[slots, dst[keep]] = packed[base + stage[keep]]
        if pay is not None:
            slot_p[slots, dst[keep]] = pay[base + stage[keep]]
    return slot_k, slot_p, fill


def radix_pass(v, n, hs, base, shift, active):
    """One stable LSD pass of the active slots of v [slot, warp, item,
    lane] over their first n[slot] values, on the digit at shift[slot]."""
    ns, nw, it = v.shape[:3]
    pos = (np.arange(nw)[:, None, None] * WARP * it
           + np.arange(it)[None, :, None] * WARP + LANE[None, None, :])
    act = pos[None] < n[:, None, None, None]
    dig = ((((v >> U64(hs)) - base[:, None, None, None])
            >> shift.astype(U64)[:, None, None, None])
           & U64(RADIX - 1)).astype(np.int64)
    cnt = np.zeros((ns, nw, RADIX), dtype=np.int64)
    rank = np.zeros(v.shape, dtype=np.int64)
    for i in range(it):
        d = dig[:, :, i, :]
        a = act[:, :, i, :]
        # the lanes that set their bit in their digit's mask word
        eq = (d[..., :, None] == d[..., None, :]) & a[..., None, :]
        peers = (eq.astype(np.uint32) << LANE).sum(-1, dtype=np.uint32)
        below = np.bitwise_count(peers & BELOW).astype(np.int64)
        c = np.take_along_axis(cnt, d, axis=2)
        rank[:, :, i, :] = c + below
        # the leader bumps the counter by its peers: one for each
        s_, w_, _ = np.nonzero(a)
        np.add.at(cnt, (s_, w_, d[a]), 1)
    per_dw = cnt.transpose(0, 2, 1).reshape(ns, -1)   # (digit, warp) order
    offset = (np.cumsum(per_dw, axis=1) - per_dw).reshape(ns, RADIX, nw)
    slots = np.arange(ns)[:, None, None, None]
    warps = np.arange(nw)[None, :, None, None]
    to = offset[slots, dig, warps] + rank
    flat = v.reshape(ns, -1)
    out = flat.copy()
    for s in np.nonzero(active)[0]:
        a = act[s].reshape(-1)
        out[s, to[s].reshape(-1)[a]] = flat[s, a]
    return out.reshape(v.shape)


def radix_sort(v, n, hs, base, bits, active):
    """LSD passes over every digit below bits[slot]; returns (v, passes)."""
    passes = np.zeros(v.shape[0], dtype=np.int64)
    shift = np.zeros(v.shape[0], dtype=np.int64)
    while True:
        go = active & (shift < bits)
        if not go.any():
            return v, passes
        v = radix_pass(v, n, hs, base, shift, go)
        passes += go
        shift = shift + RADIX_BITS * go


def k1_sort(slot_k, slot_p, fill, cap):
    """k1_sort_kernel on every slot.  Returns (keys, payloads or None,
    counts, overflow, key passes, slots sorted again)."""
    ns = slot_k.shape[0]
    nw, it = shape_for(cap, k=1)
    width = nw * WARP * it
    n = np.minimum(fill, cap)
    pos = np.arange(width)[None, :]
    live = pos < n[:, None]
    raw = np.zeros((ns, width), dtype=np.int64)
    raw[:, :cap] = slot_k
    if slot_p is None:
        flat = np.where(live, raw, 0).astype(U64)
        hs = 0
    else:
        rawp = np.zeros_like(raw)
        rawp[:, :cap] = slot_p
        flat = np.where(live, pack(raw, rawp), U64(0))
        hs = 32
    lo = np.where(live, flat, ~U64(0)).min(axis=1)
    hi = np.where(live, flat, U64(0)).max(axis=1)
    has = n > 0
    key_bits = np.where(has, bit_len((hi >> U64(hs)) - (lo >> U64(hs))), 0)
    v = flat.reshape(ns, nw, it, WARP)
    v, passes = radix_sort(v, n, hs, lo >> U64(hs), key_bits, has)
    flat = v.reshape(ns, width)
    again = np.zeros(ns, dtype=bool)
    if slot_p is not None:
        keyed = flat
        # runs of equal keys, each ordered by payload in place
        key = np.where(live, flat >> U64(32), ~U64(0))
        start = np.ones((ns, width), dtype=bool)
        start[:, 1:] = key[:, 1:] != key[:, :-1]
        rid = np.cumsum(start.reshape(-1)).reshape(ns, width)
        run_len = np.bincount(rid.reshape(-1))[rid]
        again = ((run_len > RUN_MAX) & live).any(axis=1)
        order = np.lexsort((pos.repeat(ns, 0).reshape(-1), flat.reshape(-1),
                            rid.reshape(-1)))
        run0 = np.maximum.accumulate(np.where(start, pos, 0), axis=1)
        dst = np.empty(ns * width, dtype=np.int64)
        # a value's place: its run's start + the run's values before it
        dst[order] = np.arange(ns * width) - np.searchsorted(
            rid.reshape(-1)[order], rid.reshape(-1)[order], side="left")
        dst = dst.reshape(ns, width) + run0
        tie = np.empty_like(flat)
        rows = np.nonzero(live)
        tie[rows[0], dst[rows]] = flat[rows]
        # a longer run: the keys stay where they stand, and (run index,
        # payload) is sorted from the order after the key passes
        run = (rid - rid[:, :1]).astype(U64)
        runs = np.where(live, run + U64(1), U64(0)).max(axis=1)
        pair = (run << U64(32)) | (keyed & U64(0xFFFFFFFF))
        bits = np.where(again, 32 + bit_len(np.maximum(runs, 1) - U64(1)),
                        0)
        v, _ = radix_sort(pair.reshape(ns, nw, it, WARP), n, 0,
                          np.zeros(ns, dtype=U64), bits, again)
        v = ((keyed & U64(0xFFFFFFFF00000000))
             | (v.reshape(ns, width) & U64(0xFFFFFFFF)))
        flat = np.where(again[:, None], v, tie)
    out_k = np.full((ns, cap), KEY_PAD_INT, dtype=np.int64)
    out_p = None if slot_p is None else np.zeros((ns, cap), dtype=np.int64)
    real = live[:, :cap]
    if slot_p is None:
        out_k[real] = flat[:, :cap][real].astype(np.int64)
    else:
        k, p = unpack(flat[:, :cap][real])
        out_k[real], out_p[real] = k, p
    ovf = int(np.maximum(fill - cap, 0).sum())
    return out_k, out_p, n, ovf, passes, again


def model_k1(packed, pay, nb, prm, scale, seed=0):
    rng = np.random.default_rng(seed)
    slot_k, slot_p, fill = k1_scatter(packed, pay, nb, prm, scale, rng)
    k, p, cnt, ovf, passes, again = k1_sort(slot_k, slot_p, fill, prm.cap1)
    shape = (nb, prm.f1, prm.cap1)
    return (k.reshape(shape), None if p is None else p.reshape(shape),
            cnt.reshape(nb, prm.f1), ovf, passes, again)


# ---------------------------------------------------------------------------
# K2


def co_rank(a, na, b, nb_, k):
    """co_rank for many splits at once: a(i) and b(i) read the runs at
    index arrays, na / nb_ / k arrays.  The number of a's values among the
    first k outputs of the merge, a's value first on ties."""
    lo = np.maximum(0, k - nb_)
    hi = np.minimum(k, na)
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        le = a(np.where(act, mid, 0)) <= b(np.where(act, k - 1 - mid, 0))
        lo = np.where(act & le, mid + 1, lo)
        hi = np.where(act & ~le, mid, hi)
    return lo


def first_at_least(keys, c, b, scale, gmax):
    """The binary search of each lane: the first index in [0, c) whose
    fine bucket is >= b (keys: one row a lane)."""
    lo = np.zeros(len(keys), dtype=np.int64)
    hi = np.asarray(c, dtype=np.int64).copy()
    rows = np.arange(len(keys))
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        fb = fine_bucket(keys[rows, np.where(act, mid, 0)], scale, gmax)
        lt = fb < b
        lo = np.where(act & lt, mid + 1, lo)
        hi = np.where(act & ~lt, mid, hi)
    return lo


def merge_level(buf, off, G, w, total, threads, items):
    """One level of k2_merge_kernel: every thread's `items` outputs."""
    if total == 0:
        return buf
    d = np.arange(threads) * items
    live0 = d < total
    dd = np.where(live0, d, 0)
    q = (np.searchsorted(off[:G], dd, side="right") - 1) // (2 * w) * (2 * w)
    ps = off[q]
    pm = off[np.minimum(q + w, G)]
    pe = off[np.minimum(q + 2 * w, G)]
    k = dd - ps
    top = max(total - 1, 0)
    at = lambda x: buf[np.clip(x, 0, top)]  # noqa
    i = co_rank(lambda t: at(ps + t), pm - ps, lambda t: at(pm + t),
                pe - pm, k)
    ia, ib = ps + i, pm + k - i
    out = np.zeros((threads, items), dtype=U64)
    for j in range(items):
        x = d + j
        live = x < total
        while True:             # the next pair starts here
            adv = live & (x == pe)
            if not adv.any():
                break
            q = np.where(adv, q + 2 * w, q)
            ps = np.where(adv, pe, ps)
            pm = np.where(adv, off[np.minimum(q + w, G)], pm)
            pe = np.where(adv, off[np.minimum(q + 2 * w, G)], pe)
            ia = np.where(adv, ps, ia)
            ib = np.where(adv, pm, ib)
        a, b = at(ia), at(ib)
        take_a = (ib >= pe) | ((ia < pm) & (a <= b))
        out[:, j] = np.where(take_a, a, b)
        ia = ia + (take_a & live)
        ib = ib + (~take_a & live)
    return out.reshape(-1)[:total]


def merge_capped(runs, cap2, threads, items):
    """The overflow path: each sub-run merged in turn into the first cap2
    values (the incoming one read where it lies)."""
    acc = np.zeros(0, dtype=U64)
    for run in runs:
        run = run[:cap2]
        if run.size == 0:
            continue
        if acc.size == 0:
            acc = run.copy()
            continue
        m = min(acc.size + run.size, cap2)
        d = np.arange(threads) * items
        live0 = d < m
        na, nb_ = acc.size, run.size
        at_a = lambda x: acc[np.clip(x, 0, na - 1)]  # noqa
        at_b = lambda x: run[np.clip(x, 0, nb_ - 1)]  # noqa
        i = co_rank(at_a, np.full(threads, na), at_b, np.full(threads, nb_),
                    np.where(live0, d, 0))
        ia, ib = i, np.where(live0, d, 0) - i
        out = np.zeros((threads, items), dtype=U64)
        for j in range(items):
            live = d + j < m
            x, y = at_a(ia), at_b(ib)
            take_a = (ib >= nb_) | ((ia < na) & (x <= y))
            out[:, j] = np.where(take_a, x, y)
            ia = ia + (take_a & live)
            ib = ib + (~take_a & live)
        acc = out.reshape(-1)[:m]
    return acc


def model_k2(k1k, k1p, cnt1, prm, scale, buckets=None):
    """k2_merge_kernel on every fine slot (of the level-1 buckets named,
    else all).  Returns (k2, p2 or None, cnt2, overflow, fine slots that
    took the overflow path)."""
    nb = k1k.shape[0]
    G = prm.group
    nbg = nb // G
    f1, f2, cap1, cap2 = prm.f1, prm.f2, prm.cap1, prm.cap2
    warps, items = shape_for(cap2)
    threads = warps * WARP
    out_k = np.full((f1, nbg, f2, cap2), KEY_PAD_INT, dtype=np.int64)
    out_p = None if k1p is None else np.zeros_like(out_k)
    cnt2 = np.zeros((f1, nbg, f2), dtype=np.int64)
    ovf, capped = 0, 0
    for f in range(f1) if buckets is None else buckets:
        for g in range(nbg):
            blks = np.arange(g * G, (g + 1) * G)
            keys = k1k[blks, f]
            c = np.minimum(cnt1[blks, f], cap1)
            vals = (keys.astype(U64) if k1p is None
                    else pack(keys, k1p[blks, f]))
            for j in range(f2):
                lo = first_at_least(keys, c, f * f2 + j, scale, prm.gmax)
                hi = first_at_least(keys, c, f * f2 + j + 1, scale,
                                    prm.gmax)
                lens = hi - lo
                off = np.concatenate([[0], np.cumsum(lens)])
                total = int(off[-1])
                runs = [vals[bi, lo[bi]:hi[bi]] for bi in range(G)]
                if total <= cap2:
                    buf = np.concatenate(runs)
                    w = 1
                    while w < G:
                        buf = merge_level(buf, off, G, w, total, threads,
                                          items)
                        w *= 2
                else:
                    buf = merge_capped(runs, cap2, threads, items)
                    ovf += total - cap2
                    capped += 1
                kept = min(total, cap2)
                cnt2[f, g, j] = kept
                if k1p is None:
                    out_k[f, g, j, :kept] = buf[:kept].astype(np.int64)
                else:
                    kk, pp = unpack(buf[:kept])
                    out_k[f, g, j, :kept], out_p[f, g, j, :kept] = kk, pp
    return out_k, out_p, cnt2, ovf, capped


# ---------------------------------------------------------------------------
# Cases


def _case(name, prm, seed):
    """(packed keys, payloads, scale) that the design can get wrong."""
    rng = np.random.default_rng(seed)
    block = prm.block
    scale = rho3.default_scale(prm)
    gmax = prm.gmax
    # a fine bucket's width in packed keys at the default scale
    width = (1 << 31) // gmax
    # keys enough to fill the fine slots of one window by half
    fill = min(prm.group * block, prm.cap2 // 2 * gmax)
    small = min(prm.cap1, prm.cap2)
    if name == "uniform":
        n = fill
        packed = rng.integers(0, KEY_PAD_INT, n)
    elif name == "tiled FK 4x":
        # R (tag 0) and 4 S copies (tag 1) of each key, S tiled 4 times
        r = rng.choice(1 << 30, fill // 5, replace=False)
        packed = np.concatenate([r << 1] + [(r << 1) | 1] * 4)
    elif name == "50 copies":
        # the aggregate's shape: group keys of ~50 rows, side by side
        n = fill
        packed = (np.arange(n) // 50 * 7919 % (1 << 20)) << 1
        packed[rng.random(n) < 0.5] = KEY_PAD_INT     # K1's slots hold it
        scale = float(np.float32(gmax) / np.float32((1 << 20) + 1)
                      * np.float32(1 - 1e-6))
    elif name == "all equal":
        packed = np.full(small - 3, 2 * 123457 + 1)
    elif name == "empty slots":
        # keys in 3 of the fine buckets only
        n = small // 2
        pick = rng.choice(gmax, 3, replace=False)
        packed = pick[rng.integers(0, 3, n)] * width + rng.integers(
            0, width // 2, n) * 2
    elif name == "partial block and pads":
        n = fill + 777
        packed = rng.integers(0, KEY_PAD_INT, n)
        packed[rng.random(n) < 0.2] = KEY_PAD_INT
    elif name == "mway scale":
        n = fill
        packed = rng.integers(0, 1 << 24, n)
        scale = float(np.float32(gmax) / np.float32((1 << 23) + 1)
                      * np.float32(1 - 1e-6))
    elif name == "K2 overflow":
        # half the keys pads, and in every block about cap2 / group keys in
        # fine bucket 0: no K1 slot overflows, fine slot 0 does
        n = prm.group * block
        packed = rng.integers(0, KEY_PAD_INT, n)
        packed[rng.random(n) < 0.5] = KEY_PAD_INT
        heavy = rng.random(n) < prm.cap2 / prm.group / block
        packed[heavy] = rng.integers(0, width - 2, heavy.sum())
    elif name == "K1 overflow":
        n = prm.group * block
        packed = rng.integers(0, KEY_PAD_INT, n)
        heavy = rng.random(n) < 2.0 * prm.cap1 / block
        packed[heavy] = rng.integers(0, width - 2, heavy.sum())
    else:
        raise KeyError(name)
    pay = rng.integers(-(1 << 31), 1 << 31, packed.size)
    if name == "50 copies":
        pay = rng.integers(-5, 6, packed.size)      # values: few, repeated
    return packed.astype(np.int32), pay.astype(np.int32), scale


CASES = ("uniform", "tiled FK 4x", "50 copies", "all equal", "empty slots",
         "partial block and pads", "mway scale", "K2 overflow")


def _plain(packed, pay, nb, prm, scale):
    t = torch.from_numpy
    a = rho3.k1_plain(t(packed), None if pay is None else t(pay), nb, prm,
                      scale)
    return a


def _np(x):
    return None if x is None else x.numpy().astype(np.int64)


def _check(packed, pay, prm, scale, k1_overflows=False):
    nb = rho3.num_blocks(packed.size, prm)
    mk, mp, mc, movf, passes, again = model_k1(packed, pay, nb, prm, scale)
    wk, wp, wc, wovf = _plain(packed, pay, nb, prm, scale)
    np.testing.assert_array_equal(mc, _np(wc))
    assert movf == int(wovf)
    assert (movf > 0) == k1_overflows
    if not k1_overflows:
        np.testing.assert_array_equal(mk, _np(wk))
        if pay is not None:
            np.testing.assert_array_equal(mp, _np(wp))
    # K2 on the model's K1 output, against the plain version on the same
    t = torch.from_numpy
    k2k, k2p, k2c, k2ovf, capped = model_k2(mk, mp, mc, prm, scale)
    want = rho3.k2_plain(t(mk.astype(np.int32)),
                         None if mp is None else t(mp.astype(np.int32)),
                         t(mc.astype(np.int32)), prm, scale)
    np.testing.assert_array_equal(k2k, _np(want[0]))
    if pay is not None:
        np.testing.assert_array_equal(k2p, _np(want[1]))
    np.testing.assert_array_equal(k2c, _np(want[2]))
    assert k2ovf == int(want[3])
    return passes, again, k2ovf, capped


@pytest.mark.parametrize("with_payload", [False, True])
@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("name", CASES)
def test_model_equals_k1_k2_plain(name, geom, with_payload):
    prm = GEOMS[geom]
    packed, pay, scale = _case(name, prm, seed=CASES.index(name))
    _, again, k2ovf, capped = _check(packed, pay if with_payload else None,
                                     prm, scale)
    if name == "K2 overflow":
        assert k2ovf > 0 and capped > 0
    else:
        assert k2ovf == 0
    if with_payload and name in ("50 copies", "all equal"):
        assert again.any()      # runs past RUN_MAX: every digit again


@pytest.mark.parametrize("with_payload", [False, True])
def test_k1_overflow_counts_and_k2_on_its_output(with_payload):
    prm = GEOMS["128/8/20/4/16"]
    packed, pay, scale = _case("K1 overflow", prm, seed=99)
    _check(packed, pay if with_payload else None, prm, scale,
           k1_overflows=True)


def test_digit_plan():
    """A default-geometry slot of uniform keys spans 2^31 / f1 packed
    values: 26 varying bits, 4 passes; with payloads the same 4 key
    passes, then no run to order again; equal keys take no key pass."""
    prm = rho3.Rho3Params(block_rows=64, slot_rows=8, f1=36, f2=16,
                          kd_slot_rows=16)
    rng = np.random.default_rng(3)
    packed = rng.integers(0, KEY_PAD_INT, prm.block).astype(np.int32)
    pay = rng.integers(0, 1 << 31, prm.block).astype(np.int32)
    scale = rho3.default_scale(prm)
    for p in (None, pay):
        *_, passes, again = model_k1(packed, p, 1, prm, scale)
        assert set(passes.tolist()) == {4} and not again.any()
    eq = np.full(100, 77 * 2, dtype=np.int32)
    *_, passes, again = model_k1(eq, pay[:100], 1, prm, scale)
    assert passes.max() == 0 and again.sum() == 1


def test_co_rank_at_run_edges_and_ties():
    """Splits at k = 0, at the ends of runs of unequal length (one empty),
    and inside long runs of equal values equal a stable merge."""
    rng = np.random.default_rng(5)
    for na, nb_ in ((0, 7), (7, 0), (1, 40), (33, 5), (64, 64)):
        a = np.sort(rng.integers(0, 4, na).astype(U64))
        b = np.sort(rng.integers(0, 4, nb_).astype(U64))
        order = np.argsort(np.concatenate([a, b]), kind="stable")
        from_a = order < na
        ks = np.arange(na + nb_ + 1)
        got = co_rank(lambda t: a[np.clip(t, 0, max(na - 1, 0))],
                      np.full(ks.size, na),
                      lambda t: b[np.clip(t, 0, max(nb_ - 1, 0))],
                      np.full(ks.size, nb_), ks)
        want = np.array([from_a[:k].sum() for k in ks])
        np.testing.assert_array_equal(got, want)


def test_merge_level_crosses_pairs_of_unequal_runs():
    """A level over sub-runs of unequal length, some empty, with ties:
    each pair merged, a thread's outputs crossing into the next pair."""
    rng = np.random.default_rng(8)
    lens = np.array([5, 0, 9, 1, 0, 0, 17, 3])
    runs = [np.sort(rng.integers(0, 6, m).astype(U64)) for m in lens]
    off = np.concatenate([[0], np.cumsum(lens)])
    buf = np.concatenate(runs)
    total = int(off[-1])
    w = 1
    while w < lens.size:
        buf = merge_level(buf, off, lens.size, w, total, threads=64,
                          items=ITEMS)
        for q in range(0, lens.size, 2 * w):
            seg = buf[off[q]:off[min(q + 2 * w, lens.size)]]
            assert (seg[1:] >= seg[:-1]).all()
        w *= 2
    np.testing.assert_array_equal(buf, np.sort(np.concatenate(runs)))


def test_capped_merge_keeps_the_first_values():
    rng = np.random.default_rng(9)
    runs = [np.sort(rng.integers(0, 50, m).astype(U64))
            for m in (300, 0, 700, 10, 512)]
    got = merge_capped(runs, 1024, threads=256, items=ITEMS)
    np.testing.assert_array_equal(got, np.sort(np.concatenate(runs))[:1024])


@pytest.mark.parametrize("with_payload", [False, True])
def test_kernel_constants_on_one_default_window(with_payload, monkeypatch):
    """The model at the kernels' own constants (a chunk of 8,192 keys, 16
    values a thread, RUN_MAX = 32) on the default geometry: K1 over one
    window's 32 blocks of uniform keys, K2 on the window of one level-1
    bucket, against the plain versions."""
    model = sys.modules[__name__]
    for name, value in (("SC_THREADS", 512), ("SC_ITEMS", 16), ("ITEMS", 16),
                        ("RUN_MAX", 32)):
        monkeypatch.setattr(model, name, value)
    prm = rho3.Rho3Params()
    rng = np.random.default_rng(21)
    n = prm.group * prm.block - 12345
    packed = rng.integers(0, KEY_PAD_INT, n).astype(np.int32)
    pay = (rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
           if with_payload else None)
    scale = rho3.default_scale(prm)
    nb = rho3.num_blocks(n, prm)
    assert nb == prm.group
    f = 17
    t = torch.from_numpy
    wk, wp, wc, wovf = rho3.k1_plain(t(packed), None if pay is None
                                     else t(pay), nb, prm, scale)
    assert int(wovf) == 0
    # K1: the scatter over every block, the sort of bucket f's slots
    rng2 = np.random.default_rng(0)
    slot_k, slot_p, fill = k1_scatter(packed, pay, nb, prm, scale, rng2)
    rows = np.arange(nb) * prm.f1 + f
    k, p, cnt, ovf, passes, _ = k1_sort(
        slot_k[rows], None if slot_p is None else slot_p[rows], fill[rows],
        prm.cap1)
    np.testing.assert_array_equal(cnt, _np(wc[:, f]))
    np.testing.assert_array_equal(k, _np(wk[:, f]))
    if pay is not None:
        np.testing.assert_array_equal(p, _np(wp[:, f]))
    assert ovf == 0 and set(passes.tolist()) == {4}
    # K2 on that window, from the model's K1 slots of bucket f
    ref = rho3.k2_plain(wk, wp, wc, prm, scale)
    mk = np.zeros((nb, prm.f1, prm.cap1), dtype=np.int64)
    mc = np.zeros((nb, prm.f1), dtype=np.int64)
    mk[:, f], mc[:, f] = k, cnt
    mp = None
    if pay is not None:
        mp = np.zeros_like(mk)
        mp[:, f] = p
    k2k, k2p, k2c, k2ovf, _ = model_k2(mk, mp, mc, prm, scale, [f])
    np.testing.assert_array_equal(k2k[f], _np(ref[0][f]))
    np.testing.assert_array_equal(k2c[f], _np(ref[2][f]))
    if pay is not None:
        np.testing.assert_array_equal(k2p[f], _np(ref[1][f]))
    assert k2ovf == 0
