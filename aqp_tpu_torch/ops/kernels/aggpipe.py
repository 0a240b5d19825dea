"""Routed group-by aggregate (counterpart of aqp_tpu/ops/pallas/aggpipe.py).

The sort-based aggregate (ops/aggregate.py) sorts the whole input.  This
pipeline reuses the fixed-slot routing of the RHO join (ops/kernels/rho3.py)
range-routed (salt 1 and a scale from the largest key), so every (f1, f2)
region holds an ascending key range and every key lies in one region, and
aggregates each region in one kernel:

  K3AGG  per region: one row per distinct key (key, count, sum mod 2^32,
         min, max), the rows dense and ascending at the start of the
         region's block, (HOLE, 0, 0, 0, 0) behind, and the region's count
         (csrc/aggpipe.cu, B9);

then the regions' rows are concatenated, whole 128-wide rows at a time,
with the segment scatters (ops/kernels/compact.py).  Group keys come out
ascending, with holes only at region boundaries.

K3AGG has a plain PyTorch version (`k3agg_plain`) and a wrapper (`k3agg`)
that sends a CPU tensor to it and a CUDA tensor to the hand-written kernel;
there is no fallback from one to the other.  `LAUNCHES` counts its
launches.  The sums are int64 in [0, 2^32) (the reference's uint32), and
`num_groups` a 0-dim int64 tensor, poisoned to 2^30 when routing overflowed
or the capacity cut rows: such a result is incomplete, and callers check
num_groups <= capacity, as bench.py does.
"""

from __future__ import annotations

import torch

from aqp_tpu_torch import check_device
from aqp_tpu_torch.ops.aggregate import GroupByResult
from aqp_tpu_torch.ops.kernels import build
from aqp_tpu_torch.ops.kernels.build import need, on_cuda, ptr, stream
from aqp_tpu_torch.ops.kernels.compact import (scatter_segments,
                                               scatter_segments_one)
from aqp_tpu_torch.ops.kernels.rho3 import (HASH_MASK, KEY_PAD_INT, LANES,
                                            MAX_KEY, Rho3Params,
                                            halving_counter, pack_keys,
                                            route_2level, subranges)

HOLE = -3            # dead output slot key (never a real group key)
POISON = 1 << 30     # num_groups of an incomplete result
_U32 = 0xFFFFFFFF
INT32_MAX = (1 << 31) - 1
INT32_MIN = -(1 << 31)

# Launches of the hand-written kernel in this process (the plain version
# does not count).  Reset by assigning 0.
LAUNCHES = {"K3AGG": 0}


def k3agg_plain(k2, p2, cnt2):
    """K3AGG in plain PyTorch.  k2/p2 (f1, nbg, f2, cap2) fine slots, cnt2
    (f1, nbg, f2).  Returns (key, count, sum, min, max, counts): five int32
    region blocks (f1 * f2, nbg * cap2), region index a * f2 + b, and the
    per-region group count.  Block row g of a region is the region's g-th
    smallest valid key k (k >= 0, k != KEY_PAD_INT among the slots' real
    elements) as ((k >> 1) & (2^30 - 1), the number of its elements, their
    values' sum mod 2^32 as int32 bits, min, max); past the count (HOLE, 0,
    0, 0, 0)."""
    f1, nbg, f2, cap2 = k2.shape
    nreg, w = f1 * f2, nbg * cap2
    dev = k2.device
    k = k2.long()
    live = ((torch.arange(cap2, device=dev) < cnt2[..., None].long())
            & (k >= 0) & (k != KEY_PAD_INT))
    a, _, b, _ = torch.nonzero(live, as_tuple=True)
    comp, order = torch.sort((a * f2 + b) * (1 << 32) + k[live])
    val = p2[live][order]
    start = torch.ones_like(comp, dtype=torch.bool)
    start[1:] = comp[1:] != comp[:-1]
    gid = torch.cumsum(start, 0) - 1
    g_comp = comp[start]
    ng = g_comp.numel()
    g_reg, g_key = g_comp >> 32, g_comp & _U32
    cnt = torch.bincount(gid, minlength=ng)
    sm = torch.zeros(ng, dtype=torch.int64, device=dev).index_add_(
        0, gid, val.long() & _U32) & _U32
    mn = torch.full((ng,), INT32_MAX, dtype=torch.int32, device=dev)
    mn.scatter_reduce_(0, gid, val, "amin")
    mx = torch.full((ng,), -INT32_MAX - 1, dtype=torch.int32, device=dev)
    mx.scatter_reduce_(0, gid, val, "amax")
    counts = torch.bincount(g_reg, minlength=nreg)
    rank = torch.arange(ng, device=dev) - (torch.cumsum(counts, 0)
                                           - counts)[g_reg]
    q = g_reg * w + rank
    outs = []
    for fill, col in ((HOLE, (g_key >> 1) & HASH_MASK), (0, cnt),
                      (0, torch.where(sm > INT32_MAX, sm - (1 << 32), sm)),
                      (0, mn), (0, mx)):
        o = torch.full((nreg * w,), fill, dtype=torch.int32, device=dev)
        o[q] = col.to(torch.int32)
        outs.append(o.view(nreg, w))
    return (*outs, counts.to(torch.int32))


def k3agg(k2, p2, cnt2):
    """K3AGG: per-region group rows of range-routed fine slots (see
    k3agg_plain).  Adds the pieces it halved to the device's
    rho3.halving_counter."""
    if not on_cuda(k2):
        return k3agg_plain(k2, p2, cnt2)
    dev = k2.device
    f1, nbg, f2, cap2 = k2.shape
    need(k2, "k2", (f1, nbg, f2, cap2), dev)
    need(p2, "p2", (f1, nbg, f2, cap2), dev)
    need(cnt2, "cnt2", (f1, nbg, f2), dev)
    nreg, w = f1 * f2, nbg * cap2
    P = subranges(nbg, cap2)   # as K3's
    scratch = [torch.empty((nreg * w,), dtype=torch.int32, device=dev)
               for _ in range(5)]
    sub = [torch.empty((nreg * P,), dtype=torch.int32, device=dev)
           for _ in range(2)]
    outs = [torch.empty((nreg, w), dtype=torch.int32, device=dev)
            for _ in range(5)]
    counts = torch.empty((nreg,), dtype=torch.int32, device=dev)
    lib = build.load()
    err = lib.aggpipe_k3agg(ptr(k2), ptr(p2), ptr(cnt2), f1, nbg, f2, cap2,
                            P, *map(ptr, scratch), *map(ptr, sub),
                            *map(ptr, outs), ptr(counts),
                            ptr(halving_counter(dev)), stream(dev))
    build.check(lib, err, "aggpipe K3AGG")
    LAUNCHES["K3AGG"] += 1
    return (*outs, counts)


def _range_scale(key, prm: Rho3Params) -> float:
    """The sigma -> fine bucket scale gmax / (kmax + 1) * (1 - 1e-6) of the
    largest routed key, in float32 as the reference computes it (one host
    sync for kmax)."""
    kmax = torch.where(key >= MAX_KEY, 0, key).max()
    gmax = torch.tensor(float(prm.gmax), dtype=torch.float32,
                        device=key.device)
    return (gmax / (kmax.to(torch.float32) + 1.0) * (1.0 - 1e-6)).item()


def groupby_aggregate_routed(key, value, capacity: int,
                             prm: Rho3Params = Rho3Params(),
                             device="cuda") -> GroupByResult:
    """Routed group-by aggregate of int32 (key, value) rows.  Rows with
    key < 0 or key >= MAX_KEY are dropped (the holes of chunked output);
    group keys come out ascending with holes (key HOLE) at region
    boundaries.  Size capacity >= num_groups + 128 * f1 * f2 (one partial
    row per region); a routing overflow or a capacity cut poisons
    num_groups to 2^30, never a silent loss."""
    check_device(device, key, value)
    key = torch.where(key < 0, MAX_KEY, key)
    scale = _range_scale(key, prm)
    packed, _ = pack_keys(key, torch.zeros_like(key), 1)
    k2, v2, cnt2, nbg, ovf = route_2level(packed, value, prm, True,
                                          scale=scale)
    *blocks, counts = k3agg(k2, v2, cnt2)
    return assemble_regions(blocks, counts, ovf, nbg, prm, capacity)


def assemble_regions(blocks, counts, ovf, nbg: int, prm: Rho3Params,
                     capacity: int) -> GroupByResult:
    """Concatenate K3AGG's region blocks into `capacity` rows, whole
    128-wide rows per region: (key, count) and (sum, min) through
    scatter_segments, max through scatter_segments_one.  num_groups is
    poisoned when the routing overflowed (ovf > 0) or the capacity cut a
    region's rows."""
    nreg = prm.f1 * prm.f2
    wrows = nbg * prm.kd_slot_rows
    c = counts.long()
    rows_per = -(-c // LANES)
    doff = torch.cumsum(rows_per, 0) - rows_per
    cap_rows = -(-capacity // LANES)
    # clamp the segments to the output; any clamping is reported below
    sz = torch.minimum(rows_per, cap_rows - doff).clamp(min=0)
    truncated = (rows_per - sz).sum()
    soff = torch.arange(nreg, device=counts.device) * wrows
    desc = [t.to(torch.int32) for t in (soff, doff.clamp(max=cap_rows), sz)]
    flat = [b.view(nreg * wrows, LANES) for b in blocks]
    gk, gc = scatter_segments(flat[0], flat[1], *desc, nreg, cap_rows + 1,
                              fill_key=HOLE)
    gs, gmn = scatter_segments(flat[2], flat[3], *desc, nreg, cap_rows + 1,
                               fill_key=0)
    gmx = scatter_segments_one(flat[4], *desc, nreg, cap_rows + 1,
                               fill_key=0)
    gk, gc, gs, gmn, gmx = (o[:cap_rows].reshape(-1)[:capacity]
                            for o in (gk, gc, gs, gmn, gmx))
    live = gk != HOLE
    num_groups = torch.where((ovf > 0) | (truncated > 0), POISON, c.sum())
    return GroupByResult(
        num_groups=num_groups,
        key=gk,
        count=torch.where(live, gc, 0),
        sum=torch.where(live, gs.long() & _U32, 0),
        min=torch.where(live, gmn, 0),
        max=torch.where(live, gmx, 0),
    )


def _pow2_floor(x: int) -> int:
    return 1 << max(0, x.bit_length() - 1)


def jitter_for(capacity: int) -> int:
    """Pseudo-groups per key of groupby_aggregate_routed_auto: enough that
    `capacity` groups make about 2^15 of them, a power of two in [1, 4096]."""
    return max(1, min(4096, _pow2_floor(32768 // max(1, capacity))))


def fitted_jitter(key, jitter: int) -> torch.Tensor:
    """The largest of jitter, jitter / 2, ..., 1 with (kmax + 1) * J <=
    MAX_KEY, kmax the largest key below MAX_KEY: every pseudo-group key
    then stays below MAX_KEY.  A 0-dim int64 tensor, computed on the
    device (no host sync)."""
    if key.numel() == 0:
        return torch.tensor(jitter, device=key.device)
    kmax = torch.where(key < MAX_KEY, key, -1).amax().clamp(min=0)
    cand = jitter >> torch.arange(jitter.bit_length(), device=key.device)
    fits = (kmax.long() + 1) * cand <= MAX_KEY
    return torch.where(fits, cand, 1).amax()


def jittered_keys(key, jitter):
    """key * jitter + row mod jitter (jitter an int or a 0-dim tensor, a
    power of two), wrapping in int32 as the reference's does; keys outside
    [0, MAX_KEY) (holes and pads) stay as they are, so the routed pipeline
    drops them as the plain branch does."""
    j = torch.arange(key.numel(), device=key.device) & (jitter - 1)
    ekey = ((key.long() * jitter + j - INT32_MIN) & _U32) + INT32_MIN
    return torch.where((key < 0) | (key >= MAX_KEY), key,
                       ekey.to(torch.int32))


def groupby_aggregate_routed_auto(key, value, capacity: int,
                                  prm: Rho3Params = Rho3Params(),
                                  device="cuda") -> GroupByResult:
    """Cardinality-robust routed aggregate: JITTERED range routing.

    With few groups a key's rows overflow the fixed slots.  So every key
    splits into J pseudo-groups (ekey = key * J + row mod J, wrapping in
    int32 as the reference's does) that spread over regions; the routed
    pipeline aggregates them exactly, and a small second level (a sort of
    the pseudo-group rows by key and a scatter-combine, plain PyTorch)
    collapses them into `capacity` rows.  J comes from `capacity` (the
    caller's cardinality bound); J = 1 is the plain pipeline with capacity
    padded by one boundary row per region, so its output is that long.
    Where the largest live key kmax would make key * J + J - 1 reach
    MAX_KEY, J halves until it does not (fitted_jitter, on the device;
    down to 1, which runs the jittered branch's second level on plain
    keys): every group stays exact, and a slot overflow at the smaller J
    poisons num_groups.  (The reference keeps J and merges or drops such
    groups.)  The first level's capacity stays the capacity's J's."""
    check_device(device, key, value)
    jitter = jitter_for(capacity)
    slack = LANES * prm.f1 * prm.f2 + LANES
    if jitter == 1:
        return groupby_aggregate_routed(key, value, capacity + slack, prm,
                                        device=device)
    dev = key.device
    cap1 = capacity * jitter + slack
    jitter = fitted_jitter(key, jitter)
    g = groupby_aggregate_routed(jittered_keys(key, jitter), value, cap1,
                                 prm, device=device)
    big = INT32_MAX
    hole = g.key == HOLE
    base, order = torch.sort(torch.where(hole, big, g.key // jitter))
    cnt = g.count[order].long()
    sm = g.sum[order]
    mn = torch.where(hole, big, g.min)[order]
    mx = torch.where(hole, -big - 1, g.max)[order]
    live = base != big
    start = live.clone()
    start[1:] &= base[1:] != base[:-1]
    gid = torch.where(live, torch.cumsum(start, 0) - 1, capacity)
    gid = gid.clamp(max=capacity)          # rows past capacity are dropped
    okey = torch.full((capacity + 1,), HOLE, dtype=torch.int32, device=dev)
    okey[gid] = base
    ocnt = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    ocnt.scatter_reduce_(0, gid, cnt, "sum")
    osum = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    osum.scatter_reduce_(0, gid, sm, "sum")
    omin = torch.full((capacity + 1,), big, dtype=torch.int32, device=dev)
    omin.scatter_reduce_(0, gid, mn, "amin")
    omax = torch.full((capacity + 1,), -big - 1, dtype=torch.int32,
                      device=dev)
    omax.scatter_reduce_(0, gid, mx, "amax")
    okey = okey[:capacity]
    num = torch.where(g.num_groups > cap1, POISON, start.sum())
    lm = okey != HOLE
    return GroupByResult(
        num_groups=num,
        key=okey,
        count=torch.where(lm, ocnt[:capacity].to(torch.int32), 0),
        sum=torch.where(lm, osum[:capacity] & _U32, 0),
        min=torch.where(lm, omin[:capacity], 0),
        max=torch.where(lm, omax[:capacity], 0),
    )

