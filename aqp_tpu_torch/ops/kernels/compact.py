"""Row-granular compaction: block sort with bucket starts, and segment
scatter (counterpart of aqp_tpu/ops/pallas/compact.py).

`sort_hist(key, payload, scale, sub, F)` sorts each block of sub*128
(key, payload) pairs (blocksort.sort_blocks' order) and returns them as
(rows, 128) arrays, with `starts` (blocks, F + 1): per block, the number
of rows whose bucket is below f, each row bucketed by its leading key
(F for a key >= PACKED_PAD_MIN, else clamp(int(float32(lead >> 1) *
scale), 0, F - 1), in float32 as the reference computes it).

`scatter_segments` copies `nseg` row segments of a (rows, 128) key array and
its payload array to destination row offsets of the output, and every row
no segment covers holds `fill_key` (0 in the payload);
`scatter_segments_one` does the same for one array.  Segment i copies
source rows [soff_i, soff_i + sz_i) to output rows [doff_i, doff_i + sz_i);
segments may come in any order and must not overlap in the output.  The
kernel writes every output row once, fill included, into an uninitialised
buffer: one launch a call and nothing around it.  The output has
`out_rows` rows and, as in the reference, callers keep only the first
out_rows - 1 (the reference's last row is the trash row its DMA ring aims
empty segments at; the port fills it).

`compact_kp` is the two together: the row-granular compactor of a masked
(key, payload) column pair, with `_plan` computing each (block, bucket)
segment's source, destination and the overflow.

Each kernel has a plain PyTorch version (`sort_hist_plain`,
`scatter_segments_plain`, the gather formulation of the reference's
`_scatter_reference`) and a wrapper that sends a CPU tensor to it and a
CUDA tensor to the hand-written kernel in csrc/blocksort.cu or
csrc/compact.cu; there is no fallback from one to the other.  `LAUNCHES`
counts the kernel launches.
"""

from __future__ import annotations

import torch

from aqp_tpu_torch.ops.kernels import build
from aqp_tpu_torch.ops.kernels.blocksort import (check_blocks, launch_sort,
                                                 sort_blocks_plain)
from aqp_tpu_torch.ops.kernels.build import need, on_cuda, ptr, stream
from aqp_tpu_torch.ops.kernels.rho3 import (KEY_PAD_INT, LANES, PAD_R_INPUT,
                                            PAD_S_INPUT, _f32)

__all__ = ["KEY_PAD_INT", "PAD_R_INPUT", "PAD_S_INPUT", "PACKED_PAD_MIN",
           "LAUNCHES", "sort_hist", "sort_hist_plain", "scatter_segments",
           "scatter_segments_one", "scatter_segments_plain", "compact_kp"]

# Every packed key >= PACKED_PAD_MIN (PAD_R_INPUT << 1) is a pad: it sorts
# last and buckets to F.
PACKED_PAD_MIN = 2147483644

# Launches of each hand-written kernel in this process (the plain version
# does not count).  Reset by assigning 0.
LAUNCHES = {"sort_hist": 0, "scatter_segments": 0,
            "scatter_segments_one": 0}


def _check_hist(n: int, sub: int, F: int) -> int:
    if not 1 <= F < LANES:
        raise ValueError(f"F={F}; sort_hist takes 1 <= F <= {LANES - 1}")
    return check_blocks(n, sub)


def row_buckets(lead: torch.Tensor, scale: float, F: int) -> torch.Tensor:
    """Bucket of each row by its leading key: F for a pad (lead >=
    PACKED_PAD_MIN), else clamp(int(float32(lead >> 1) * scale), 0, F - 1)
    in float32 (clamping before the cut to int gives the same value and
    never converts an out-of-range float)."""
    prod = (lead >> 1).to(torch.float32) * torch.tensor(
        scale, dtype=torch.float32)
    g = prod.clamp(0, F - 1).to(torch.int64)
    return torch.where(lead >= PACKED_PAD_MIN, F, g)


def sort_hist_plain(key, payload, scale, sub: int, F: int):
    """The block sort, then per block the exclusive prefix of its rows'
    bucket counts.  Returns ks, ps (n/128, 128) and starts (nb, F + 1),
    all int32."""
    nb = _check_hist(key.numel(), sub, F)
    ks, ps = sort_blocks_plain(key, payload, sub)
    ks, ps = ks.view(-1, LANES), ps.view(-1, LANES)
    b = row_buckets(ks[:, 0], _f32(scale), F)
    blk = torch.arange(nb * sub, device=key.device) // sub
    hist = torch.bincount(blk * (F + 1) + b, minlength=nb * (F + 1))
    hist = hist.view(nb, F + 1)
    starts = torch.cumsum(hist, 1) - hist
    return ks, ps, starts.to(torch.int32)


def sort_hist(key, payload, scale, sub: int, F: int):
    """Block-sort flat (row-major) key/payload; return (ks, ps, starts):
    ks/ps (n/128, 128) sorted blocks, starts (nb, F + 1) the row index in
    its block where each bucket begins (the per-block histogram of the
    reference's partition pass as sorted-run boundaries)."""
    if not on_cuda(key):
        return sort_hist_plain(key, payload, scale, sub, F)
    nb = _check_hist(key.numel(), sub, F)
    starts = torch.empty((nb, F + 1), dtype=torch.int32, device=key.device)
    ok, op = launch_sort("sort_hist", key, payload, sub,
                         hist=(F, _f32(scale), starts))
    LAUNCHES["sort_hist"] += 1
    return ok.view(-1, LANES), op.view(-1, LANES), starts


def scatter_segments_plain(arrays, soff, doff, sz, out_rows: int,
                           fill_key: int = KEY_PAD_INT):
    """The segment copy as a gather: output row j covered by segment i
    (doff_i <= j < doff_i + sz_i) reads source row soff_i + (j - doff_i),
    clamped to the source; other rows hold fill_key (array 0) or 0.
    Segments with sz <= 0, or starting outside [0, out_rows), are dropped.
    Returns one (out_rows, 128) array per input array."""
    if soff.numel() == 0:                   # no segment: all fill
        return [x.new_full((out_rows, x.shape[1]), fill_key if i == 0 else 0)
                for i, x in enumerate(arrays)]
    src_rows = arrays[0].shape[0]
    dev = arrays[0].device
    soff, doff, sz = soff.long(), doff.long(), sz.long()
    live = (sz > 0) & (doff >= 0) & (doff < out_rows)
    # one slot past the end takes every dropped segment
    dpos = torch.where(live, doff, out_rows)
    marks = torch.zeros(out_rows + 1, dtype=torch.bool, device=dev)
    seg_at = torch.full((out_rows + 1,), -1, dtype=torch.int64, device=dev)
    marks[dpos] = True
    seg_at[dpos] = torch.arange(soff.numel(), device=dev)
    j = torch.arange(out_rows, device=dev)
    last = torch.where(marks[:out_rows], j, -1).cummax(0).values
    seg = seg_at[last.clamp(min=0)].clamp(min=0)
    seen = last >= 0
    f_soff = torch.where(seen, soff[seg], 0)
    f_doff = torch.where(seen, doff[seg], 0)
    f_sz = torch.where(seen, sz[seg], 0)
    inside = seen & ((j - f_doff) < f_sz) & (f_sz > 0)
    src = (f_soff + (j - f_doff)).clamp(0, src_rows - 1)
    outs = []
    for i, x in enumerate(arrays):
        fill = fill_key if i == 0 else 0
        outs.append(torch.where(inside[:, None], x[src],
                                torch.full_like(x[:1], fill)))
    return outs


def _launch(arrays, soff, doff, sz, nseg: int, out_rows: int,
            fill_key: int, name: str):
    dev = arrays[0].device
    rows = arrays[0].shape[0]
    for i, x in enumerate(arrays):
        need(x, f"array {i}", (rows, LANES), dev)
    for t, what in ((soff, "soff"), (doff, "doff"), (sz, "sz")):
        need(t, what, (nseg,), dev)
    if rows == 0 and nseg:
        raise ValueError("segments of an empty source")
    for x in arrays:
        if x.data_ptr() % 16:
            raise ValueError("the segment scatter needs 16-byte aligned rows")
    # the kernel writes every output row, the fill included
    outs = [torch.empty((out_rows, LANES), dtype=torch.int32, device=dev)
            for _ in arrays]
    lib = build.load()
    err = lib.scatter_segments(
        ptr(arrays[0]), ptr(arrays[1]) if len(arrays) == 2 else None,
        ptr(soff), ptr(doff), ptr(sz), nseg, rows, out_rows, fill_key,
        ptr(outs[0]), ptr(outs[1]) if len(outs) == 2 else None,
        stream(dev))
    build.check(lib, err, name)
    LAUNCHES[name] += 1
    return outs


def scatter_segments(ks, ps, soff, doff, sz, nseg: int, out_rows: int,
                     fill_key: int = KEY_PAD_INT):
    """Copy `nseg` row segments of (ks, ps) to their destination rows.
    soff/doff/sz: int32 (nseg,).  Returns (ok, op), each (out_rows, 128)."""
    if not on_cuda(ks):
        ok, op = scatter_segments_plain([ks, ps], soff, doff, sz, out_rows,
                                        fill_key)
        return ok, op
    ok, op = _launch([ks, ps], soff, doff, sz, nseg, out_rows, fill_key,
                     "scatter_segments")
    return ok, op


def scatter_segments_one(ks, soff, doff, sz, nseg: int, out_rows: int,
                         fill_key: int = KEY_PAD_INT):
    """scatter_segments for one array.  Returns ok (out_rows, 128)."""
    if not on_cuda(ks):
        return scatter_segments_plain([ks], soff, doff, sz, out_rows,
                                      fill_key)[0]
    return _launch([ks], soff, doff, sz, nseg, out_rows, fill_key,
                   "scatter_segments_one")[0]


# ---------------------------------------------------------------------------
# glue: segments + cursors + overflow

def _plan(nb: int, sub: int, starts, nb_f: int, cap_rows: int):
    """Per (block, bucket) segment: source row, destination row (region f
    starts at f * cap_rows, blocks in order) and size in rows, flattened
    block-major; and the overflow, the rows beyond cap_rows summed over
    regions (0-dim int64).  Each segment starts one row before its
    bucket's first row, as the reference's does: that row may hold the
    bucket's first elements."""
    starts = starts.long()
    r0 = (starts[:, :nb_f] - 1).clamp(min=0)
    r1 = starts[:, 1:nb_f + 1]
    sz = (r1 - r0).clamp(min=0)
    prior = torch.cumsum(sz, 0) - sz
    overflow = (sz.sum(0) - cap_rows).clamp(min=0).sum()
    dev = starts.device
    doff = torch.arange(nb_f, device=dev)[None, :] * cap_rows + prior
    soff = torch.arange(nb, device=dev)[:, None] * sub + r0
    return (soff.reshape(-1).to(torch.int32),
            doff.reshape(-1).to(torch.int32),
            sz.reshape(-1).to(torch.int32), overflow)


def _pad_to(x: torch.Tensor, mult: int, fill: int) -> torch.Tensor:
    pad = (-x.numel()) % mult
    if pad:
        x = torch.cat([x, x.new_full((pad,), fill)])
    return x


def _i32(x: int) -> int:
    """x wrapped to a signed 32-bit value."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def compact_kp(key, payload, cap_rows: int, sub: int = 1024,
               pad_key: int = PAD_S_INPUT):
    """Row-granular compaction of a masked (key, payload) column pair.

    Input: full-size int32 columns where invalid rows carry a key >=
    PAD_R_INPUT.  Output: (key (cap_rows*128,), payload, overflow): every
    valid element present, pad elements only in rows at a block's
    boundary, empty slots keyed `pad_key`.  overflow > 0 (0-dim int64)
    means cap_rows was too small.

    Keys are packed as key << 1 | 1 (in int32, as the reference), so
    PAD_R_INPUT packs to PACKED_PAD_MIN and PAD_S_INPUT to KEY_PAD_INT;
    the sort with F = 1 and scale 0 puts each block's valid rows first and
    its pad rows (bucket 1) last, and one segment per block copies the
    valid rows and the boundary row."""
    block = sub * LANES
    packed = ((key.long() << 1) | 1).to(torch.int32)
    packed = _pad_to(packed, block, KEY_PAD_INT)
    pay = _pad_to(payload, block, 0)
    nb = packed.numel() // block
    ks, ps, starts = sort_hist(packed, pay, 0.0, sub, 1)
    soff, doff, sz, ovf = _plan(nb, sub, starts, 1, cap_rows)
    fill = _i32((pad_key << 1) | 1)
    ok, op = scatter_segments(ks, ps, soff, doff, sz, nb, cap_rows + 1,
                              fill_key=fill)
    out_k = ok[:cap_rows].reshape(-1) >> 1
    out_p = op[:cap_rows].reshape(-1)
    return out_k, out_p, ovf
