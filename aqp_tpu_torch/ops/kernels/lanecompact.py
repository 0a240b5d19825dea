"""Windowed stable compaction (counterpart of
aqp_tpu/ops/pallas/lanecompact.py, the two entry points the
compacted-residual skew tier uses).

`compact_kp_fast` / `compact_k_fast` compact the (key, payload) rows, or the
keys, whose key is below PAD_R_INPUT into a buffer of `cap_rows` 128-wide
rows, in two steps:

  _compact_windows  per window of w*128 elements, keep the elements with
                    lo <= key <= hi in order and write the first ow*128 of
                    them to the window's (ow, 128) block, the array's fill
                    behind; counts are UNCAPPED (a window with more kept
                    elements than ow*128 is cut, and reported);
  _assemble         concatenate the windows' blocks, whole rows at a time,
                    with the segment scatter (ops/kernels/compact.py).

Boundary rows may carry fill elements between windows: the reference's
block-granular contract.  `overflow` counts both window cuts and capacity
truncation; a result with overflow > 0 is incomplete and callers escalate.

`_compact_windows` has a plain PyTorch version (`compact_windows_plain`)
and sends a CUDA tensor to the hand-written kernel in csrc/lanecompact.cu;
there is no fallback from one to the other.  `LAUNCHES` counts the kernel
launches.  The reference's scan entry points (`scan_*_fast`), its uint8
column and its dictionary decode belong to a later slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from aqp_tpu_torch.ops.kernels import build
from aqp_tpu_torch.ops.kernels.build import need, on_cuda, ptr, stream
from aqp_tpu_torch.ops.kernels.compact import (PAD_R_INPUT, PAD_S_INPUT,
                                               scatter_segments,
                                               scatter_segments_one)
from aqp_tpu_torch.ops.kernels.rho3 import LANES

# Launches of the hand-written kernel in this process (the plain version
# does not count).  Reset by assigning 0.
LAUNCHES = {"compact_windows": 0}

INT32_MIN = -(1 << 31)


def _ceil8(x: int) -> int:
    return max(8, -(-x // 8) * 8)


def out_w_for(w: int, sel_hint: Optional[float],
              margin: float = 1.35) -> int:
    """Selectivity-scaled output rows per window: enough for sel_hint *
    margin plus binomial fluctuation, rounded to whole groups of 8 rows.
    None -> full width (no cut possible)."""
    if sel_hint is None:
        return w
    frac = min(1.0, max(0.0, sel_hint) * margin + 6.0 / w)
    return min(w, _ceil8(int(w * frac) + 8))


def compact_windows_plain(col, payloads, lo: int, hi: int, w: int,
                          fills: Sequence[int], ow: int):
    """_compact_windows in plain PyTorch (see there)."""
    n = col.numel()
    block = w * LANES
    nb = -(-n // block)
    cap = ow * LANES
    dev = col.device
    pad = nb * block - n
    idx = torch.arange(nb * block, device=dev)
    x = torch.cat([col, col.new_full((pad,), INT32_MIN)])
    keep = ((x >= lo) & (x <= hi) & (idx < n)).view(nb, block)
    counts = keep.sum(1).to(torch.int32)
    rank = torch.cumsum(keep, 1) - 1
    sel = keep & (rank < cap)
    win = torch.arange(nb, device=dev)[:, None].expand(nb, block)[sel]
    dst = win * cap + rank[sel]
    blocks = []
    for a, f in zip(payloads, fills):
        av = torch.cat([a, a.new_zeros(pad)]).view(nb, block)
        out = torch.full((nb * cap,), f, dtype=torch.int32, device=dev)
        out[dst] = av[sel]
        blocks.append(out.view(nb, ow, LANES))
    return blocks, counts


def _compact_windows(col, payloads, lo: int, hi: int, w: int,
                     fills: Sequence[int], ow: int = 0):
    """Compact every window of w*128 elements of `col` by lo <= x <= hi.

    payloads: one or two int32 arrays of col's length, moved through the
    compaction (the callers pass the key column itself as the first);
    fills: per array, the value of the block's slots past its count.
    Returns (list of (nb, ow, 128) blocks, counts (nb,) int32), nb =
    ceil(n / (w*128)); counts are UNCAPPED."""
    ow = ow or w
    if not 1 <= len(payloads) <= 2 or len(fills) != len(payloads):
        raise ValueError("one or two payload arrays, one fill each")
    if not on_cuda(col):
        return compact_windows_plain(col, payloads, lo, hi, w, fills, ow)
    dev = col.device
    n = col.numel()
    need(col, "col", (n,), dev)
    for i, a in enumerate(payloads):
        need(a, f"payload {i}", (n,), dev)
    block = w * LANES
    nb = -(-n // block)
    blocks = [torch.empty((nb, ow, LANES), dtype=torch.int32, device=dev)
              for _ in payloads]
    counts = torch.empty((nb,), dtype=torch.int32, device=dev)
    if nb == 0:
        return blocks, counts
    two = len(payloads) == 2
    lib = build.load()
    err = lib.compact_windows(
        ptr(col), ptr(payloads[0]), ptr(payloads[1]) if two else None,
        len(payloads), n, block, lo, hi, fills[0], fills[1] if two else 0,
        ow * LANES, ptr(blocks[0]), ptr(blocks[1]) if two else None,
        ptr(counts), stream(dev))
    build.check(lib, err, "lanecompact compact_windows")
    LAUNCHES["compact_windows"] += 1
    return blocks, counts


def _segments(counts, ow: int, cap_rows: int):
    """The row segments that concatenate the windows' blocks into cap_rows
    rows.  Returns ((soff, doff, rows) int32 (nb,), kept count, overflow),
    the scalars as 0-dim int64 tensors; overflow counts window cuts and
    capacity truncation."""
    nb = counts.numel()
    c = counts.long()
    kept = c.clamp(max=ow * LANES)
    cut = (c - kept).sum()
    rows = -(-kept // LANES)                       # ceil to whole rows
    doff = torch.cumsum(rows, 0) - rows
    ovf = (doff[-1] + rows[-1] - cap_rows).clamp(min=0) + cut
    # clamp the segments to the output buffer; ovf above reports the cut
    rows = torch.minimum(rows, cap_rows - doff).clamp(min=0)
    doff = doff.clamp(max=cap_rows)
    soff = torch.arange(nb, device=counts.device) * ow
    desc = tuple(t.to(torch.int32) for t in (soff, doff, rows))
    return desc, kept.sum(), ovf


def _assemble(blocks, counts, ow: int, cap_rows: int,
              fill_keys: Sequence[int]):
    """Concatenate per-window blocks into cap_rows rows, whole rows at a
    time: key + payload through scatter_segments, a lone array through
    scatter_segments_one.  Returns (arrays (cap_rows*128,) each, kept
    count, overflow)."""
    nb = counts.numel()
    desc, total, ovf = _segments(counts, ow, cap_rows)
    flat = [b.view(nb * ow, LANES) for b in blocks]
    if len(flat) == 2:
        outs = scatter_segments(*flat, *desc, nb, cap_rows + 1,
                                fill_key=fill_keys[0])
    else:
        outs = [scatter_segments_one(flat[0], *desc, nb, cap_rows + 1,
                                     fill_key=fill_keys[0])]
    return [o[:cap_rows].reshape(-1) for o in outs], total, ovf


def compact_kp_fast(key, payload, cap_rows: int, w: int = 512,
                    pad_key: int = PAD_S_INPUT,
                    keep_frac: Optional[float] = None):
    """Compact (key, payload) rows where key < PAD_R_INPUT into cap_rows
    rows.  Returns (key, payload, overflow); empty slots carry pad_key / 0.
    keep_frac scales the per-window buffers; a window that keeps more is
    cut and reported through overflow."""
    ow = out_w_for(w, keep_frac)
    blocks, counts = _compact_windows(key, [key, payload], INT32_MIN + 1,
                                      PAD_R_INPUT - 1, w, (pad_key, 0), ow)
    outs, _, ovf = _assemble(blocks, counts, ow, cap_rows, [pad_key, 0])
    return outs[0], outs[1], ovf


def compact_k_fast(key, cap_rows: int, w: int = 512,
                   pad_key: int = PAD_S_INPUT,
                   keep_frac: Optional[float] = None):
    """Keys-only compact_kp_fast (moves no payload).  Returns (key,
    overflow)."""
    ow = out_w_for(w, keep_frac)
    blocks, counts = _compact_windows(key, [key], INT32_MIN + 1,
                                      PAD_R_INPUT - 1, w, (pad_key,), ow)
    outs, _, ovf = _assemble(blocks, counts, ow, cap_rows, [pad_key])
    return outs[0], ovf
