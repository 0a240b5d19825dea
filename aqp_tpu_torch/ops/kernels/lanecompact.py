"""Windowed stable compaction (counterpart of
aqp_tpu/ops/pallas/lanecompact.py).

`compact_kp_fast` / `compact_k_fast` compact the (key, payload) rows, or the
keys, whose key is below PAD_R_INPUT into a buffer of `cap_rows` 128-wide
rows (the compacted-residual skew tier and the routed aggregate);
`scan_index_fast` / `scan_values_fast` / `scan_dict_fast` compact the row
ids, with the values or their dictionary decode, of the rows of a uint8 or
int32 column within a range (the write-producing scan modes).  All take
two steps:

  _compact_windows  per window of w*128 elements, keep the elements with
                    lo <= x <= hi in order and write the first ow*128 of
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
launches, by form: the join's int32 form and the three scan modes.
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
LAUNCHES = {"compact_windows": 0, "compact_windows_index": 0,
            "compact_windows_values": 0, "compact_windows_dict": 0}

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


# What an output of the window kernel holds (csrc/lanecompact.cu OutKind).
OUT_ARRAY, OUT_ROW_ID, OUT_VALUE, OUT_DICT_LO, OUT_DICT_HI = range(5)


def _dict_entry(x: torch.Tensor) -> torch.Tensor:
    """The reference's _decode256 index of a code: the high plane half for
    codes >= 128, the code's low 7 bits within it."""
    return torch.where(x >= LANES, LANES, 0) + (x & (LANES - 1))


def _outputs(payloads, fills, with_ids, with_values, dict_tables):
    """(kind, payload array or None, fill) of each output, in output
    order: row ids, payloads, the column's values, the dictionary's two
    planes (whose fill is their entry 0, read where the table lies)."""
    outs = [(OUT_ROW_ID, None, PAD_S_INPUT)] if with_ids else []
    outs += [(OUT_ARRAY, a, f) for a, f in zip(payloads, fills)]
    if with_values:
        outs.append((OUT_VALUE, None, fills[-1]))
    if dict_tables is not None:
        outs += [(OUT_DICT_LO, None, 0), (OUT_DICT_HI, None, 0)]
    return outs


def compact_windows_plain(col, payloads, lo: int, hi: int, w: int,
                          fills: Sequence[int], ow: int,
                          with_ids: bool = False, with_values: bool = False,
                          dict_tables=None):
    """_compact_windows in plain PyTorch (see there)."""
    n = col.numel()
    block = w * LANES
    nb = -(-n // block)
    cap = ow * LANES
    dev = col.device
    pad = nb * block - n
    idx = torch.arange(nb * block, device=dev)
    x = torch.cat([col.to(torch.int32), col.new_full((pad,), INT32_MIN,
                                                     dtype=torch.int32)])
    keep = ((x >= lo) & (x <= hi) & (idx < n)).view(nb, block)
    counts = keep.sum(1).to(torch.int32)
    rank = torch.cumsum(keep, 1) - 1
    sel = keep & (rank < cap)
    win = torch.arange(nb, device=dev)[:, None].expand(nb, block)[sel]
    dst = win * cap + rank[sel]
    blocks = []
    for kind, a, fill in _outputs(payloads, fills, with_ids, with_values,
                                  dict_tables):
        out = torch.full((nb * cap,), fill, dtype=torch.int32, device=dev)
        if kind == OUT_ROW_ID:
            src = idx
        elif kind == OUT_ARRAY:
            src = torch.cat([a, a.new_zeros(pad)])
        elif kind == OUT_VALUE:
            src = x
        else:
            table = dict_tables[kind - OUT_DICT_LO]
            src = table[_dict_entry(x).long()]
            out.fill_(table[0])
        out[dst] = src.view(nb, block)[sel].to(torch.int32)
        blocks.append(out.view(nb, ow, LANES))
    return blocks, counts


def _form(with_ids: bool, with_values: bool, dict_tables) -> str:
    """The LAUNCHES key of a call: the join's int32 form, or a scan mode."""
    if not with_ids:
        return "compact_windows"
    if dict_tables is not None:
        return "compact_windows_dict"
    return "compact_windows_values" if with_values else \
        "compact_windows_index"


def _compact_windows(col, payloads, lo: int, hi: int, w: int,
                     fills: Sequence[int], ow: int = 0,
                     with_ids: bool = False, with_values: bool = False,
                     dict_tables=None):
    """Compact every window of w*128 elements of `col` (int32, or uint8
    read as bytes; any contiguous 1-d column, a view that starts off a
    16-byte boundary included, read where it lies) by lo <= x <= hi.

    The outputs, in order: the kept elements' global row ids (with_ids;
    fill PAD_S_INPUT), zero to two int32 payload arrays of col's length
    moved through the compaction (the join's callers pass the key column
    itself as the first), the column's own values (with_values), and the
    column decoded through a dictionary of two 256-entry int32 planes
    (dict_tables = (lo, hi); fill: each plane's entry 0, as the reference
    decodes its code fill); one to three in all.  fills: per payload array
    and the values, the value of the block's slots past its count.
    Returns (list of (nb, ow, 128) blocks, counts (nb,) int32), nb =
    ceil(n / (w*128)); counts are UNCAPPED."""
    ow = ow or w
    outputs = _outputs(payloads, fills, with_ids, with_values, dict_tables)
    nout = len(outputs)
    if (len(payloads) > 2 or not 1 <= nout <= 3
            or len(fills) != len(payloads) + int(with_values)):
        raise ValueError("need one or two payload arrays, or row ids and at "
                         "most two more outputs (the values, a dictionary's "
                         "planes), and one fill per payload array or values")
    if with_ids and col.numel() >= PAD_R_INPUT:
        raise ValueError(f"row ids are int32 below {PAD_R_INPUT}; the "
                         f"column has {col.numel()} rows")
    if not on_cuda(col):
        return compact_windows_plain(col, payloads, lo, hi, w, fills, ow,
                                     with_ids, with_values, dict_tables)
    dev = col.device
    n = col.numel()
    if col.dtype not in (torch.int32, torch.uint8):
        raise TypeError(f"col must be int32 or uint8, got {col.dtype}")
    if not col.is_contiguous() or col.dim() != 1:
        raise ValueError("col must be a contiguous 1-d tensor")
    for i, a in enumerate(payloads):
        need(a, f"payload {i}", (n,), dev)
    tables = list(dict_tables) if dict_tables is not None else [None, None]
    for t, what in zip(tables, ("dict_lo", "dict_hi")):
        need(t, what, (256,), dev)
    block = w * LANES
    nb = -(-n // block)
    blocks = [torch.empty((nb, ow, LANES), dtype=torch.int32, device=dev)
              for _ in range(nout)]
    counts = torch.empty((nb,), dtype=torch.int32, device=dev)
    if nb == 0:
        return blocks, counts
    # the kernel takes three outputs; the unused ones are never read
    kinds, srcs, fl = zip(*outputs, *[(OUT_ARRAY, None, 0)] * (3 - nout))
    outs = blocks + [None] * (3 - nout)
    lib = build.load()
    err = lib.compact_windows(
        ptr(col), int(col.dtype == torch.uint8), n, block, lo, hi,
        ow * LANES, nout, *kinds, *map(ptr, srcs), *fl, *map(ptr, outs),
        ptr(tables[0]), ptr(tables[1]), ptr(counts), stream(dev))
    build.check(lib, err, "lanecompact compact_windows")
    LAUNCHES[_form(with_ids, with_values, dict_tables)] += 1
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
    time: the arrays in pairs through scatter_segments, a last lone array
    through scatter_segments_one (the reference's pairing,
    lanecompact.py:365-380); fill_keys[i] fills array i's uncovered rows
    where it leads its pair or stands alone (a pair's second array is
    filled with 0).  Returns (arrays (cap_rows*128,) each, kept count,
    overflow)."""
    nb = counts.numel()
    desc, total, ovf = _segments(counts, ow, cap_rows)
    flat = [b.view(nb * ow, LANES) for b in blocks]
    outs = []
    for i in range(0, len(flat), 2):
        if i + 1 < len(flat):
            outs += scatter_segments(flat[i], flat[i + 1], *desc, nb,
                                     cap_rows + 1, fill_key=fill_keys[i])
        else:
            outs.append(scatter_segments_one(flat[i], *desc, nb,
                                             cap_rows + 1,
                                             fill_key=fill_keys[i]))
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


HINT_LADDER = (0.02, 0.1, 0.3, 0.6, 1.0)


def hint_ladder(sel: Optional[float]) -> Optional[float]:
    """Quantize a selectivity hint to a small ladder (the reference keys its
    jit cache on it; here it fixes the same window buffers)."""
    if sel is None:
        return None
    for f in HINT_LADDER:
        if sel <= f:
            return f
    return 1.0


def _scan_column(col):
    """A uint8 column stays bytes; any other dtype is widened to int32."""
    return col if col.dtype in (torch.uint8, torch.int32) else \
        col.to(torch.int32)


def scan_index_fast(col, low, high, cap_rows: int, w: int = 512,
                    sel_hint: Optional[float] = None):
    """Implicit index scan through the window compactor.

    Returns (rowids[cap_rows*128], count, overflow); pad slots carry
    PAD_S_INPUT, only in block-boundary rows.  sel_hint (0..1) scales the
    per-window output buffers; a hint too low for the data is REPORTED as
    overflow (callers rerun with sel_hint=None)."""
    ow = out_w_for(w, sel_hint)
    blocks, counts = _compact_windows(_scan_column(col), [], int(low),
                                      int(high), w, (), ow, with_ids=True)
    outs, total, ovf = _assemble(blocks, counts, ow, cap_rows,
                                 [PAD_S_INPUT])
    return outs[0], total, ovf


def scan_values_fast(col, low, high, cap_rows: int, w: int = 512,
                     sel_hint: Optional[float] = None):
    """Value scan through the window compactor.  Returns (rowids, values,
    count, overflow); the values are the column's, widened to int32."""
    ow = out_w_for(w, sel_hint)
    blocks, counts = _compact_windows(_scan_column(col), [], int(low),
                                      int(high), w, (0,), ow, with_ids=True,
                                      with_values=True)
    outs, total, ovf = _assemble(blocks, counts, ow, cap_rows,
                                 [PAD_S_INPUT, 0])
    return outs[0], outs[1], total, ovf


def scan_dict_fast(col, dict_lo, dict_hi, low, high, cap_rows: int,
                   w: int = 512, sel_hint: Optional[float] = None):
    """Dict scan through the window compactor: the qualifying codes are
    decoded in the kernel through a 256-entry dictionary of two int32
    planes; the codes themselves are not output.  Returns (rowids,
    lo_plane, hi_plane, count, overflow)."""
    tables = tuple(t.to(torch.int32).reshape(256).contiguous()
                   for t in (dict_lo, dict_hi))
    ow = out_w_for(w, sel_hint)
    blocks, counts = _compact_windows(_scan_column(col), [], int(low),
                                      int(high), w, (), ow, with_ids=True,
                                      dict_tables=tables)
    outs, total, ovf = _assemble(blocks, counts, ow, cap_rows,
                                 [PAD_S_INPUT, 0, 0])
    return outs[0], outs[1], outs[2], total, ovf
