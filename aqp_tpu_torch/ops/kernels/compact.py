"""Segment scatter (counterpart of aqp_tpu/ops/pallas/compact.py, the part the
compacted-residual tier rides on).

`scatter_segments` copies `nseg` row segments of a (rows, 128) key array and
its payload array to destination row offsets of an output pre-filled with
`fill_key` (and 0 for the payload); `scatter_segments_one` does the same for
one array.  Segment i copies source rows [soff_i, soff_i + sz_i) to output
rows [doff_i, doff_i + sz_i); segments must not overlap in the output.  The
output has `out_rows` rows and, as in the reference, callers keep only the
first out_rows - 1 (the reference's last row is the trash row its DMA ring
aims empty segments at; the port writes nothing there).

Each has a plain PyTorch version (`scatter_segments_plain`, the gather
formulation of the reference's `_scatter_reference`) and a wrapper that
sends a CPU tensor to it and a CUDA tensor to the hand-written kernel in
csrc/compact.cu; there is no fallback from one to the other.  `LAUNCHES`
counts the kernel launches.
"""

from __future__ import annotations

import torch

from aqp_tpu_torch.ops.kernels import build
from aqp_tpu_torch.ops.kernels.build import need, on_cuda, ptr, stream
from aqp_tpu_torch.ops.kernels.rho3 import (KEY_PAD_INT, LANES, PAD_R_INPUT,
                                            PAD_S_INPUT)

__all__ = ["KEY_PAD_INT", "PAD_R_INPUT", "PAD_S_INPUT", "LAUNCHES",
           "scatter_segments", "scatter_segments_one",
           "scatter_segments_plain"]

# Launches of each hand-written kernel in this process (the plain version
# does not count).  Reset by assigning 0.
LAUNCHES = {"scatter_segments": 0, "scatter_segments_one": 0}


def scatter_segments_plain(arrays, soff, doff, sz, out_rows: int,
                           fill_key: int = KEY_PAD_INT):
    """The segment copy as a gather: output row j covered by segment i
    (doff_i <= j < doff_i + sz_i) reads source row soff_i + (j - doff_i),
    clamped to the source; other rows hold fill_key (array 0) or 0.
    Segments with sz <= 0, or starting outside [0, out_rows), are dropped.
    Returns one (out_rows, 128) array per input array."""
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
    outs = [torch.full((out_rows, LANES), fill_key, dtype=torch.int32,
                       device=dev)]
    if len(arrays) == 2:
        outs.append(torch.zeros((out_rows, LANES), dtype=torch.int32,
                                device=dev))
    for t in (*arrays, *outs):
        if t.data_ptr() % 16:
            raise ValueError("the segment scatter needs 16-byte aligned rows")
    lib = build.load()
    err = lib.scatter_segments(
        ptr(arrays[0]), ptr(arrays[1]) if len(arrays) == 2 else None,
        ptr(soff), ptr(doff), ptr(sz), nseg, rows, out_rows,
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
