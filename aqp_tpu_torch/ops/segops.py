"""Prefix-sum, histogram and compaction helpers shared across operators
(counterpart of aqp_tpu/ops/segops.py).

The reference's per-thread histograms and global prefix sums for scatter
offsets (radix_join.cpp:886-931) become cumsum and bincount over device
tensors; its vcompressstoreu compaction (SIMD512.cpp) becomes a stable
selection of the masked rows into a fixed-capacity buffer.
"""

from __future__ import annotations

import torch


def exclusive_cumsum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Running sum before each position, in x's integer type (int32 for a
    bool mask, as the reference's)."""
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return torch.cumsum(x, dim=axis, dtype=x.dtype) - x


def histogram(bucket: torch.Tensor, fanout: int) -> torch.Tensor:
    """Per-bucket counts (int32, fanout,).  As the reference's bincount,
    a negative bucket counts in bucket 0 and one >= fanout is dropped."""
    counts = torch.bincount(bucket.long().clamp(min=0), minlength=fanout)
    return counts[:fanout].to(torch.int32)


def compact_many(mask: torch.Tensor, arrays, capacity: int, fill=0):
    """Stable compaction of several parallel arrays with one shared mask:
    the rows where mask holds, in order, cut to `capacity`, the rest
    `fill`.  Returns (tuple of (capacity,) arrays, count of mask)."""
    idx = torch.nonzero(mask).flatten()[:capacity]
    outs = []
    for a in arrays:
        out = torch.full((capacity,), fill, dtype=a.dtype, device=a.device)
        out[:idx.numel()] = a[idx]
        outs.append(out)
    return tuple(outs), mask.sum()


def compact(mask: torch.Tensor, values: torch.Tensor, capacity: int,
            fill=0):
    """compact_many for one array.  Returns (out (capacity,), count)."""
    (out,), count = compact_many(mask, (values,), capacity, fill)
    return out, count
