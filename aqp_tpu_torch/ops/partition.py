"""Radix partitioning primitives (counterpart of aqp_tpu/ops/partition.py).

The reference's radix partition (radix_join.cpp:614-931) is a per-thread
histogram, local prefix sums, global write cursors and a scatter.  Here:

    radix_histogram   per-bucket counts (the "hist" phase)
    partition_offsets global exclusive prefix (the "global cursor" phase)
    radix_partition   stable reorder by bucket (the "scatter" phase)

The reorder is a stable torch.sort on the bucket id; the block sort with
bucket starts (ops/kernels/compact.sort_hist) and the segment scatter are
the kernel form of the same two phases.
"""

from __future__ import annotations

import torch

from aqp_tpu_torch.ops.hashing import radix_bits


def radix_histogram(bucket: torch.Tensor, bits: int) -> torch.Tensor:
    """Counts of the buckets in [0, 2^bits), int32; other values are not
    counted."""
    fanout = 1 << bits
    b = bucket.long()
    b = b[(b >= 0) & (b < fanout)]
    return torch.bincount(b, minlength=fanout).to(torch.int32)


def partition_offsets(hist: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix over bucket counts: the global scatter cursors
    (radix_join.cpp:886-915)."""
    return torch.cumsum(hist, 0, dtype=hist.dtype) - hist


def stable_partition(bucket: torch.Tensor, *cols: torch.Tensor):
    """The columns reordered by bucket, stably."""
    order = torch.sort(bucket, stable=True).indices
    return tuple(c[order] for c in cols)


def radix_partition(key: torch.Tensor, payload: torch.Tensor, shift: int,
                    bits: int):
    """Stable reorder by radix bucket; returns (key, payload, hist)."""
    bucket = radix_bits(key, shift, bits)
    k, p = stable_partition(bucket, key, payload)
    return k, p, radix_histogram(bucket, bits)
