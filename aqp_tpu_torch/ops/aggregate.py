"""Group-by aggregate and sort operators (counterpart of
aqp_tpu/ops/aggregate.py).

Grouping is sort-based and aggregation is run-boundary prefix-sum
differencing, no hash table:

    sort rows by (key, payload) -> run starts = key changes -> per-run
    aggregates from inclusive prefixes at run ends -> one row per run.

Aggregates: count, sum(payload) mod 2^32, min, max.  Group keys come out
ascending.  This is plain PyTorch on every device: the exact oracle that
the routed aggregate (ops/kernels/aggpipe.py) is held against.  The sum is
an int64 in [0, 2^32) (the reference returns uint32); `num_groups` is a
0-dim int64 tensor.  Each function takes `device` ("cuda" unless the caller
asks for the CPU), where its tensors must lie.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aqp_tpu_torch import check_device

_U32 = 0xFFFFFFFF
INT32_MIN = -(1 << 31)


class GroupByResult(NamedTuple):
    num_groups: torch.Tensor  # 0-dim int64
    key: torch.Tensor         # int32 [capacity], sorted group keys (pad -3)
    count: torch.Tensor       # int32 [capacity], rows per group
    sum: torch.Tensor         # int64 [capacity], payload sum mod 2^32
    min: torch.Tensor         # int32 [capacity]
    max: torch.Tensor         # int32 [capacity]


def _sort_pairs_lex(key, payload):
    """(key, payload) sorted by key, ties by payload (both int32, signed),
    with one sort of a 64-bit composite."""
    comp = (key.long() << 32) + (payload.long() - INT32_MIN)
    comp = torch.sort(comp).values
    return (comp >> 32).to(torch.int32), ((comp & _U32) + INT32_MIN).to(
        torch.int32)


def groupby_aggregate(key, payload, capacity: int,
                      device="cuda") -> GroupByResult:
    """One lexicographic sort does the work: run starts give the groups,
    the payload order within a run gives min (at its start) and max (at its
    end), and one prefix sum gives the per-run sums by differencing.  A
    position scatter (run start -> group rank) and capacity-sized gathers
    compact the groups.  num_groups may exceed capacity; then only the
    first `capacity` groups are returned."""
    check_device(device, key, payload)
    dev = key.device
    n = key.numel()
    if n == 0:
        zero = torch.zeros(capacity, dtype=torch.int32, device=dev)
        return GroupByResult(torch.zeros((), dtype=torch.int64, device=dev),
                             zero - 3, zero, zero.long(), zero, zero)
    sk, sp = _sort_pairs_lex(key, payload)
    prev = torch.cat([sk.new_full((1,), INT32_MIN), sk[:-1]])
    run_start = sk != prev
    num_groups = run_start.sum()
    rank = torch.cumsum(run_start, 0) - 1
    # pos[g] = first row of group g; pos[num_groups..] stays n, so the
    # count / next-start arithmetic of dead slots gives zero
    # (a group past `capacity` still lands its start in pos[capacity],
    # which is exactly group capacity-1's next start)
    sel = run_start & (rank <= capacity)
    pos = torch.full((capacity + 1,), n, dtype=torch.int64, device=dev)
    pos[rank[sel]] = torch.nonzero(sel, as_tuple=True)[0]
    p, pn = pos[:capacity], pos[1:]
    pcl = p.clamp(0, n - 1)
    pe = (pn - 1).clamp(0, n - 1)
    live = torch.arange(capacity, device=dev) < num_groups
    u = sp.long() & _U32
    csum = torch.cumsum(u, 0)
    total = (csum[pe] - csum[pcl] + u[pcl]) & _U32
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return GroupByResult(
        num_groups=num_groups,
        key=torch.where(live, sk[pcl], -3),
        count=torch.where(live, (pn - p).to(torch.int32), zero),
        sum=torch.where(live, total, 0),
        min=torch.where(live, sp[pcl], zero),
        max=torch.where(live, sp[pe], zero),
    )


def radix_sort_pairs(key, payload, device="cuda"):
    """(key, payload) sorted by key ascending, stable (equal keys keep their
    input order; the reference leaves their order unspecified)."""
    check_device(device, key, payload)
    sk, order = torch.sort(key, stable=True)
    return sk, payload[order]
