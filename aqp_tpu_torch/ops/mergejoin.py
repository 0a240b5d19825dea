"""Exact sort-based equi-join core (counterpart of aqp_tpu/ops/mergejoin.py).

    1. sort concat(R, S) by key<<1 | tag, R rows tagged 0 so they sort
       before S rows of an equal key;
    2. propagate the last R (key, payload) forward;
    3. an S row matches iff the propagated key equals its own.

For unique R keys this is the exact join.  The `_general` variants count
every (R, S) pair, for any R multiplicity.  This is the oracle and the last
rung of RHO's ladder, on every device, for counts and (through
`merge_join_materialize`) for materialized output.

Packing and sums run in int64: a key may be any int32 (the reference packs
in int32 and needs |key| < 2^30), and the checksum is summed exactly and
masked to 32 bits.  Results are 0-dim int64 tensors; the checksum lies in
[0, 2^32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_U32 = 0xFFFFFFFF


class JoinCounts(NamedTuple):
    matches: torch.Tensor   # 0-dim int64
    checksum: torch.Tensor  # 0-dim int64 in [0, 2^32)


class JoinMaterialized(NamedTuple):
    matches: torch.Tensor   # 0-dim int64
    checksum: torch.Tensor  # 0-dim int64 in [0, 2^32)
    key: torch.Tensor       # int32 (capacity,); holes keyed -3
    r_payload: torch.Tensor
    s_payload: torch.Tensor


def _packed(r_key: torch.Tensor, s_key: torch.Tensor) -> torch.Tensor:
    return torch.cat([r_key.long() << 1, (s_key.long() << 1) | 1])


def last_index(valid: torch.Tensor) -> torch.Tensor:
    """Index of the last valid position at or before each position, -1
    where there is none.  A running count and a scatter, not torch.cummax,
    which scans a 1-D CUDA tensor in a single thread block."""
    cnt = torch.cumsum(valid, 0)
    idx = torch.arange(valid.numel(), device=valid.device)
    # slot c: the index of the c-th valid position (invalid positions all
    # write slot 0, which is never read)
    nth = torch.zeros(valid.numel() + 1, dtype=torch.int64,
                      device=valid.device)
    nth.scatter_(0, torch.where(valid, cnt, 0), idx)
    return torch.where(cnt > 0, nth[cnt], -1)


def _propagate(is_r: torch.Tensor, key: torch.Tensor, pay: torch.Tensor):
    """The last R row's (key, payload) at or before each position, and
    whether any R row is there at all.  The reference marks "no R row yet"
    with the key -1, which an S key of -1 then matches; the mask does not.
    Where no R row precedes, key and payload are those of position 0 and
    must not be read."""
    last = last_index(is_r)
    at = last.clamp(min=0)
    return key[at], pay[at], last >= 0


def _matches(pk: torch.Tensor, pay: torch.Tensor):
    """On a sorted packed union: per position, the S rows that match, the
    key, and the propagated R payload."""
    is_r = (pk & 1) == 0
    key = pk >> 1
    prop_key, prop_pay, seen = _propagate(is_r, key, pay)
    return ~is_r & seen & (prop_key == key), key, prop_pay


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.long() & _U32


def _sorted_union(r_key, r_payload, s_key, s_payload):
    pk, order = torch.sort(_packed(r_key, s_key), stable=True)
    pay = torch.cat([r_payload.long(), s_payload.long()])[order]
    return pk, pay


def merge_join_count(r_key, r_payload, s_key, s_payload) -> JoinCounts:
    """Exact match count + mod-2^32 checksum, unique R keys."""
    pk, pay = _sorted_union(r_key, r_payload, s_key, s_payload)
    match, _, prop_pay = _matches(pk, pay)
    ck = torch.where(match, (_u32(prop_pay) + _u32(pay)) & _U32, 0)
    return JoinCounts(match.sum(), ck.sum() & _U32)


def compact_matches(hit, key, r_payload, s_payload, capacity: int
                    ) -> JoinMaterialized:
    """Compact the rows where `hit` into a fixed-capacity materialized
    result: live rows first, in their order (a stable sort by !hit), cut or
    zero-padded to `capacity`; past them key -3 and payloads 0 (-3 is never
    a real key, so the output can feed a further join).  Dense consumers
    use it on region-chunked output."""
    matches = hit.sum()
    ck = torch.where(hit, (_u32(r_payload) + _u32(s_payload)) & _U32, 0)
    order = torch.argsort((~hit).to(torch.int8), stable=True)
    cols = [c[order].to(torch.int32)[:capacity]
            for c in (key, r_payload, s_payload)]
    pad = capacity - cols[0].numel()
    if pad > 0:
        cols = [torch.cat([c, c.new_zeros(pad)]) for c in cols]
    live = torch.arange(capacity, device=hit.device) < matches
    out_k = torch.where(live, cols[0], -3)
    out_rp = torch.where(live, cols[1], 0)
    out_sp = torch.where(live, cols[2], 0)
    return JoinMaterialized(matches, ck.sum() & _U32, out_k, out_rp, out_sp)


def merge_join_materialize(r_key, r_payload, s_key, s_payload,
                           capacity: int) -> JoinMaterialized:
    """Materialized join output (key, r_payload, s_payload) in the
    compact_matches layout.  Unique R keys."""
    pk, pay = _sorted_union(r_key, r_payload, s_key, s_payload)
    match, key, prop_pay = _matches(pk, pay)
    return compact_matches(match, key, prop_pay, pay, capacity)


def merge_join_count_keys(r_key, s_key) -> JoinCounts:
    """Matches-only count (no payloads move); checksum 0.  Unique R keys."""
    pk = torch.sort(_packed(r_key, s_key)).values
    match, _, _ = _matches(pk, pk)
    return JoinCounts(match.sum(), torch.zeros((), dtype=torch.int64,
                                               device=pk.device))


def _run_base(pk: torch.Tensor):
    """Per position: is_r, the inclusive R count, and the R count before the
    position's key run."""
    key = pk >> 1
    is_r = (pk & 1) == 0
    r_ind = is_r.long()
    r_pref = torch.cumsum(r_ind, 0)
    prev = torch.cat([key.new_full((1,), -1), key[:-1]])
    run_start = key != prev
    return is_r, r_ind, r_pref, run_start


def _at_run_start(run_start: torch.Tensor, base: torch.Tensor):
    """`base` as it was at the start of each position's run (0 where no run
    start precedes, as the reference's scan leaves it)."""
    last = last_index(run_start)
    return torch.where(last >= 0, base[last.clamp(min=0)],
                       torch.zeros_like(base))


def count_general_scan(pk: torch.Tensor, pay: torch.Tensor) -> JoinCounts:
    """Run-count scan of the duplicate-exact core on a sorted packed union
    (pk = key<<1 | tag ascending, pay aligned payloads)."""
    is_r, r_ind, r_pref, run_start = _run_base(pk)
    rpay = torch.where(is_r, _u32(pay), 0)
    rpay_pref = torch.cumsum(rpay, 0)
    run_cnt0 = _at_run_start(run_start,
                             torch.where(run_start, r_pref - r_ind, 0))
    run_pay0 = _at_run_start(run_start,
                             torch.where(run_start, rpay_pref - rpay, 0))
    mult = torch.where(~is_r, r_pref - run_cnt0, 0)
    rpay_sum = torch.where(~is_r, rpay_pref - run_pay0, 0)
    ck = (rpay_sum + mult * _u32(pay)) & _U32
    return JoinCounts(mult.sum(), ck.sum() & _U32)


def merge_join_count_general(r_key, r_payload, s_key, s_payload
                             ) -> JoinCounts:
    """Duplicate-tolerant count: matches = sum over S of #R rows with its
    key; checksum = sum over pairs of r_pay + s_pay, mod 2^32."""
    pk, pay = _sorted_union(r_key, r_payload, s_key, s_payload)
    return count_general_scan(pk, pay)


def merge_join_count_general_keys(r_key, s_key) -> JoinCounts:
    """Matches-only duplicate-tolerant count; checksum 0."""
    pk = torch.sort(_packed(r_key, s_key)).values
    is_r, r_ind, r_pref, run_start = _run_base(pk)
    run_cnt0 = _at_run_start(run_start,
                             torch.where(run_start, r_pref - r_ind, 0))
    mult = torch.where(~is_r, r_pref - run_cnt0, 0)
    return JoinCounts(mult.sum(), torch.zeros((), dtype=torch.int64,
                                              device=pk.device))
