"""Exact sort-based equi-join core (counterpart of aqp_tpu/ops/mergejoin.py).

    1. sort concat(R, S) by key, R rows before S rows of an equal key;
    2. propagate the last R (key, payload) forward;
    3. an S row matches iff the propagated key equals its own.

For unique R keys this is the exact join.  The `_general` variants count
every (R, S) pair, for any R multiplicity.  This is the oracle and the last
rung of RHO's ladder, on every device, for counts and (through
`merge_join_materialize`) for materialized output.

A key sorts raw, in its own dtype, in one stable sort of concat(R, S): R's
rows come first, so they stay before S's rows of an equal key, and every
int32 and int64 key is exact (the reference sorts key<<1 | tag, which
needs |key| < 2^30 in int32 and wraps for |key| >= 2^62 in int64).  Only
under a major order (NPBC_st's buckets, the cracking windows) do int32
keys pack (major, key, tag) into one int64, which saves a second sort.
Sums run in int64: the checksum is summed exactly and masked to 32 bits.
Results are 0-dim int64 tensors; the checksum lies in [0, 2^32).
Materialized columns keep the inputs' dtypes.
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
    key: torch.Tensor       # the R key's dtype (capacity,); holes keyed -3
    r_payload: torch.Tensor
    s_payload: torch.Tensor


def sorted_union(r_key: torch.Tensor, s_key: torch.Tensor, major=None):
    """concat(R, S) in join order: by `major` (int64 per row of the union,
    in [0, 2^30); None for none), then key, R before S of an equal key,
    stably.  Returns (key, is_r, order into concat(R, S)); the key keeps
    the keys' dtype (int64 under `major`)."""
    if major is None or torch.int64 in (r_key.dtype, s_key.dtype):
        key, order = torch.sort(torch.cat([r_key, s_key]), stable=True)
        if major is not None:
            perm = torch.sort(major[order], stable=True).indices
            key, order = key[perm], order[perm]
        return key, order < r_key.numel(), order
    # int32 keys under `major`: (major, key + 2^31, tag) packed in one
    # int64, so one sort orders all three
    pk = torch.cat([r_key.long() << 1, (s_key.long() << 1) | 1])
    pk, order = torch.sort((major << 33) | (pk + (1 << 32)), stable=True)
    return ((pk >> 1) & _U32) - (1 << 31), (pk & 1) == 0, order


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


def _matches(key: torch.Tensor, is_r: torch.Tensor, pay: torch.Tensor):
    """On a union in join order: per position, whether it is an S row that
    matches, and the propagated R payload."""
    prop_key, prop_pay, seen = _propagate(is_r, key, pay)
    return ~is_r & seen & (prop_key == key), prop_pay


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.long() & _U32


def _sorted_rows(r_key, r_payload, s_key, s_payload):
    """(key, is_r, payload) of the union in join order."""
    key, is_r, order = sorted_union(r_key, s_key)
    return key, is_r, torch.cat([r_payload.long(), s_payload.long()])[order]


def merge_join_count(r_key, r_payload, s_key, s_payload) -> JoinCounts:
    """Exact match count + mod-2^32 checksum, unique R keys."""
    key, is_r, pay = _sorted_rows(r_key, r_payload, s_key, s_payload)
    match, prop_pay = _matches(key, is_r, pay)
    ck = torch.where(match, (_u32(prop_pay) + _u32(pay)) & _U32, 0)
    return JoinCounts(match.sum(), ck.sum() & _U32)


def compact_matches(hit, key, r_payload, s_payload, capacity: int,
                    dtypes=None) -> JoinMaterialized:
    """Compact the rows where `hit` into a fixed-capacity materialized
    result: live rows first, in their order (a stable sort by !hit), cut or
    zero-padded to `capacity`; past them key -3 and payloads 0 (-3 is never
    a real key, so the output can feed a further join).  The columns keep
    their dtypes, or take `dtypes` (key, R payload, S payload) where the
    caller computed them wider.  Dense consumers use it on region-chunked
    output."""
    matches = hit.sum()
    ck = torch.where(hit, (_u32(r_payload) + _u32(s_payload)) & _U32, 0)
    order = torch.argsort((~hit).to(torch.int8), stable=True)
    cols = (key, r_payload, s_payload)
    dtypes = dtypes or [c.dtype for c in cols]
    cols = [c[order].to(dt)[:capacity] for c, dt in zip(cols, dtypes)]
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
    key, is_r, pay = _sorted_rows(r_key, r_payload, s_key, s_payload)
    match, prop_pay = _matches(key, is_r, pay)
    return compact_matches(match, key, prop_pay, pay, capacity,
                           (r_key.dtype, r_payload.dtype, s_payload.dtype))


def merge_join_count_keys(r_key, s_key) -> JoinCounts:
    """Matches-only count (no payloads move); checksum 0.  Unique R keys."""
    key, is_r, _ = sorted_union(r_key, s_key)
    match, _ = _matches(key, is_r, key)
    return JoinCounts(match.sum(), torch.zeros((), dtype=torch.int64,
                                               device=key.device))


def _run_base(key: torch.Tensor, is_r: torch.Tensor):
    """Per position: the R indicator, the inclusive R count, and whether a
    key run starts there."""
    r_ind = is_r.long()
    r_pref = torch.cumsum(r_ind, 0)
    prev = torch.cat([key.new_full((1,), -1), key[:-1]])
    run_start = key != prev
    return r_ind, r_pref, run_start


def _at_run_start(run_start: torch.Tensor, base: torch.Tensor):
    """`base` as it was at the start of each position's run (0 where no run
    start precedes, as the reference's scan leaves it)."""
    last = last_index(run_start)
    return torch.where(last >= 0, base[last.clamp(min=0)],
                       torch.zeros_like(base))


def count_general_runs(key: torch.Tensor, is_r: torch.Tensor,
                       pay: torch.Tensor) -> JoinCounts:
    """Run-count scan of the duplicate-exact core on a union in join order
    (equal keys contiguous, R rows first), `pay` its aligned payloads."""
    r_ind, r_pref, run_start = _run_base(key, is_r)
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
    return count_general_runs(*_sorted_rows(r_key, r_payload, s_key,
                                            s_payload))


def merge_join_count_general_keys(r_key, s_key) -> JoinCounts:
    """Matches-only duplicate-tolerant count; checksum 0."""
    key, is_r, _ = sorted_union(r_key, s_key)
    r_ind, r_pref, run_start = _run_base(key, is_r)
    run_cnt0 = _at_run_start(run_start,
                             torch.where(run_start, r_pref - r_ind, 0))
    mult = torch.where(~is_r, r_pref - run_cnt0, 0)
    return JoinCounts(mult.sum(), torch.zeros((), dtype=torch.int64,
                                              device=key.device))
