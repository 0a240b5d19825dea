"""Cracking joins: CRKJ, CrkJoin, CRKJF and CRKJS, with the persistent
`CrackedRelation` (counterpart of aqp_tpu/joins/crk.py).

The reference (CrkJoin/JoinWrapper.cpp:177-522, CrkJoin/Join.hpp) cracks
both relations query by query into a partition tree on the keys' top bits,
keeps the tree, and joins partition by partition.  Here:

  * one crack level is a stable sort of the whole relation by the
    top-`depth` bucket id (phase "partition"); every pending level runs
    as one sort, or one sort a level with profile_phases;
  * a `CrackedRelation` carries the cracked layout, its depth and the
    tree's spans (`bounds`, 2^depth + 1 offsets), and persists across
    queries: `crack_to` on a store already at the depth asked returns the
    same object, so a second join on it cracks nothing;
  * the serving path feeds the cracked layout to the exact merge core
    (phase "join"): buckets are key prefixes, so partition-major order is
    key order and the per-partition joins are one merge;
  * profile_phases joins window by window (phase "join"): every row's
    window comes from the tree spans, and one sort of the union by
    (window, key, side) joins every window at once with the 1-D core
    (mergejoin.sorted_union: packed in one int64 for int32 keys, two
    stable sorts for int64 keys).
    Materialized, window p's live rows fill positions [p * cap_s, ...) of
    the output, cap_s the largest S span rounded up to a power of two,
    and holes (key -3) the rest, as the reference's windows do;
  * the depth is ceil(log2(|R| / partition_rows)) (JoinConfig), less one
    for CRKJF (the last level fused into the join) and two for CRKJS (the
    threshold DFS stops early); CRKJ and CrkJoin are the same engine.

Deliberate difference: a bucket id is clamped to [0, 2^depth - 1], in the
crack sort and the spans alike.  Keys inside [0, 2^key_bits) get the
reference's buckets, layout and spans; a key outside (negative, or at or
above 2^key_bits when S holds keys R's size does not cover) joins in the
first or the last partition.  The reference leaves such rows outside every
window, so its windowed form drops their matches.  Int32 and int64 keys;
an int64 key is compared whole (sparse keys above 2^32 all fall in the
last partition).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Optional

import torch

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.joins.api import register
# module imports: joins.api imports this module while they may still be
# loading
from aqp_tpu_torch.joins import radix
from aqp_tpu_torch.joins.common import (hit_counts, result_capacity,
                                        to_join_result)
from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.relation import Relation
from aqp_tpu_torch.utils.timing import PhaseTimer

# The windowed join packs (window << 33 | (key + 2^31) << 1 | side) into an
# int64 for int32 keys (mergejoin.sorted_union), so a window id must stay
# below 2^30.
MAX_WINDOW_DEPTH = 30


def _bucket(key: torch.Tensor, depth: int, key_bits: int) -> torch.Tensor:
    """The top-`depth` bits of each key in a `key_bits`-bit domain,
    clamped to [0, 2^depth - 1] (int32)."""
    return (key.long() >> (key_bits - depth)).clamp_(
        0, (1 << depth) - 1).to(torch.int32)


def _crack_level(key, payload, depth: int, key_bits: int):
    """Cracking down to `depth`: a stable sort by the bucket id.  With the
    rows already grouped by a shallower bucket (a prefix of this one),
    that grouping is kept and each group splits further."""
    order = torch.sort(_bucket(key, depth, key_bits), stable=True).indices
    return key[order], payload[order]


def _tree_bounds(key, depth: int, key_bits: int) -> torch.Tensor:
    """The spans of the partition tree at `depth`: offsets[2^depth + 1],
    partition p holding rows [offsets[p], offsets[p + 1]) (the reference's
    PTreeNode start and size).  The rows must be cracked to `depth`."""
    npart = 1 << depth
    return torch.searchsorted(
        _bucket(key, depth, key_bits),
        torch.arange(npart + 1, dtype=torch.int32, device=key.device))


@dataclass(frozen=True)
class CrackedRelation:
    """A relation with its persistent cracking state (the partition tree).
    Joins on the same store reuse the levels already cracked."""

    key: torch.Tensor
    payload: torch.Tensor
    depth: int            # crack levels applied (most significant first)
    key_bits: int         # bits of the key domain
    bounds: torch.Tensor  # [2^depth + 1] partition offsets at `depth`

    @property
    def num_tuples(self) -> int:
        return self.key.shape[0]


def _key_bits(n: int) -> int:
    """ceil(log2(max(2, n))) + 1: dense generated keys are 1..n
    (generator.cpp:351-376)."""
    return (max(2, n) - 1).bit_length() + 1


def crack_relation(rel: Relation, key_bits: Optional[int] = None
                   ) -> CrackedRelation:
    """A relation as an uncracked store (depth 0, one root partition)."""
    n = rel.num_tuples
    if key_bits is None:
        key_bits = _key_bits(n)
    bounds = torch.tensor([0, n], dtype=torch.int64, device=rel.key.device)
    return CrackedRelation(rel.key, rel.payload, 0, key_bits, bounds)


def crack_to(cr: CrackedRelation, depth: int,
             pt: Optional[PhaseTimer] = None,
             per_level: bool = False) -> CrackedRelation:
    """The store refined to `depth` levels (at most key_bits).  Levels
    already cracked are not repeated: a store at `depth` or deeper comes
    back as the same object.  The pending levels run as one stable sort,
    or with per_level as one sort a level (each timed as "partition")."""
    depth = min(depth, cr.key_bits)
    if depth <= cr.depth:
        return cr
    key, pay = cr.key, cr.payload
    levels = range(cr.depth + 1, depth + 1) if per_level else (depth,)
    for d in levels:
        if pt is not None:
            key, pay = pt.time_fn("partition", _crack_level, key, pay, d,
                                  cr.key_bits)
        else:
            key, pay = _crack_level(key, pay, d, cr.key_bits)
    bounds = _tree_bounds(key, depth, cr.key_bits)
    return replace(cr, key=key, payload=pay, depth=depth, bounds=bounds)


def _window_ids(bounds: torch.Tensor, n: int) -> torch.Tensor:
    """The partition of each row, from the tree spans."""
    npart = bounds.numel() - 1
    return torch.repeat_interleave(
        torch.arange(npart, device=bounds.device), bounds.diff(),
        output_size=n)


def _window_union(crR: CrackedRelation, crS: CrackedRelation):
    """Both stores' rows as one union in (window, key, side) order, R side
    first: window by window, the exact core's order.  Returns (window,
    key, is_r, payload) in that order."""
    if crR.depth > MAX_WINDOW_DEPTH:
        raise ValueError(f"the windowed join takes at most "
                         f"{MAX_WINDOW_DEPTH} crack levels, got {crR.depth}")
    win = torch.cat([_window_ids(cr.bounds, cr.num_tuples)
                     for cr in (crR, crS)])
    key, is_r, order = mergejoin.sorted_union(crR.key, crS.key, major=win)
    pay = torch.cat([crR.payload.long(), crS.payload.long()])[order]
    return win[order], key, is_r, pay


def _windows_join_count(crR: CrackedRelation, crS: CrackedRelation
                        ) -> mergejoin.JoinCounts:
    """The per-partition joins of every window: matches and checksum."""
    _, key, is_r, pay = _window_union(crR, crS)
    match, prop_pay = mergejoin._matches(key, is_r, pay)
    return hit_counts(match, prop_pay, pay)


def _window_cap(bounds: torch.Tensor) -> int:
    """The largest partition span (one host sync), rounded up to a power
    of two, at least 8."""
    mx = int(bounds.diff().max())
    return max(8, 1 << max(3, (max(1, mx) - 1).bit_length()))


def _windows_join_materialize(crR: CrackedRelation, crS: CrackedRelation
                              ) -> mergejoin.JoinMaterialized:
    """The windowed join's output: cap_s rows a partition, its live rows
    (key, R payload, S payload) first and holes (key -3, payloads 0)
    behind; the columns keep the stores' dtypes."""
    npart, cap_s = crS.bounds.numel() - 1, _window_cap(crS.bounds)
    win, key, is_r, pay = _window_union(crR, crS)
    match, prop_pay = mergejoin._matches(key, is_r, pay)
    # a match's rank among its window's matches (the union is
    # window-major, so a window's matches are consecutive)
    seen = torch.cumsum(match, 0)
    per_win = torch.zeros(npart, dtype=torch.int64, device=key.device)
    per_win.scatter_add_(0, win, match.long())
    before = torch.cumsum(per_win, 0) - per_win
    dest = torch.where(match, win * cap_s + seen - 1 - before[win],
                       npart * cap_s)
    cols = []
    for src, fill, dtype in ((key, -3, crR.key.dtype),
                             (prop_pay, 0, crR.payload.dtype),
                             (pay, 0, crS.payload.dtype)):
        col = torch.full((npart * cap_s + 1,), fill, dtype=dtype,
                         device=key.device)
        col[dest] = src.to(dtype)
        cols.append(col[:-1])
    return mergejoin.JoinMaterialized(*hit_counts(match, prop_pay, pay),
                                      *cols)


def crk_join_cracked(crR: CrackedRelation, crS: CrackedRelation,
                     cfg: JoinConfig, depth: int,
                     pt: Optional[PhaseTimer] = None):
    """Join two (possibly already cracked) stores at `depth`, cracking
    only the levels they lack.  Returns (JoinCounts or JoinMaterialized,
    crR', crS'): the refined stores, for the next query."""
    pt = pt or PhaseTimer(crR.key.device)
    t0 = time.perf_counter()
    if crR.key_bits != crS.key_bits:
        raise ValueError("both stores must crack the same key domain "
                         f"({crR.key_bits} != {crS.key_bits})")
    depth = max(1, min(depth, crR.key_bits))
    crR = crack_to(crR, depth, pt, per_level=cfg.profile_phases)
    crS = crack_to(crS, depth, pt, per_level=cfg.profile_phases)
    if cfg.profile_phases:
        fn = (_windows_join_materialize if cfg.materialize
              else _windows_join_count)
        out = pt.time_fn("join", fn, crR, crS)
    elif cfg.materialize:
        out = pt.time_fn("join", mergejoin.merge_join_materialize,
                         crR.key, crR.payload, crS.key, crS.payload,
                         result_capacity(Relation(crS.key, crS.payload),
                                         cfg))
    elif cfg.checksum:
        out = pt.time_fn("join", mergejoin.merge_join_count, crR.key,
                         crR.payload, crS.key, crS.payload)
    else:
        out = pt.time_fn("join", mergejoin.merge_join_count_keys, crR.key,
                         crS.key)
    pt.t.phases["total"] = time.perf_counter() - t0
    return out, crR, crS


def _query_depth(n_r: int, cfg: JoinConfig, adjust: int) -> int:
    """Crack depth so that a partition holds about cfg.partition_rows R
    rows (the reference's getRadixBits, JoinWrapper.cpp:177-196), plus
    `adjust`, at least 1."""
    return max(1, math.ceil(math.log2(max(2, n_r / cfg.partition_rows)))
               + adjust)


def _crk(name: str, relR: Relation, relS: Relation, cfg: JoinConfig,
         adjust: int):
    radix.require_key_dtype(name, relR, relS)
    pt = PhaseTimer(relR.device)
    depth = _query_depth(relR.num_tuples, cfg, adjust)
    # one key domain for both sides: S is a foreign key into R's keys
    kb = _key_bits(relR.num_tuples)
    out, _, _ = crk_join_cracked(crack_relation(relR, kb),
                                 crack_relation(relS, kb), cfg, depth, pt)
    return to_join_result(out), pt.t


@register("CRKJ")
def CRKJ(relR: Relation, relS: Relation, cfg: JoinConfig):
    """The cracking join (Join::join): crack to the query's depth, then
    join."""
    return _crk("CRKJ", relR, relS, cfg, adjust=0)


@register("CrkJoin")
def CrkJoin(relR: Relation, relS: Relation, cfg: JoinConfig):
    return _crk("CrkJoin", relR, relS, cfg, adjust=0)


@register("CRKJF")
def CRKJF(relR: Relation, relS: Relation, cfg: JoinConfig):
    """The fusion variant (Join::joinFusion): the last crack level is not
    a pass of its own but part of the join (Join.hpp:361-465)."""
    return _crk("CRKJF", relR, relS, cfg, adjust=-1)


@register("CRKJS")
def CRKJS(relR: Relation, relS: Relation, cfg: JoinConfig):
    """The threshold variant (crack_dfs, Join.hpp:260-279): two levels
    fewer; the join absorbs the coarser partitions exactly."""
    return _crk("CRKJS", relR, relS, cfg, adjust=-2)
