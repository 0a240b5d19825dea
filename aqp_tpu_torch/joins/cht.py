"""Concise hash table join: CHT (counterpart of aqp_tpu/joins/cht.py).

The reference (CHTJoinWrapper.cpp:52-98, CHT.hpp:25-293) builds a bitmap
over the key domain with a popcount prefix and stores R's tuples compacted
at their rank.  Here: `present[domain]`, the rank of every domain key and
R sorted by key (phase "build"); the domain is the least power of two at
or above max(R) + 2, read with one host sync.  A domain larger than
16 * |R| (too sparse for the table, an empty R too) goes to the sort-merge
join (`sortmerge._sortmerge`), as the reference does.

The serving path still builds the table and probes the key-sorted R with
the exact merge core (phase "probe"); profile_phases probes the bitmap and
the rank instead, and to materialize compacts the hits
(mergejoin.compact_matches, phase "materialize").

Deliberate difference: the rank counts R rows below the key, negative keys
included, where the reference's counts present keys; with unique keys in
[0, domain) the two agree, and with duplicate or negative R keys the port
still reads a row of the probed key.  Out-of-domain R keys are indexed
explicitly (JAX wraps a negative index and drops the rest).  Int32 and
int64 keys: a sparse int64 domain (keys above 2^32, say) goes to the
sort-merge join, whose exact core sorts an int64 key raw.
"""

from __future__ import annotations

import time

import torch

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.joins.api import register
# module imports: joins.api imports this module while they may still be
# loading
from aqp_tpu_torch.joins import radix, sortmerge
from aqp_tpu_torch.joins.common import (hit_counts, result_capacity,
                                        to_join_result)
from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.relation import Relation
from aqp_tpu_torch.utils.timing import PhaseTimer


def cht_domain(r_key: torch.Tensor) -> int:
    """The table's key domain: 2^ceil(log2(max(R) + 2)), at least 2 (one
    host sync; 2 for an empty R)."""
    max_key = int(r_key.max()) if r_key.numel() else -1
    return 1 << max(1, max(0, max_key + 1).bit_length())


def build_cht(r_key, r_payload, domain: int):
    """(present[domain] bool, rank[domain] int64, R's keys and payloads in
    key order).  The rows of a present key k start at rank[k] in the
    key-sorted R: rank is the exclusive prefix of the domain's row counts,
    past R's keys below 0."""
    in_dom = (r_key >= 0) & (r_key < domain)
    cnt = torch.zeros(domain + 1, dtype=torch.int64, device=r_key.device)
    cnt.index_add_(0, torch.where(in_dom, r_key.long(), domain),
                   torch.ones_like(r_key, dtype=torch.int64))
    cnt = cnt[:domain]
    rank = torch.cumsum(cnt, 0) - cnt + (r_key < 0).sum()
    ck, cp = sortmerge._sort_pair(r_key, r_payload)
    return cnt > 0, rank, ck, cp


def probe_cht(present, rank, cp, s_key, domain: int):
    """Bitmap test and rank lookup of every S key: (hit, the partner's R
    payload, 0 where no hit)."""
    in_dom = (s_key >= 0) & (s_key < domain)
    safe = torch.where(in_dom, s_key.long(), 0)
    hit = in_dom & present[safe]
    rpay = torch.where(hit, cp[torch.where(hit, rank[safe], 0)], 0)
    return hit, rpay


@register("CHT")
def CHT(relR: Relation, relS: Relation, cfg: JoinConfig):
    """Concise hash table join, or `_sortmerge` on a sparse domain."""
    radix.require_key_dtype("CHT", relR, relS)
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    domain = cht_domain(relR.key)
    if domain > 16 * relR.num_tuples:
        return sortmerge._sortmerge(relR, relS, cfg)
    present, rank, ck, cp = pt.time_fn("build", build_cht, relR.key,
                                       relR.payload, domain)
    if not cfg.profile_phases:
        if cfg.materialize:
            out = pt.time_fn("probe", mergejoin.merge_join_materialize,
                             ck, cp, relS.key, relS.payload,
                             result_capacity(relS, cfg))
        elif cfg.checksum:
            out = pt.time_fn("probe", mergejoin.merge_join_count, ck, cp,
                             relS.key, relS.payload)
        else:
            out = pt.time_fn("probe", mergejoin.merge_join_count_keys, ck,
                             relS.key)
        pt.t.phases["total"] = time.perf_counter() - t0
        return to_join_result(out), pt.t
    if cfg.materialize:
        hit, rpay = pt.time_fn("probe", probe_cht, present, rank, cp,
                               relS.key, domain)
        out = pt.time_fn("materialize", mergejoin.compact_matches, hit,
                         relS.key, rpay, relS.payload,
                         capacity=result_capacity(relS, cfg))
    else:
        out = pt.time_fn("probe", lambda: hit_counts(
            *probe_cht(present, rank, cp, relS.key, domain), relS.payload))
    pt.t.phases["total"] = time.perf_counter() - t0
    return to_join_result(out), pt.t
