"""Nested-loop and index nested-loop joins: NL and INL (counterpart of
aqp_tpu/joins/nested.py).

  NL   the O(|R| * |S|) all-pairs baseline (nested_loop_join.cpp:54-100):
       S in tiles, each tile compared with all of R as one boolean block
       of about NL_BLOCK_BYTES; no sort and no hash.  Every (R, S) pair
       with equal keys counts, duplicate R keys included.  The block,
       read as int8, times an int8 matrix of ones and R's payload nibbles
       (one torch._int_mm a tile, int32 sums) gives per S row the
       multiplicity and the sum of its partners' payloads mod 2^32 (all
       sixteen nibbles, mod 2^64, to materialize int64 payloads), with no
       wider block; matches and checksum come from those, and the
       materialize form hands them to mergejoin.compact_matches.
  INL  the ordered index is R sorted by key (phase "build", the btree's
       analog, nested_loop_join.cpp:160-217); the probe is the exact merge
       core against it, or with profile_phases a torch.searchsorted of
       every S key (phase "probe") and, to materialize, compact_matches.

Deliberate differences: the reference pads NL's tiles to 2,048 rows with R
key -1 and S key -2 and counts those pads as partners of real keys -1 and
-2; the port pads nothing.  An empty R answers 0 in INL's profile_phases
form, where the reference gathers from an empty index and raises.  Both
names take int32 and int64 keys, compared whole.
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

# Bytes of NL's per-tile boolean block.
NL_BLOCK_BYTES = 1 << 30
# The int32 sums hold up to 15 * |R| (a payload nibble a partner).
NL_MAX_R = 1 << 27
# Each block row goes into the int8 product as NL_SPLIT rows of |R| /
# NL_SPLIT elements (a free view), so that the product has rows enough to
# fill the card; each such row meets its own chunk's weights.
NL_SPLIT = 8

_U32 = 0xFFFFFFFF


def _nl_weights(r_key, r_payload, nibbles: int):
    """R padded to a multiple of 8 * NL_SPLIT rows with copies of its
    first key, and the int8 weights of its NL_SPLIT chunks side by side,
    (rows / NL_SPLIT, 2 * nibbles * NL_SPLIT): chunk q's 2 * nibbles
    columns hold, for its rows, a one (pad rows too, so they count; the
    caller takes them out) and the payload's low `nibbles` nibbles (8 or
    16) as unsigned, low first (pads 0), then zero columns."""
    width = 2 * nibbles
    pad = -r_key.numel() % (8 * NL_SPLIT)
    rk = torch.cat([r_key, r_key[:1].expand(pad)])
    nib = r_payload.long()[:, None] >> torch.arange(
        0, 4 * nibbles, 4, device=r_key.device)
    w = torch.zeros(rk.numel(), width, dtype=torch.int8,
                    device=r_key.device)
    w[:, 0] = 1
    w[:r_key.numel(), 1:nibbles + 1] = (nib & 15).to(torch.int8)
    w = w.view(NL_SPLIT, -1, width).transpose(0, 1).reshape(
        -1, width * NL_SPLIT)
    return rk, w, pad


def _nl_probe_all_pairs(r_key, r_payload, s_key, nibbles: int = 8):
    """Per S row, by all-pairs blocks: the number of R rows with its key
    and the sum of their payloads (int64), mod 2^32 from 8 nibbles, mod
    2^64 from 16.  With unique R keys the sum is the partner's payload,
    its low 32 bits or all 64."""
    dev = s_key.device
    ns = s_key.numel()
    mult = torch.zeros(ns, dtype=torch.int64, device=dev)
    rsum = torch.zeros(ns, dtype=torch.int64, device=dev)
    if r_key.numel() == 0 or ns == 0:
        return mult, rsum
    if r_key.numel() > NL_MAX_R:
        raise ValueError(f"NL takes at most {NL_MAX_R} R rows, got "
                         f"{r_key.numel()}")
    rk, w, pad = _nl_weights(r_key, r_payload, nibbles)
    width = 2 * nibbles
    # whole tiles of at least 32 rows (the int8 product wants more than
    # 16), the last padded with R's first key; the pad rows are dropped
    step = max(32, NL_BLOCK_BYTES // rk.numel() // 32 * 32)
    sk = torch.cat([s_key, rk[:1].expand(-ns % 32)])
    shift = torch.arange(0, 4 * nibbles, 4, device=dev)
    for lo in range(0, ns, step):
        eq = sk[lo:lo + step, None] == rk[None, :]
        rows = eq.shape[0]
        prod = torch._int_mm(eq.view(torch.int8).view(rows * NL_SPLIT, -1),
                             w).view(rows, NL_SPLIT, NL_SPLIT, width)
        # row (j, q) met every chunk's weights: keep chunk q's own
        sums = prod.diagonal(dim1=1, dim2=2).sum(2)[:ns - lo]
        mult[lo:lo + step] = sums[:, 0]
        # int64 sums wrap mod 2^64, the 16-nibble form's modulus
        rsum[lo:lo + step] = (sums[:, 1:nibbles + 1].long() << shift).sum(1)
    if nibbles == 8:
        rsum &= _U32
    # the pad copies of R's first key partnered every S row of that key
    mult -= (s_key == r_key[0]).long() * pad
    return mult, rsum


def _nl_count(r_key, r_payload, s_key, s_payload) -> mergejoin.JoinCounts:
    """All-pairs count with full multiplicity, and the pairs' checksum:
    the sum over S rows of (partners' payloads + multiplicity * own
    payload) mod 2^32."""
    mult, rsum = _nl_probe_all_pairs(r_key, r_payload, s_key)
    ck = (rsum + mult * (s_payload.long() & _U32)) & _U32
    return mergejoin.JoinCounts(mult.sum(), ck.sum() & _U32)


@register("NL")
def NL(relR: Relation, relS: Relation, cfg: JoinConfig):
    """Blocked all-pairs nested-loop join: phase "join", and
    "materialize" to compact the matched S rows."""
    radix.require_key_dtype("NL", relR, relS)
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    if cfg.materialize:
        wide = relR.payload.dtype == torch.int64
        mult, rsum = pt.time_fn("join", _nl_probe_all_pairs, relR.key,
                                relR.payload, relS.key, 16 if wide else 8)
        # the partner's payload: all its bits (16 nibbles), or its low 32
        # read back as the int32 it was
        out = pt.time_fn("materialize", mergejoin.compact_matches,
                         mult > 0, relS.key, rsum.to(relR.payload.dtype),
                         relS.payload, capacity=result_capacity(relS, cfg))
    else:
        out = pt.time_fn("join", _nl_count, relR.key, relR.payload,
                         relS.key, relS.payload)
    pt.t.phases["total"] = time.perf_counter() - t0
    return to_join_result(out), pt.t


def _inl_lookup(sorted_rk, sorted_rp, s_key):
    """Binary search of every S key in the index: (hit, the partner's R
    payload, 0 where no hit).  An empty index hits nothing."""
    if sorted_rk.numel() == 0:
        return (torch.zeros_like(s_key, dtype=torch.bool),
                torch.zeros_like(s_key))
    pos = torch.searchsorted(sorted_rk, s_key).clamp_(
        max=sorted_rk.numel() - 1)
    hit = sorted_rk[pos] == s_key
    return hit, torch.where(hit, sorted_rp[pos], 0)


def _inl_probe(sorted_rk, sorted_rp, s_key, s_payload):
    hit, rpay = _inl_lookup(sorted_rk, sorted_rp, s_key)
    return hit_counts(hit, rpay, s_payload)


@register("INL")
def INL(relR: Relation, relS: Relation, cfg: JoinConfig):
    """Index nested-loop join: the index is R sorted by key (phase
    "build", kept apart as the persistent artifact); the probe is the
    exact merge core against it, one pass over the batch of S keys, or
    with profile_phases an explicit binary search of each."""
    radix.require_key_dtype("INL", relR, relS)
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    rk, rp = pt.time_fn("build", sortmerge._sort_pair, relR.key,
                        relR.payload)
    if cfg.materialize:
        if cfg.profile_phases:
            hit, rpay = pt.time_fn("probe", _inl_lookup, rk, rp, relS.key)
            out = pt.time_fn("materialize", mergejoin.compact_matches,
                             hit, relS.key, rpay, relS.payload,
                             capacity=result_capacity(relS, cfg))
        else:
            out = pt.time_fn("probe", mergejoin.merge_join_materialize,
                             rk, rp, relS.key, relS.payload,
                             result_capacity(relS, cfg))
    elif cfg.profile_phases:
        out = pt.time_fn("probe", _inl_probe, rk, rp, relS.key,
                         relS.payload)
    elif cfg.checksum:
        out = pt.time_fn("probe", mergejoin.merge_join_count, rk, rp,
                         relS.key, relS.payload)
    else:
        out = pt.time_fn("probe", mergejoin.merge_join_count_keys, rk,
                         relS.key)
    pt.t.phases["total"] = time.perf_counter() - t0
    return to_join_result(out), pt.t
