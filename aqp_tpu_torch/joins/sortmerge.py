"""Sort-merge join engines: PSM and MWAY (counterpart of
aqp_tpu/joins/sortmerge.py).

  PSM   one sort of the union (the fused exact core, ops/mergejoin.py:
        torch.sort is itself a parallel merge hierarchy, the analog of the
        reference's parallel quicksort, parallel_sortmerge_join.cpp:76-118);
        profile_phases first sorts R and S each by key (phase "sort"), then
        runs the exact core on them ("merge").
  MWAY  on a CUDA device with use_pallas (and not profile_phases): the
        fixed-slot pipeline (ops/kernels/rho3.py) in RANGE-ROUTED form,
        salt 1 (sigma = key) and a scale that maps the observed key domain
        onto the fine buckets, so regions in bucket order are the globally
        key-sorted union: K1's block sorts are the sorting phase, K2 and
        the region join the multiway merge and the merge-join
        (sortmergejoin_multiway.cpp:90-537).  A value-skewed domain
        overflows a bucket; the overflow is reported and the call falls
        back to the exact core.  Elsewhere (the CPU, use_pallas=False,
        profile_phases, int64 keys) the explicit form: the union cut into
        PARTFANOUT sorted runs, a binary merge tree of merge-path pair
        merges, and the propagation merge-join with the pad excluded.

The reference's explicit MWAY merges small inputs with bitonic networks and
large ones with merge path (a TPU compiler limit); the port merges with
merge path at every width.  Both are sorts, so with unique R keys the
answers are the same.  The port's explicit form sorts raw keys with their
row ids (the reference's `key << 1` wraps for |key| >= 2^30 in int32 and
2^62 in int64), and MWAY sends a caller's key equal to an input pad of the
pipeline (2^30 - 2 or 2^30 - 1), which the range route would drop, to the
exact core, as RHO does.  Both names take int32 and int64 keys; an int64
key never reaches the range route (its kernels are int32 only): MWAY takes
the explicit form, PSM the exact core, which sorts it raw.
"""

from __future__ import annotations

import time

import torch

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.joins.api import register
from aqp_tpu_torch.joins.common import result_capacity, to_join_result
# a module import: joins.api imports this module while radix may still be
# loading
from aqp_tpu_torch.joins import radix
from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.ops.kernels.rho3 import (Rho3Params, rho_join_count_v3,
                                            rho_join_materialize_v3)
from aqp_tpu_torch.relation import JoinResult, Relation
from aqp_tpu_torch.utils.timing import PhaseTimer

# The reference's PARTFANOUT (mway/params.h:16-24): the number of
# independent sorted runs of the sorting phase.
PARTFANOUT = 128

_U32 = 0xFFFFFFFF


def _merge_pair_rows(ak, ap, bk, bp):
    """Merge each row of a with the same row of b (both sorted) by merge
    path: an a-element's rank in b (side left) plus its own index is its
    output position, a b-element's rank in a (side right) plus its index
    its own, so ties put a first and no two positions collide."""
    m, w = ak.shape
    ia = torch.searchsorted(bk, ak, side="left")
    ib = torch.searchsorted(ak, bk, side="right")
    base = torch.arange(w, device=ak.device)
    da, db = base + ia, base + ib
    out_k = ak.new_empty((m, 2 * w))
    out_p = ap.new_empty((m, 2 * w))
    for out, a, b in ((out_k, ak, bk), (out_p, ap, bp)):
        out.scatter_(1, da, a)
        out.scatter_(1, db, b)
    return out_k, out_p


def _mway_join(rk, rp, sk, sp):
    """MWAY's explicit form: run sort, binary merge tree, propagation
    join.  The raw keys of concat(R, S) move with their row ids; every
    sort and merge is stable, so R's rows stay before S's rows of an equal
    key, and the pad rows that fill the union to whole runs (the dtype's
    largest key) after every real row.  Returns (JoinCounts, (key,
    s payload, match, R payload)) over the merged union."""
    key = torch.cat([rk, sk])
    n = key.numel()
    run = max(8, -(-n // PARTFANOUT))
    run = 1 << (run - 1).bit_length()
    pad = PARTFANOUT * run - n
    key = torch.cat([key, key.new_full((pad,), torch.iinfo(key.dtype).max)])
    # sorting phase: PARTFANOUT independent runs
    kv, order = torch.sort(key.view(PARTFANOUT, run), dim=1, stable=True)
    iv = order + torch.arange(0, PARTFANOUT * run, run,
                              device=key.device)[:, None]
    # multiway merge: log2(PARTFANOUT) rounds of pair merges
    while kv.shape[0] > 1:
        ak, ai = kv[0::2].contiguous(), iv[0::2].contiguous()
        bk, bi = kv[1::2].contiguous(), iv[1::2].contiguous()
        kv, iv = _merge_pair_rows(ak, ai, bk, bi)
    key, idx = kv.reshape(-1), iv.reshape(-1)
    pay = torch.cat([rp.long(), sp.long()])
    pay = torch.cat([pay, pay.new_zeros(pad)])[idx]
    # the merge-join phase (joincommon.h:82-100)
    match, prop_pay = mergejoin._matches(key, idx < rk.numel(), pay)
    match &= idx < n
    ck = torch.where(match, ((prop_pay & _U32) + (pay & _U32)) & _U32, 0)
    counts = mergejoin.JoinCounts(match.sum(), ck.sum() & _U32)
    return counts, (key, pay, match, prop_pay)


def _mway_materialize(rk, rp, sk, sp, capacity: int):
    _, (key, spay, match, prop_pay) = _mway_join(rk, rp, sk, sp)
    return mergejoin.compact_matches(match, key, prop_pay, spay,
                                     capacity=capacity,
                                     dtypes=(rk.dtype, rp.dtype, sp.dtype))


def mway_scale(rk, sk, prm: Rho3Params = Rho3Params()) -> float:
    """The range route's bucket scale, gmax / (max key + 1) * (1 - 1e-6),
    in float32 as the reference computes it."""
    f32 = torch.float32
    kmax = torch.tensor(max(int(rk.max()), int(sk.max())), dtype=f32)
    return (torch.tensor(prm.gmax, dtype=f32) / (kmax + 1.0)
            * torch.tensor(1.0 - 1e-6, dtype=f32)).item()


def _mway_range_count(rk, rp, sk, sp, with_checksum: bool):
    """MWAY on the fixed-slot pipeline, range-routed.  Returns (matches,
    checksum, overflow)."""
    return rho_join_count_v3(rk, rp, sk, sp, salt=1,
                             with_checksum=with_checksum,
                             scale=mway_scale(rk, sk))


def _mway_range_materialize(rk, rp, sk, sp):
    """The range route, materialized: rho_join_materialize_v3's
    region-chunked columns and overflow."""
    return rho_join_materialize_v3(rk, rp, sk, sp, salt=1,
                                   scale=mway_scale(rk, sk))


def _mway_range_available(relR: Relation, relS: Relation,
                          cfg: JoinConfig) -> bool:
    return (cfg.use_pallas and not cfg.profile_phases
            and relR.device.type == "cuda"
            and not radix.is_key64(relR, relS) and relR.num_tuples > 0
            and relS.num_tuples > 0
            and not radix.holds_input_pads(relR.key, relS.key))


@register("MWAY")
def MWAY(relR: Relation, relS: Relation, cfg: JoinConfig):
    """m-way sort-merge join (sortmergejoin_multiway.cpp:90-537): the
    range-routed pipeline on a CUDA device for int32 keys, with the exact
    core on overflow; else the explicit run sort + merge tree."""
    radix.require_key_dtype("MWAY", relR, relS)
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    args = (relR.key, relR.payload, relS.key, relS.payload)
    if _mway_range_available(relR, relS, cfg):
        if cfg.materialize:
            m, c, ok, orp, osp, ovf = pt.time_fn(
                "merge", _mway_range_materialize, *args)
            if int(ovf) == 0:
                pt.t.phases["total"] = time.perf_counter() - t0
                return JoinResult(matches=m, checksum=c, key=ok,
                                  r_payload=orp, s_payload=osp), pt.t
            out = pt.time_fn("merge", mergejoin.merge_join_materialize,
                             *args, result_capacity(relS, cfg))
        else:
            m, c, ovf = pt.time_fn("merge", _mway_range_count, *args,
                                   cfg.checksum)
            if int(ovf) == 0:
                pt.t.phases["total"] = time.perf_counter() - t0
                return JoinResult(matches=m, checksum=c), pt.t
            if cfg.checksum:
                out = pt.time_fn("merge", mergejoin.merge_join_count, *args)
            else:
                out = pt.time_fn("merge", mergejoin.merge_join_count_keys,
                                 relR.key, relS.key)
    elif cfg.materialize:
        out = pt.time_fn("merge", _mway_materialize, *args,
                         capacity=result_capacity(relS, cfg))
    else:
        out, _ = pt.time_fn("merge", _mway_join, *args)
    pt.t.phases["total"] = time.perf_counter() - t0
    return to_join_result(out), pt.t


def _sort_pair(k, p):
    """(k, p) in key order (stable)."""
    order = torch.sort(k, stable=True).indices
    return k[order], p[order]


def _sortmerge(relR: Relation, relS: Relation, cfg: JoinConfig):
    """The sort-merge join behind PSM (and CHT's sparse-domain route): the
    fused exact core; profile_phases pre-sorts both inputs (PSM sorts R
    and S in place, parallel_sortmerge_join.cpp:86-100), then merges."""
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    if not cfg.profile_phases:
        if cfg.materialize:
            out = pt.time_fn("merge", mergejoin.merge_join_materialize,
                             relR.key, relR.payload, relS.key, relS.payload,
                             result_capacity(relS, cfg))
        elif cfg.checksum:
            out = pt.time_fn("merge", mergejoin.merge_join_count, relR.key,
                             relR.payload, relS.key, relS.payload)
        else:
            out = pt.time_fn("merge", mergejoin.merge_join_count_keys,
                             relR.key, relS.key)
    else:
        rk, rp = pt.time_fn("sort", _sort_pair, relR.key, relR.payload)
        sk, sp = pt.time_fn("sort", _sort_pair, relS.key, relS.payload)
        if cfg.materialize:
            out = pt.time_fn("merge", mergejoin.merge_join_materialize,
                             rk, rp, sk, sp, result_capacity(relS, cfg))
        else:
            out = pt.time_fn("merge", mergejoin.merge_join_count,
                             rk, rp, sk, sp)
    pt.t.phases["total"] = time.perf_counter() - t0
    return to_join_result(out), pt.t


@register("PSM")
def PSM(relR: Relation, relS: Relation, cfg: JoinConfig):
    """Parallel sort-merge join (parallel_sortmerge_join.cpp:76-118):
    `_sortmerge`."""
    radix.require_key_dtype("PSM", relR, relS)
    return _sortmerge(relR, relS, cfg)
