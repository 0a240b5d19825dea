"""Radix-partitioned join engines: RHO, RHO_seq, RHT and RSM
(counterpart of aqp_tpu/joins/radix.py).

RHO's escalation ladder, for counts and for materialized output:

  1. the dense-PK path when it applies (never under profile_phases);
  2. the skew tiers first when the cached sampled statistic of S
     (joins/skewtier.skew_plan) says so: for counts the compacted-residual
     tier (when the plan gives a residual capacity), then the full-capacity
     heavy-split tier, then the plain pipeline; for materialize the
     heavy-split materializer, then the plain materializer;
  3. otherwise the plain fixed-slot pipeline (ops/kernels/rho3.py) under
     RETRY_SALTS[0], then the heavy-split tier (slot overflow is almost
     always duplicate-key mass, which no salt spreads);
  4. the pipeline under the other salts;
  5. the exact sort core (ops/mergejoin.py), also at once when a caller's
     key is one of the two input-pad values 2^30-2 and 2^30-1, which the
     pipeline would drop.

A tier's result is used only when its overflow count is zero, so the answer
is never silently wrong.  A compacted-residual tier that overflowed demotes
the cached plan, so later calls on the same S skip it.  With
JoinConfig.defer the first tier's result returns unchecked, its overflow
counter beside it, and joins.api.finalize_join walks the ladder if needed.

The reference takes the pipeline only on a TPU; the port takes it on every
device whenever use_pallas is set, through the plain versions on the CPU,
so the CPU tests run the same ladder the card runs.  The no-partition
family (joins/nopart.py) walks the same ladder with its own pipeline:
count_tiers, walk_ladder and exact_core serve both.

The radix frame (no kernel, plain PyTorch on every device) serves RHO with
use_pallas=False or int64 keys, and RHO_seq, RHT and RSM always:

  partition   plan_radix sizes the partitions (cfg.radix_bits / passes or
              |R| / cfg.partition_rows); each pass is a stable sort on the
              bucket (ops/partition.py), timed as partition_pass1/2;
  fused       (the default) the radix frame as ORDER: the join core runs on
              radix-rotated keys rot(k) = (k mod 2^bits) * 2^(30-bits) +
              (k div 2^bits), a bijection on [0, 2^30) that makes the
              bucket the major sort criterion, so one sort of the union is
              the partition-local order;
  staged      (profile_phases, int64 keys) the partition passes, then the
              join: RHO
              (`_rho_xla`, RHO_seq with two passes) and RSM the exact core,
              RHT a build (R sorted by key, payload prefix sums) and a
              range-scan probe (exact for duplicate R keys).

RHT's fused form is the duplicate-exact run-count core; RHO's, RHO_seq's
and RSM's the unique-R propagate core.

Every name takes int32 and int64 keys (R and S of one dtype).  An int64
key reaches no kernel: RHO skips the ladder (after the dense path, whose
proof is dtype-generic) for the radix frame, and the frame takes the
staged form, whose exact core sorts int64 keys raw, so every int64 key is
exact (the reference's `k << 1` wraps for |k| >= 2^62).  Deliberate
difference: an int32 key >= 2^30 (where rotation is no bijection and the
reference's fused form can join unequal keys) sends a call to the staged
form, which needs no rotation.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import torch

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.joins.api import register
from aqp_tpu_torch.joins.common import result_capacity, to_join_result
from aqp_tpu_torch.joins.dense import (dense_pk_applicable, dense_pk_join,
                                       dense_proof)
from aqp_tpu_torch.joins.skewtier import (demote_resid,
                                          rho_skew_split_materialize,
                                          skew_fused_count, skew_plan)
from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.ops.hashing import radix_bits
from aqp_tpu_torch.ops.partition import radix_histogram, stable_partition
from aqp_tpu_torch.ops.kernels.rho3 import (PAD_R_INPUT, PAD_S_INPUT,
                                            RETRY_SALTS, rho_join_count_v3,
                                            rho_join_materialize_v3)
from aqp_tpu_torch.relation import JoinResult, Relation
from aqp_tpu_torch.utils.cache import cached_by_tensor
from aqp_tpu_torch.utils.timing import PhaseTimer


def _materialize_tiers(hinted: bool):
    """The materialize ladder's tiers, in count_tiers' form."""
    tiers = [(rho_join_materialize_v3, RETRY_SALTS[0], False),
             (rho_skew_split_materialize, RETRY_SALTS[0], False)]
    if hinted:
        tiers.reverse()
    return tiers + [(rho_join_materialize_v3, s, False)
                    for s in RETRY_SALTS[1:]]


def count_tiers(relR: Relation, cfg: JoinConfig, hinted: bool,
                cap_rows: int, count=rho_join_count_v3, pipeline=None):
    """The count ladder's tiers as (fn(rk, rp, sk, sp, salt) -> (matches,
    checksum, overflow), salt, is the compacted-residual tier).

    `count(rk, rp, sk, sp, salt=, with_checksum=)` is the plain tier's
    pipeline and `pipeline` the skew tiers' residual engine
    (skewtier.skew_fused_count); the defaults are RHO's."""
    def r_dense():
        return not cfg.checksum and dense_proof(relR.key)

    def plain(rk, rp, sk, sp, salt):
        return count(rk, rp, sk, sp, salt=salt, with_checksum=cfg.checksum)

    def skewed(rk, rp, sk, sp, salt, resid_cap_rows=0):
        return skew_fused_count(rk, rp, sk, sp, salt,
                                with_checksum=cfg.checksum,
                                pipeline=pipeline,
                                resid_cap_rows=resid_cap_rows,
                                r_dense=r_dense())

    def skew_resid(rk, rp, sk, sp, salt):
        return skewed(rk, rp, sk, sp, salt, resid_cap_rows=cap_rows)

    s0 = RETRY_SALTS[0]
    if hinted:
        tiers = [(skew_resid, s0, True)] if cap_rows else []
        tiers += [(skewed, s0, False), (plain, s0, False)]
    else:
        tiers = [(plain, s0, False), (skewed, s0, False)]
    return tiers + [(plain, s, False) for s in RETRY_SALTS[1:]]


_PAD_CACHE: dict = {}


def _has_pad(key) -> bool:
    return bool(((key == PAD_R_INPUT) | (key == PAD_S_INPUT)).any())


def holds_input_pads(*keys) -> bool:
    """True when a caller's key is PAD_R_INPUT or PAD_S_INPUT (cached per
    tensor, as the dense proof and the skew plan are).  The pipeline drops
    those values as input pads (the skew tier relies on that), so a
    caller's real key of that value goes to the exact core instead."""
    return any(cached_by_tensor(_PAD_CACHE, k, _has_pad) for k in keys)


KEY_DTYPES = (torch.int32, torch.int64)


def require_key_dtype(name: str, *rels: Relation) -> None:
    """Raise unless the relations' keys are int32 or int64, all of one
    dtype.  The dtype decides the route, whatever JoinConfig.key64 says,
    as in the reference."""
    dtypes = {rel.key.dtype for rel in rels}
    if len(dtypes) > 1 or not dtypes <= set(KEY_DTYPES):
        raise TypeError(f"{name} takes int32 or int64 keys of one dtype, "
                        f"got {sorted(map(str, dtypes))}")


def is_key64(*rels: Relation) -> bool:
    """True for 64-bit keys, which no kernel takes: they go to the plain
    PyTorch engines."""
    return any(rel.key.dtype == torch.int64 for rel in rels)


def walk_ladder(relR: Relation, relS: Relation, cfg: JoinConfig,
                pt: PhaseTimer, tiers) -> Optional[JoinResult]:
    """Try the tiers in order (count_tiers' form; for materialize their
    fn returns (matches, checksum, key, r_payload, s_payload, overflow)).
    Returns the first result whose overflow is zero, or with cfg.defer the
    first result unchecked with its overflow counter; None when every tier
    overflowed.  A compacted-residual tier that overflowed demotes the
    cached plan, since the sampled capacity fails the same way next
    call."""
    call = pt.submit_fn if cfg.defer else pt.time_fn
    for fn, salt, resid in tiers:
        out = call("join", fn, relR.key, relR.payload, relS.key,
                   relS.payload, salt=salt)
        ovf = out[-1]
        if cfg.defer or int(ovf) == 0:
            over = ovf if cfg.defer else None
            if cfg.materialize:
                m, c, ok, orp, osp, _ = out
                return JoinResult(matches=m, checksum=c, key=ok,
                                  r_payload=orp, s_payload=osp,
                                  overflow=over)
            return JoinResult(matches=out[0], checksum=out[1],
                              overflow=over)
        if resid:
            demote_resid(relS.key)
    return None


def exact_core(relR: Relation, relS: Relation, cfg: JoinConfig,
               pt: PhaseTimer) -> JoinResult:
    """The ladder's last rung: the exact sort core (ops/mergejoin.py)."""
    if cfg.materialize:
        out = pt.time_fn("join", mergejoin.merge_join_materialize, relR.key,
                         relR.payload, relS.key, relS.payload,
                         result_capacity(relS, cfg))
    elif cfg.checksum:
        out = pt.time_fn("join", mergejoin.merge_join_count, relR.key,
                         relR.payload, relS.key, relS.payload)
    else:
        out = pt.time_fn("join", mergejoin.merge_join_count_keys, relR.key,
                         relS.key)
    return to_join_result(out)


@register("RHO")
def RHO(relR: Relation, relS: Relation, cfg: JoinConfig):
    """Parallel radix join: count and materialize, through the ladder; the
    radix frame when use_pallas is off or the keys are int64."""
    require_key_dtype("RHO", relR, relS)
    if dense_pk_applicable(relR, relS, cfg):
        out = dense_pk_join(relR, relS, cfg)
        if out is not None:
            return out
    if not cfg.use_pallas or is_key64(relR, relS):
        if not cfg.profile_phases:
            return _radix_fused(relR, relS, cfg, general=False)
        return _rho_xla(relR, relS, cfg)
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    res = None
    if not holds_input_pads(relR.key, relS.key):
        hinted, cap_rows = skew_plan(relS.key)
        res = walk_ladder(relR, relS, cfg, pt,
                          _materialize_tiers(hinted) if cfg.materialize
                          else count_tiers(relR, cfg, hinted, cap_rows))
    # adversarial skew beyond every tier: the exact core
    if res is None:
        res = exact_core(relR, relS, cfg, pt)
    pt.t.phases["total"] = time.perf_counter() - t0
    return res, pt.t


# ---------------------------------------------------------------------------
# The radix frame


def plan_radix(num_r: int, cfg: JoinConfig):
    """(total_bits, passes): partitions of about cfg.partition_rows R rows
    (the reference's L2 / CACHE_DIVISOR sizing, radix_join.cpp:295-329)."""
    if cfg.radix_bits is not None:
        bits = cfg.radix_bits
    else:
        bits = max(1, math.ceil(math.log2(max(2, num_r / cfg.partition_rows))))
    if cfg.passes is not None:
        passes = cfg.passes
    else:
        passes = 1 if bits <= 12 else 2
    return bits, passes


def _partition_pass(key, payload, shift: int, bits: int):
    """One radix-partition pass: a stable reorder by bucket, and the
    bucket histogram (int32, 2^bits).  Returns (key, payload, hist)."""
    bucket = radix_bits(key, shift, bits)
    k, p = stable_partition(bucket, key, payload)
    return k, p, radix_histogram(bucket, bits)


def _partition_phases(relR, relS, cfg, pt):
    """The 1-2 pass radix partition of both relations; returns the
    reordered columns (rk, rp, sk, sp)."""
    bits, passes = plan_radix(relR.num_tuples, cfg)
    per_pass = -(-bits // passes)
    rk, rp = relR.key, relR.payload
    sk, sp = relS.key, relS.payload
    shift = 0
    for pno in range(passes):
        b = min(per_pass, bits - pno * per_pass)
        phase = "partition_pass1" if pno == 0 else "partition_pass2"
        rk, rp, _ = pt.time_fn(phase, _partition_pass, rk, rp, shift, b)
        sk, sp, _ = pt.time_fn(phase, _partition_pass, sk, sp, shift, b)
        shift += b
    pt.t.phases["partition"] = pt.t.phases.get(
        "partition_pass1", 0.0) + pt.t.phases.get("partition_pass2", 0.0)
    return rk, rp, sk, sp


def _rot(key: torch.Tensor, bits: int) -> torch.Tensor:
    """Radix-rotate an int32 key (the radix bucket becomes the major bits).
    A bijection on [0, 2^30); a negative key (the hole sentinel -3) maps
    to itself, so a hole never aliases a rotated key."""
    mask = (1 << bits) - 1
    r = ((key & mask) << (30 - bits)) | (key >> bits)
    return torch.where(key < 0, key, r)


def _rot_inv(key: torch.Tensor, bits: int) -> torch.Tensor:
    return _rot(key, 30 - bits)


_ROT_CACHE: dict = {}


def _below_rot_limit(key) -> bool:
    return key.numel() == 0 or int(key.max()) < (1 << 30)


def _supports_rot(relR: Relation, relS: Relation) -> bool:
    """True for int32 keys all below 2^30, where rotation is a bijection
    (cached per tensor); int64 keys go to the staged form, as in the
    reference."""
    return not is_key64(relR, relS) and all(
        cached_by_tensor(_ROT_CACHE, k, _below_rot_limit)
        for k in (relR.key, relS.key))


def _radix_fused_count(rk, rp, sk, sp, bits: int, checksum: bool,
                       general: bool):
    rr, sr = _rot(rk, bits), _rot(sk, bits)
    if general:
        if checksum:
            return mergejoin.merge_join_count_general(rr, rp, sr, sp)
        return mergejoin.merge_join_count_general_keys(rr, sr)
    if checksum:
        return mergejoin.merge_join_count(rr, rp, sr, sp)
    return mergejoin.merge_join_count_keys(rr, sr)


def _radix_fused_materialize(rk, rp, sk, sp, bits: int, capacity: int):
    rr, sr = _rot(rk, bits), _rot(sk, bits)
    out = mergejoin.merge_join_materialize(rr, rp, sr, sp, capacity)
    key = torch.where(out.key >= 0, _rot_inv(out.key, bits), out.key)
    return out._replace(key=key)


def _radix_fused(relR, relS, cfg, general: bool, label="join"):
    """The radix family's fused serving path: the join core on rotated
    keys.  general=True takes the duplicate-exact run-count core (the
    histogram join's semantics, radix_join.cpp:476-612), False the
    unique-R propagate core."""
    if not _supports_rot(relR, relS):
        return _radix_staged(relR, relS, cfg, general)
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    bits = min(plan_radix(relR.num_tuples, cfg)[0], 24)
    if cfg.materialize:
        out = pt.time_fn(
            label, _radix_fused_materialize, relR.key, relR.payload,
            relS.key, relS.payload, bits, result_capacity(relS, cfg))
    else:
        out = pt.time_fn(
            label, _radix_fused_count, relR.key, relR.payload,
            relS.key, relS.payload, bits, cfg.checksum, general)
    pt.t.phases["total"] = time.perf_counter() - t0
    return to_join_result(out), pt.t


def _radix_staged(relR, relS, cfg, general: bool, label="join"):
    """The staged path: partition passes visible to the timer, then the
    exact core on the partitioned columns (as in the reference, it sums
    payloads whatever cfg.checksum says)."""
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    cols = _partition_phases(relR, relS, cfg, pt)
    if cfg.materialize:
        out = pt.time_fn(label, mergejoin.merge_join_materialize, *cols,
                         result_capacity(relS, cfg))
    elif general:
        out = pt.time_fn(label, mergejoin.merge_join_count_general, *cols)
    else:
        out = pt.time_fn(label, mergejoin.merge_join_count, *cols)
    pt.t.phases["total"] = time.perf_counter() - t0
    return to_join_result(out), pt.t


def _rho_xla(relR, relS, cfg):
    """RHO's staged radix frame (profile_phases with use_pallas off)."""
    return _radix_staged(relR, relS, cfg, general=False)


@register("RHO_seq")
def RHO_seq(relR, relS, cfg):
    """RHO with two partition passes (the reference's FORCE_2_PHASES);
    the fused path is one program in rotated order."""
    require_key_dtype("RHO_seq", relR, relS)
    if not cfg.profile_phases:
        return _radix_fused(relR, relS, cfg, general=False)
    return _rho_xla(relR, relS, cfg.replace(passes=2))


# ---------------------------------------------------------------------------
# RHT: the histogram (counting) join

_U32 = 0xFFFFFFFF


def _rht_build(rk, rp):
    """R in key order, and the exclusive prefix of its payloads mod 2^32
    (n + 1 values, int64): the count -> prefix -> reorder structure of the
    histogram join (radix_join.cpp:476-612)."""
    order = torch.sort(rk, stable=True).indices
    k, p = rk[order], rp[order]
    ppref = torch.cumsum(p.long() & _U32, 0) & _U32
    ppref = torch.cat([ppref.new_zeros(1), ppref])
    return k, p, ppref


def _rht_probe(rk_sorted, ppref, sk, sp):
    """Range-scan probe: each S key's R run is [lo, hi), its multiplicity
    hi - lo and its payload sum a prefix difference; exact for duplicate R
    keys (radix_join.cpp:560-612)."""
    lo = torch.searchsorted(rk_sorted, sk, side="left")
    hi = torch.searchsorted(rk_sorted, sk, side="right")
    mult = hi - lo
    rp_sum = (ppref[hi] - ppref[lo]) & _U32
    ck = (rp_sum + ((mult * (sp.long() & _U32)) & _U32)) & _U32
    return mergejoin.JoinCounts(mult.sum(), ck.sum() & _U32)


def _rht_probe_materialize_gather(rk_sorted, rp_sorted, sk, sp):
    """Unique-R materialize probe: the one matching R row of each S row.
    Returns (hit, R payload or 0)."""
    if rk_sorted.numel() == 0:
        return torch.zeros_like(sk, dtype=torch.bool), torch.zeros_like(sp)
    lo = torch.searchsorted(rk_sorted, sk).clamp(max=rk_sorted.numel() - 1)
    hit = rk_sorted[lo] == sk
    return hit, torch.where(hit, rp_sorted[lo], 0)


@register("RHT")
def RHT(relR: Relation, relS: Relation, cfg: JoinConfig):
    """Radix + per-partition histogram join (radix_join.cpp:1645-1648):
    the fused duplicate-exact core on rotated keys; profile_phases stages
    partition, build and probe."""
    require_key_dtype("RHT", relR, relS)
    if not cfg.profile_phases:
        return _radix_fused(relR, relS, cfg, general=True)
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    rk, rp, sk, sp = _partition_phases(relR, relS, cfg, pt)
    rks, rps, ppref = pt.time_fn("build", _rht_build, rk, rp)
    if cfg.materialize:
        hit, rpay = pt.time_fn(
            "probe", _rht_probe_materialize_gather, rks, rps, sk, sp)
        out = pt.time_fn(
            "materialize", mergejoin.compact_matches,
            hit, sk, rpay, sp, capacity=result_capacity(relS, cfg))
    else:
        out = pt.time_fn("probe", _rht_probe, rks, ppref, sk, sp)
    pt.t.phases["total"] = time.perf_counter() - t0
    return to_join_result(out), pt.t


# ---------------------------------------------------------------------------
# RSM: radix + per-partition sort-merge


@register("RSM")
def RSM(relR, relS, cfg):
    """Radix + per-partition sort-merge (radix_sortmerge_join.cpp:82-137):
    one sort in rotated order (bucket bits major: partition-local sorted
    runs) and the propagation merge; profile_phases stages the partition
    passes and the merge."""
    require_key_dtype("RSM", relR, relS)
    if not cfg.profile_phases:
        return _radix_fused(relR, relS, cfg, general=False, label="merge")
    return _radix_staged(relR, relS, cfg, general=False, label="merge")
