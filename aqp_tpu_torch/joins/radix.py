"""RHO, the radix join (counterpart of the RHO engine of aqp_tpu/joins/radix.py).

The escalation ladder, for counts and for materialized output:

  1. the dense-PK path when it applies;
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
device, through the plain versions on the CPU, so the CPU tests run the
same ladder the card runs.  The no-partition family (joins/nopart.py)
walks the same ladder with its own pipeline: count_tiers, walk_ladder and
exact_core serve both.
"""

from __future__ import annotations

import time
from typing import Optional

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.joins.api import register
from aqp_tpu_torch.joins.common import result_capacity, to_join_result
from aqp_tpu_torch.joins.dense import (dense_pk_applicable, dense_pk_join,
                                       dense_proof)
from aqp_tpu_torch.joins.skewtier import (demote_resid,
                                          rho_skew_split_materialize,
                                          skew_fused_count, skew_plan)
from aqp_tpu_torch.ops import mergejoin
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


def require_key_dtype(name: str, cfg: JoinConfig, *rels: Relation) -> None:
    """Raise unless every relation's key has cfg.key_dtype (int32; key64
    is not ported yet)."""
    for rel in rels:
        if rel.key.dtype != cfg.key_dtype:
            raise TypeError(f"{name} takes {cfg.key_dtype} keys, got "
                            f"{rel.key.dtype}")


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
    """Parallel radix join: count and materialize, through the ladder."""
    require_key_dtype("RHO", cfg, relR, relS)
    if dense_pk_applicable(relR, relS, cfg):
        out = dense_pk_join(relR, relS, cfg)
        if out is not None:
            return out
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    res = None
    if cfg.use_pallas and not holds_input_pads(relR.key, relS.key):
        hinted, cap_rows = skew_plan(relS.key)
        res = walk_ladder(relR, relS, cfg, pt,
                          _materialize_tiers(hinted) if cfg.materialize
                          else count_tiers(relR, cfg, hinted, cap_rows))
    # adversarial skew beyond every tier: the exact core
    if res is None:
        res = exact_core(relR, relS, cfg, pt)
    pt.t.phases["total"] = time.perf_counter() - t0
    return res, pt.t
