"""RHO, the radix join (counterpart of the RHO engine of aqp_tpu/joins/radix.py).

The count ladder: the dense-PK path when it applies, then the fixed-slot
pipeline (ops/kernels/rho3.py) under RETRY_SALTS[0], then under the other
salts, then the exact sort core.  A tier's result is used only when its
overflow count is zero, so the answer is never silently wrong.

The reference takes the pipeline only on a TPU; the port takes it on every
device, through the plain versions on the CPU, so the CPU tests run the
same ladder the card runs.  Not ported yet: the heavy-split skew tier
(a duplicate-heavy input still gets its exact answer through the salts and
the exact core) and materialization.
"""

from __future__ import annotations

import time

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.joins.api import register
from aqp_tpu_torch.joins.common import to_join_result
from aqp_tpu_torch.joins.dense import dense_pk_applicable, dense_pk_join
from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.ops.kernels.rho3 import RETRY_SALTS, rho_join_count_v3
from aqp_tpu_torch.relation import JoinResult, Relation
from aqp_tpu_torch.utils.timing import PhaseTimer


@register("RHO")
def RHO(relR: Relation, relS: Relation, cfg: JoinConfig):
    """Parallel radix join, count path."""
    if cfg.materialize:
        raise NotImplementedError("RHO materialization is not ported yet")
    for rel in (relR, relS):
        if rel.key.dtype != cfg.key_dtype:
            raise TypeError(f"RHO takes {cfg.key_dtype} keys, got "
                            f"{rel.key.dtype}")
    if dense_pk_applicable(relR, relS, cfg):
        out = dense_pk_join(relR, relS, cfg)
        if out is not None:
            return out
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    if cfg.use_pallas:
        call = pt.submit_fn if cfg.defer else pt.time_fn
        for salt in RETRY_SALTS:
            m, c, ovf = call("join", rho_join_count_v3, relR.key,
                             relR.payload, relS.key, relS.payload, salt=salt,
                             with_checksum=cfg.checksum)
            if cfg.defer:
                pt.t.phases["total"] = time.perf_counter() - t0
                return JoinResult(matches=m, checksum=c, overflow=ovf), pt.t
            if int(ovf) == 0:
                pt.t.phases["total"] = time.perf_counter() - t0
                return JoinResult(matches=m, checksum=c), pt.t
    # adversarial skew beyond every salt: the exact core
    out = pt.time_fn("join", mergejoin.merge_join_count, relR.key,
                     relR.payload, relS.key, relS.payload)
    pt.t.phases["total"] = time.perf_counter() - t0
    return to_join_result(out), pt.t
