"""Dense-PK fast path for small build sides (counterpart of
aqp_tpu/joins/dense.py, count paths).

When the build side is provably the dense key set {1..|R|} (the FK ->
dense-PK case), the join has a closed form:

    membership:  hit(s) = 1 <= s <= |R|
    payload:     r_payload(s) = P[s-1]   (P = payloads in key order)

The proof is exact: sort(R.key) == [1..n].  The reference caches it by
array identity; torch tensors can be changed in place, so the port proves
it on every call (one sort of at most dense_path_max_r keys).
"""

from __future__ import annotations

import time

import torch

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.relation import JoinResult, Relation
from aqp_tpu_torch.utils.timing import PhaseTimer

_U32 = 0xFFFFFFFF


def dense_proof(r_key: torch.Tensor) -> bool:
    """True iff the keys are exactly {1..n} in some order."""
    n = r_key.numel()
    srt = torch.sort(r_key.long()).values
    return bool(torch.equal(srt, torch.arange(1, n + 1, device=r_key.device)))


def dense_pk_applicable(relR: Relation, relS: Relation,
                        cfg: JoinConfig) -> bool:
    return (cfg.dense_path and relR.num_tuples <= cfg.dense_path_max_r
            and not cfg.profile_phases)


def _count_keys(n_r: int, sk: torch.Tensor):
    hit = (sk >= 1) & (sk <= n_r)
    return hit.sum(), torch.zeros((), dtype=torch.int64, device=sk.device)


def _count_checksum(rk, rp, sk, sp):
    n = rk.numel()
    P = torch.empty(n, dtype=torch.int64, device=rk.device)
    P[rk.long() - 1] = rp.long() & _U32     # payload of key k at k-1
    hit = (sk >= 1) & (sk <= n)
    idx = torch.where(hit, sk.long() - 1, 0)
    ck = torch.where(hit, (P[idx] + (sp.long() & _U32)) & _U32, 0)
    return hit.sum(), ck.sum() & _U32


def dense_pk_join(relR: Relation, relS: Relation, cfg: JoinConfig):
    """Serve the join through the dense index if the proof holds; None
    otherwise (the caller goes on to the general pipeline)."""
    if not dense_proof(relR.key):
        return None
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    call = pt.submit_fn if cfg.defer else pt.time_fn
    if cfg.checksum:
        m, c = call("join", _count_checksum, relR.key, relR.payload,
                    relS.key, relS.payload)
    else:
        m, c = call("join", _count_keys, relR.num_tuples, relS.key)
    pt.t.phases["total"] = time.perf_counter() - t0
    return JoinResult(matches=m, checksum=c), pt.t
