"""Dense-PK fast path for small build sides (counterpart of
aqp_tpu/joins/dense.py).

When the build side is provably the dense key set {1..|R|} (the FK ->
dense-PK case), the join has a closed form:

    membership:  hit(s) = 1 <= s <= |R|
    payload:     r_payload(s) = P[s-1]   (P = payloads in key order)

The proof is exact: sort(R.key) == [1..n], computed once per key tensor
and cached by identity (a weak reference, so the cache never keeps a
tensor alive).  Unlike a JAX array a torch tensor can be changed in place;
the cache also records the tensor's version counter, which every in-place
write bumps, and proves again when it moved.
"""

from __future__ import annotations

import time

import torch

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.relation import JoinResult, Relation
from aqp_tpu_torch.utils.cache import cached_by_tensor
from aqp_tpu_torch.utils.timing import PhaseTimer

_U32 = 0xFFFFFFFF
_PROOF_CACHE: dict = {}


def _dense_check(r_key: torch.Tensor) -> bool:
    n = r_key.numel()
    srt = torch.sort(r_key.long()).values
    return bool(torch.equal(srt, torch.arange(1, n + 1, device=r_key.device)))


def dense_proof(r_key: torch.Tensor) -> bool:
    """True iff the keys are exactly {1..n} in some order (cached per
    tensor)."""
    return cached_by_tensor(_PROOF_CACHE, r_key, _dense_check)


def dense_pk_applicable(relR: Relation, relS: Relation,
                        cfg: JoinConfig) -> bool:
    return (cfg.dense_path and relR.num_tuples <= cfg.dense_path_max_r
            and not cfg.profile_phases)


def _count_keys(n_r: int, sk: torch.Tensor):
    hit = (sk >= 1) & (sk <= n_r)
    return hit.sum(), torch.zeros((), dtype=torch.int64, device=sk.device)


def _payload_by_key(rk, rp):
    """P[k-1] = payload of key k (valid only under the dense proof)."""
    P = torch.empty_like(rp)
    P[rk.long() - 1] = rp
    return P


def _dense_hits(rk, rp, sk, sp):
    """Per S row: hit, the R payload it joins (0 where no hit), and the
    row's checksum term as unsigned int64."""
    n = rk.numel()
    hit = (sk >= 1) & (sk <= n)
    if n == 0:      # the proof holds vacuously; there is no payload to read
        rpay = torch.zeros_like(sp)
    else:
        idx = torch.where(hit, sk.long() - 1, 0)
        rpay = torch.where(hit, _payload_by_key(rk, rp)[idx], 0)
    ck = torch.where(hit, ((rpay.long() & _U32) + (sp.long() & _U32)) & _U32,
                     0)
    return hit, rpay, ck


def _count_checksum(rk, rp, sk, sp):
    hit, _, ck = _dense_hits(rk, rp, sk, sp)
    return hit.sum(), ck.sum() & _U32


def _materialize(rk, rp, sk, sp):
    """In-place chunked output (holes keyed -3): every matched S row joins
    its single R row, at the S row's own position."""
    hit, rpay, ck = _dense_hits(rk, rp, sk, sp)
    return (hit.sum(), ck.sum() & _U32, torch.where(hit, sk, -3), rpay,
            torch.where(hit, sp, 0))


def dense_pk_join(relR: Relation, relS: Relation, cfg: JoinConfig):
    """Serve the join through the dense index if the proof holds; None
    otherwise (the caller goes on to the general pipeline)."""
    if not dense_proof(relR.key):
        return None
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    call = pt.submit_fn if cfg.defer else pt.time_fn
    if cfg.materialize:
        m, c, ok, orp, osp = call("join", _materialize, relR.key,
                                  relR.payload, relS.key, relS.payload)
        res = JoinResult(matches=m, checksum=c, key=ok, r_payload=orp,
                         s_payload=osp)
    elif cfg.checksum:
        m, c = call("join", _count_checksum, relR.key, relR.payload,
                    relS.key, relS.payload)
        res = JoinResult(matches=m, checksum=c)
    else:
        m, c = call("join", _count_keys, relR.num_tuples, relS.key)
        res = JoinResult(matches=m, checksum=c)
    pt.t.phases["total"] = time.perf_counter() - t0
    return res, pt.t
