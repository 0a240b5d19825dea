"""Shared helpers of the join engines (counterpart of aqp_tpu/joins/common.py)."""

from __future__ import annotations

import torch

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.ops.mergejoin import JoinCounts, JoinMaterialized
from aqp_tpu_torch.relation import JoinResult, Relation

_U32 = 0xFFFFFFFF


def result_capacity(relS: Relation, cfg: JoinConfig) -> int:
    """Materialization capacity: |S| rounded up to whole 128-wide rows (with
    a unique-key build side each S row matches at most once)."""
    n = relS.num_tuples
    return max(128, -(-n // 128) * 128)


def hit_counts(hit: torch.Tensor, r_payload: torch.Tensor,
               s_payload: torch.Tensor) -> JoinCounts:
    """Matches and mod-2^32 checksum of a per-S-row probe: the S rows where
    `hit`, each with its R partner's payload."""
    ck = torch.where(hit, ((r_payload.long() & _U32)
                           + (s_payload.long() & _U32)) & _U32, 0)
    return JoinCounts(hit.sum(), ck.sum() & _U32)


def to_join_result(out) -> JoinResult:
    if isinstance(out, JoinCounts):
        return JoinResult(matches=out.matches, checksum=out.checksum)
    if isinstance(out, JoinMaterialized):
        return JoinResult(matches=out.matches, checksum=out.checksum,
                          key=out.key, r_payload=out.r_payload,
                          s_payload=out.s_payload)
    raise TypeError(type(out))
