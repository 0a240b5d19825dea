"""Shared helpers of the join engines (counterpart of aqp_tpu/joins/common.py)."""

from __future__ import annotations

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.ops.mergejoin import JoinCounts, JoinMaterialized
from aqp_tpu_torch.relation import JoinResult, Relation


def result_capacity(relS: Relation, cfg: JoinConfig) -> int:
    """Materialization capacity: |S| rounded up to whole 128-wide rows (with
    a unique-key build side each S row matches at most once)."""
    n = relS.num_tuples
    return max(128, -(-n // 128) * 128)


def to_join_result(out) -> JoinResult:
    if isinstance(out, JoinCounts):
        return JoinResult(matches=out.matches, checksum=out.checksum)
    if isinstance(out, JoinMaterialized):
        return JoinResult(matches=out.matches, checksum=out.checksum,
                          key=out.key, r_payload=out.r_payload,
                          s_payload=out.s_payload)
    raise TypeError(type(out))
