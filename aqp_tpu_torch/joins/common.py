"""Shared helpers of the join engines (counterpart of aqp_tpu/joins/common.py)."""

from __future__ import annotations

from aqp_tpu_torch.ops.mergejoin import JoinCounts
from aqp_tpu_torch.relation import JoinResult


def to_join_result(out) -> JoinResult:
    if isinstance(out, JoinCounts):
        return JoinResult(matches=out.matches, checksum=out.checksum)
    raise TypeError(type(out))
