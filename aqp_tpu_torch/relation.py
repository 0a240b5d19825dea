"""Columnar relations and join results (counterpart of aqp_tpu/relation.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from aqp_tpu_torch import resolve_device


@dataclasses.dataclass
class Relation:
    """A columnar relation: parallel `key` and `payload` tensors on one
    device."""

    key: torch.Tensor
    payload: torch.Tensor

    @property
    def num_tuples(self) -> int:
        return self.key.shape[0]

    @property
    def device(self) -> torch.device:
        return self.key.device

    @staticmethod
    def from_keys(key: torch.Tensor,
                  payload: Optional[torch.Tensor] = None) -> "Relation":
        if payload is None:
            # the reference generators leave payloads zero
            payload = torch.zeros_like(key)
        return Relation(key=key, payload=payload)

    @staticmethod
    def from_numpy(key: np.ndarray, payload: Optional[np.ndarray] = None,
                   device="cuda") -> "Relation":
        """The same relation as numpy arrays hold it, on `device`: the way a
        relation of the JAX package (np.asarray of its columns) crosses over,
        so that both packages compute on the same data."""
        dev = resolve_device(device)
        k = torch.from_numpy(np.ascontiguousarray(key)).to(dev)
        p = (None if payload is None
             else torch.from_numpy(np.ascontiguousarray(payload)).to(dev))
        return Relation.from_keys(k, p)


@dataclasses.dataclass
class JoinResult:
    """Result of a join: exact `matches` and `checksum` as 0-dim int64
    tensors (the checksum in [0, 2^32): sum of r_payload + s_payload over
    the matches, mod 2^32), and optionally materialized output columns.

    Materialized columns are fixed-capacity and CHUNKED: exactly `matches`
    rows are live, and a hole carries the sentinel key -3 (never a real
    key) with zero payloads.  The exact core and the dense path emit live
    rows first, or in place (holes where S rows did not match); the rho3
    materializer emits region-chunked holes
    (ops/kernels/rho3.rho_join_materialize_v3), the analog of the
    reference's spliced per-thread chunk lists, whose consumers likewise
    iterate chunks rather than assume density.  A further join accepts -3
    directly (it can never match); dense consumers compact with
    ops/mergejoin.compact_matches.

    `overflow` is the deferred-validation channel (JoinConfig.defer): the
    pipeline's device-resident overflow counter, None once validated.  A
    deferred result is valid iff int(overflow) == 0; otherwise
    joins.api.finalize_join runs the ladder again."""

    matches: torch.Tensor
    checksum: torch.Tensor
    key: Optional[torch.Tensor] = None
    r_payload: Optional[torch.Tensor] = None
    s_payload: Optional[torch.Tensor] = None
    overflow: Optional[torch.Tensor] = None

    @property
    def materialized(self) -> bool:
        return self.key is not None
