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
    """Result of a count join: `matches` and `checksum` as 0-dim int64
    tensors (the checksum in [0, 2^32): sum of r_payload + s_payload over
    the matches, mod 2^32).

    `overflow` is the deferred-validation channel (JoinConfig.defer): the
    pipeline's device-resident overflow counter, None once validated.  A
    deferred result is valid iff int(overflow) == 0; otherwise
    joins.api.finalize_join runs the ladder again."""

    matches: torch.Tensor
    checksum: torch.Tensor
    overflow: Optional[torch.Tensor] = None
