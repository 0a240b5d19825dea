"""Runtime configuration of the joins (counterpart of aqp_tpu/config.py).

`JoinConfig` keeps the reference's fields and defaults, so that one
configuration means the same thing to both packages.  Fields that only
engines of later slices read are kept for that reason.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Default target rows per final partition of the partition planner.
DEFAULT_PARTITION_ROWS = 1 << 13


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """Join configuration (analog of the reference's joinconfig_t)."""

    # Radix bits per pass; None -> derived from |R|.  (Radix engines of a
    # later slice.)
    radix_bits: Optional[int] = None
    # Forced number of partition passes; None -> derived.
    passes: Optional[int] = None
    # Materialize (key, r_payload, s_payload).
    materialize: bool = False
    # 64-bit keys and payloads (the reference's KEY_8B): key_dtype, the
    # dtype the CLI and the harness draw relations in.  The joins route by the keys' dtype, whatever this says: an
    # int64 key reaches no kernel (joins/radix.is_key64).
    key64: bool = False
    # Load factor of the no-partition joins' staged open-addressing table
    # (joins/nopart.table_bits_for; use_pallas=False or profile_phases).
    load_factor: float = 0.5
    # Linear-probe window of that table (joins/nopart.probe_table).
    probe_window: int = 4
    # Rows per partition targeted by the partition planner.
    partition_rows: int = DEFAULT_PARTITION_ROWS
    # Run the hand-written kernels' pipelines (rho3, nphj); False -> RHO's
    # exact sort core, the no-partition joins' staged engines.
    use_pallas: bool = True
    # Compute the mod-2^32 payload checksum; False runs the keys-only
    # pipeline, which moves no payloads.
    checksum: bool = True
    # Serve FK -> dense-PK joins through the dense index when |R| is small.
    dense_path: bool = True
    dense_path_max_r: int = 1 << 21
    # Return without any host synchronisation; joins.api.finalize_join
    # validates the overflow counter later.
    defer: bool = False
    # Staged per-phase timing; it also turns off the dense path and sends the
    # no-partition joins to their staged engines.
    profile_phases: bool = False

    @property
    def key_dtype(self) -> torch.dtype:
        return torch.int64 if self.key64 else torch.int32

    def replace(self, **kw) -> "JoinConfig":
        return dataclasses.replace(self, **kw)
