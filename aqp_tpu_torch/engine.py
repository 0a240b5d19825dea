"""Fused entry points for benchmarking and serving (counterpart of
aqp_tpu/engine.py).

The reference runs the Pallas pipeline on a TPU and the XLA sort core
elsewhere; the port runs the fixed-slot pipeline (ops/kernels/rho3.py) on
every device: kernels on a CUDA device, plain versions on the CPU.  Each
entry point takes `device` ("cuda" unless the caller asks for the CPU),
where its tensors must lie.
"""

from __future__ import annotations

from aqp_tpu_torch import check_device
from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.ops.kernels.rho3 import (rho_join_count_v3,
                                            rho_join_materialize_v3)


def rho_join_count_fused(rk, rp, sk, sp, device="cuda"):
    """Fused RHO count join with checksum.  Returns (matches, checksum,
    overflow); overflow > 0 means the result is invalid (see
    rho_join_count_checked)."""
    check_device(device, rk, rp, sk, sp)
    return rho_join_count_v3(rk, rp, sk, sp)


def rho_join_count_checked(rk, rp, sk, sp, device="cuda"):
    """Run the fused pipeline; use the exact core when it overflowed."""
    m, c, ovf = rho_join_count_fused(rk, rp, sk, sp, device=device)
    if int(ovf) != 0:
        out = mergejoin.merge_join_count(rk, rp, sk, sp)
        return out.matches, out.checksum
    return m, c


def rho_join_count(rk, rp, sk, sp, device="cuda"):
    """Exact count join for any key distribution: the sort core."""
    check_device(device, rk, rp, sk, sp)
    return mergejoin.merge_join_count(rk, rp, sk, sp)


def rho_join_materialize_fused(rk, rp, sk, sp, device="cuda"):
    """Fused materializing RHO join: region-chunked output columns with
    sentinel holes (see rho3.rho_join_materialize_v3).  Returns (matches,
    checksum, key, r_payload, s_payload, overflow); overflow > 0 means the
    result is invalid."""
    check_device(device, rk, rp, sk, sp)
    return rho_join_materialize_v3(rk, rp, sk, sp)


def rho_join_materialize(rk, rp, sk, sp, capacity: int, device="cuda"):
    """Dense fixed-capacity materialized join (the exact sort core): live
    rows first, holes keyed -3 behind them."""
    check_device(device, rk, rp, sk, sp)
    return mergejoin.merge_join_materialize(rk, rp, sk, sp, capacity)
