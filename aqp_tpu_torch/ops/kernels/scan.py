"""Column-scan kernels (counterpart of aqp_tpu/ops/pallas/scan.py).

The hot scan modes over an 8-bit column, lo <= x <= hi:

  count      the number of qualifying rows        (B7, csrc/scan.cu)
  sum        the sum of the qualifying values     (B7)
  bitvector  one bit per row, bit i of byte j = row 8j+i  (B8)

Each has a plain PyTorch version (`count_plain`, `sum_plain`,
`bitvector_plain`) and a wrapper (`count`, `sum_`, `bitvector`) that sends a
CPU tensor to it and a CUDA tensor to the hand-written kernel; there is no
fallback from one to the other.  `LAUNCHES` counts the kernel launches.
Counts and sums are exact 0-dim int64 tensors for any n (the reference's
sum is int32 without x64, ROADMAP "Quirks").  The kernels take any n and
any pointer; the `*_pallas` entries keep the reference's names and its
requirement that n be a multiple of sub*128.

The write-producing modes (index, values, dict) ride the window compactor
(ops/kernels/lanecompact.py), with the selectivity hint quantized by
`hint_ladder`, as the reference's do.
"""

from __future__ import annotations

from typing import Optional

import torch

from aqp_tpu_torch import check_device
from aqp_tpu_torch.ops.kernels import build
from aqp_tpu_torch.ops.kernels.build import on_cuda, ptr, stream
from aqp_tpu_torch.ops.kernels.lanecompact import (hint_ladder,
                                                   scan_dict_fast,
                                                   scan_index_fast,
                                                   scan_values_fast)

LANES = 128
SUB = 4096  # the reference's rows of 128 bytes per block

# Launches of each hand-written kernel in this process (the plain versions
# do not count).  Reset by assigning 0.
LAUNCHES = {"scan_count": 0, "scan_sum": 0, "scan_bitvector": 0}


def byte_range(low, high):
    """[low, high] clamped to the bytes [0, 255]; (1, 0), an empty range,
    when no byte qualifies."""
    lo, hi = max(int(low), 0), min(int(high), 255)
    return (lo, hi) if lo <= hi else (1, 0)


def range_mask(col, low, high):
    """low <= col <= high (inclusive, as SIMD512's cmpge/cmple).  For an
    integer column the bounds are first clamped to its dtype's range:
    PyTorch would wrap an out-of-range bound into it."""
    low, high = int(low), int(high)
    if not col.dtype.is_floating_point and col.dtype != torch.bool:
        info = torch.iinfo(col.dtype)
        if low > info.max or high < info.min or low > high:
            return torch.zeros(col.shape, dtype=torch.bool,
                               device=col.device)
        low, high = max(low, info.min), min(high, info.max)
    return (col >= low) & (col <= high)


def count_plain(col, low, high):
    """The number of rows with low <= x <= high, 0-dim int64."""
    return range_mask(col, low, high).sum()


def sum_plain(col, low, high):
    """The sum of the values with low <= x <= high, exact 0-dim int64."""
    m = range_mask(col, low, high)
    return torch.where(m, col, 0).sum(dtype=torch.int64)


def bitvector_plain(col, low, high):
    """uint8[ceil(n / 8)]: bit i of byte j = row 8j+i qualifies; bits past n
    are 0."""
    m = range_mask(col, low, high)
    m = torch.cat([m, m.new_zeros(-m.numel() % 8)]).view(-1, 8)
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                           device=col.device)
    return (m.to(torch.uint8) * weights).sum(1, dtype=torch.uint8)


def _check_col(col):
    if col.dtype != torch.uint8:
        raise TypeError(f"the scan kernels take a uint8 column, got "
                        f"{col.dtype}")
    if col.dim() != 1 or not col.is_contiguous():
        raise ValueError("the column must be a contiguous 1-d tensor")


def _reduce(col, low, high, with_sum: bool):
    _check_col(col)
    dev = col.device
    out = torch.zeros((), dtype=torch.int64, device=dev)
    lo, hi = byte_range(low, high)
    lib = build.load()
    err = lib.scan_reduce(ptr(col), col.numel(), lo, hi, int(with_sum),
                          ptr(out), stream(dev))
    name = "scan_sum" if with_sum else "scan_count"
    build.check(lib, err, name)
    LAUNCHES[name] += 1
    return out


def count(col, low, high):
    """B7: the number of qualifying rows (see count_plain)."""
    if not on_cuda(col):
        return count_plain(col, low, high)
    return _reduce(col, low, high, False)


def sum_(col, low, high):
    """B7: the sum of the qualifying values (see sum_plain)."""
    if not on_cuda(col):
        return sum_plain(col, low, high)
    return _reduce(col, low, high, True)


def bitvector(col, low, high):
    """B8: the packed bitvector (see bitvector_plain)."""
    if not on_cuda(col):
        return bitvector_plain(col, low, high)
    _check_col(col)
    dev = col.device
    n = col.numel()
    out = torch.empty(((n + 7) // 8,), dtype=torch.uint8, device=dev)
    lo, hi = byte_range(low, high)
    lib = build.load()
    err = lib.scan_bitvector(ptr(col), n, lo, hi, ptr(out), stream(dev))
    build.check(lib, err, "scan_bitvector")
    LAUNCHES["scan_bitvector"] += 1
    return out


def _grid(n: int, sub: int) -> int:
    if n % (sub * LANES):
        raise ValueError(f"{n} rows are not whole blocks of {sub * LANES}")
    return n // (sub * LANES)


def scan_count_pallas(col, low, high, sub: int = SUB, device="cuda"):
    """SIMD512::count: the number of rows with low <= col <= high."""
    check_device(device, col)
    _grid(col.numel(), sub)
    return count(col, low, high)


def scan_sum_pallas(col, low, high, sub: int = SUB, device="cuda"):
    """SIMD512::sum: the sum of the qualifying values (exact int64)."""
    check_device(device, col)
    _grid(col.numel(), sub)
    return sum_(col, low, high)


def scan_bitvector_pallas(col, low, high, sub: int = SUB, device="cuda"):
    """SIMD512::bitvector_scan: 1 bit per row, flat byte order."""
    check_device(device, col)
    _grid(col.numel(), sub)
    return bitvector(col, low, high)


def scan_index_pallas(col, low, high, cap_rows: int,
                      sel_hint: Optional[float] = None, device="cuda"):
    """Implicit index scan: compacted row ids of the qualifying rows.
    Returns (rowids[cap_rows*128], count, overflow); empty slots carry
    PAD_S_INPUT (never a row id)."""
    check_device(device, col)
    return scan_index_fast(col, low, high, cap_rows,
                           sel_hint=hint_ladder(sel_hint))


def scan_values_pallas(col, low, high, cap_rows: int,
                       sel_hint: Optional[float] = None, device="cuda"):
    """Value scan (SIMD512::scan): (rowids, values as int32, count,
    overflow).  Slots with rowid >= 2^30-1 are block-boundary filler; the
    value filler (0) is a legal value, so consumers mask by rowid."""
    check_device(device, col)
    return scan_values_fast(col, low, high, cap_rows,
                            sel_hint=hint_ladder(sel_hint))


def scan_dict_pallas(col, dict_lo, dict_hi, low, high, cap_rows: int,
                     sel_hint: Optional[float] = None, device="cuda"):
    """Dict scan: the qualifying 8-bit codes decoded through a 256-entry
    dictionary of 64-bit values stored as two int32 planes.  Returns
    (rowids, lo, hi, count, overflow)."""
    check_device(device, col, dict_lo, dict_hi)
    return scan_dict_fast(col, dict_lo, dict_hi, low, high, cap_rows,
                          sel_hint=hint_ladder(sel_hint))
