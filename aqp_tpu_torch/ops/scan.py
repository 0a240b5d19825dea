"""Column scan operators (counterpart of aqp_tpu/ops/scan.py): the SIMD512
scan family over an 8-bit column against an inclusive [low, high] range, in
its output modes:

    count          number of qualifying rows
    sum            sum of qualifying values
    bitvector      1 bit per row, packed 8 rows per byte
    index          compacted row ids (the implicit index)
    values         compacted qualifying values
    dict           qualifying codes decoded through a dictionary

count, sum and bitvector of a uint8 column on a CUDA device run the
hand-written kernels of ops/kernels/scan.py (B7, B8); on the CPU their plain
versions.  The three dense-capacity modes are plain PyTorch, as they are
plain XLA in the reference: a fixed-capacity buffer and the exact count
(the reference's self-allocating index scan sizes its output by a
pre-count; ops/kernels/scan.py has the block-granular compactor forms).
Counts and sums are exact 0-dim int64 tensors.

Every function takes `device` ("cuda" unless the caller asks for the CPU),
where its tensors must lie; `scan_count_streamed` takes a host column and
scans it on `device`.
"""

from __future__ import annotations

import torch

from aqp_tpu_torch import check_device, resolve_device
from aqp_tpu_torch.ops.kernels import scan as kscan
from aqp_tpu_torch.ops.kernels.scan import range_mask

__all__ = ["range_mask", "scan_count", "scan_sum", "scan_bitvector",
           "scan_index", "scan_values", "scan_dict", "scan_dict_full",
           "scan_count_streamed"]


def scan_count(col, low, high, device="cuda"):
    """SIMD512::count: the number of qualifying rows."""
    check_device(device, col)
    return kscan.count(col, low, high)


def scan_sum(col, low, high, device="cuda"):
    """SIMD512::sum: the sum of the qualifying values."""
    check_device(device, col)
    return kscan.sum_(col, low, high)


def scan_bitvector(col, low, high, device="cuda"):
    """SIMD512::bitvector_scan: 1 bit per row, packed 8 rows per byte (bit i
    of byte j = row 8j+i, as the AVX-512 kmask stores); a ragged tail is
    padded with zero bits."""
    check_device(device, col)
    return kscan.bitvector(col, low, high)


def _compact_indices(mask, capacity: int):
    """Stable compaction of the set positions into a fixed-capacity buffer.
    Returns (row_ids int32 [capacity], count int64); slots past the count
    hold 0, positions past the capacity are dropped."""
    pos = torch.cumsum(mask, 0) - mask.long()
    count = mask.sum()
    keep = mask & (pos < capacity)
    out = torch.zeros((capacity,), dtype=torch.int32, device=mask.device)
    out[pos[keep]] = torch.nonzero(keep, as_tuple=True)[0].to(torch.int32)
    return out, count


def scan_index(col, low, high, capacity: int, device="cuda"):
    """SIMD512 implicit index scan: compacted qualifying row ids + count."""
    check_device(device, col)
    return _compact_indices(range_mask(col, low, high), capacity)


def scan_values(col, low, high, capacity: int, device="cuda"):
    """SIMD512::scan: compacted qualifying values + count (slots past the
    count hold col[0], as the reference's gather of id 0 does)."""
    check_device(device, col)
    ids, count = _compact_indices(range_mask(col, low, high), capacity)
    return col[ids.long()], count


def scan_dict(codes, dictionary, low_code, high_code, capacity: int,
              device="cuda"):
    """SIMD512 dict scans: qualifying small-int codes decoded through a
    dictionary into wide values; the predicate applies to the codes."""
    check_device(device, codes, dictionary)
    ids, count = _compact_indices(range_mask(codes, low_code, high_code),
                                  capacity)
    return dictionary[codes[ids.long()].long()], count


def scan_dict_full(codes, dictionary, device="cuda"):
    """Unconditional dictionary decode (dict_scan without predicate)."""
    check_device(device, codes, dictionary)
    return dictionary[codes.long()]


def scan_count_streamed(host_col, low, high, chunk: int = 1 << 26,
                        device="cuda"):
    """Count scan over a host-resident uint8 column, double-buffered: chunk
    i+1 is copied to the device on a second stream while the count kernel
    scans chunk i, so the rate is bounded by the host-to-device link.  The
    column should be in pinned memory (`tensor.pin_memory()`) for the copy
    to run asynchronously.  Returns the exact count, 0-dim int64 on
    `device`."""
    dev = resolve_device(device)
    if host_col.device.type != "cpu":
        raise ValueError(f"the column must be on the host, not on "
                         f"{host_col.device}")
    n = host_col.numel()
    if dev.type == "cpu":
        total = torch.zeros((), dtype=torch.int64)
        for off in range(0, n, chunk):
            total += kscan.count(host_col[off:off + chunk], low, high)
        return total
    compute = torch.cuda.current_stream(dev)
    copy = torch.cuda.Stream(dev)
    bufs = [torch.empty((min(chunk, n),), dtype=host_col.dtype, device=dev)
            for _ in range(2)]
    done = [torch.cuda.Event(), torch.cuda.Event()]   # a buffer's scan ended
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for i, off in enumerate(range(0, n, chunk)):
        buf = bufs[i % 2][:min(chunk, n - off)]
        with torch.cuda.stream(copy):
            copy.wait_event(done[i % 2])       # its previous scan is done
            buf.copy_(host_col[off:off + chunk], non_blocking=True)
        compute.wait_stream(copy)
        total += kscan.count(buf, low, high)
        done[i % 2].record(compute)
    return total
