"""Beyond-memory streaming join: R resident on the device, S streamed from
the host in chunks (counterpart of aqp_tpu/ops/streamjoin.py).

The reference's regime of data exceeding fast memory, on its long axis:
|S| exceeds device memory, so S stays in host RAM and passes through the
card in fixed-size chunks while R (the PK build side) is built once.

  * build = one sort of R by key (the sorted array in place of a hash
    table), once;
  * probe = per chunk a `torch.searchsorted` into R's keys, a gather and
    masked sums, never a re-sort of R;
  * overlap (on a CUDA device): chunk k+1 is copied to the device on a
    second stream while chunk k is probed.  Two device staging buffers
    take turns; a buffer is refilled only after the probe that reads it
    has ended (an event).  The per-chunk sums stay on the device and the
    host reads them once, at the end.

The copy overlaps the probe only from pinned host memory: pass chunks of
pinned CPU tensors (`tensor.pin_memory()`; `chunk_host_relation` of pinned
tensors yields pinned views).  Numpy arrays and pageable tensors are
accepted and give the same answer, but their copies do not overlap.

Exact for unique R keys (PK build sides), the fast-path engines' contract;
S keys < 0 never match.  The count is an int64 and the checksum (sum of
r_payload + s_payload over the matches) is taken mod 2^32.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from aqp_tpu_torch import check_device
from aqp_tpu_torch.relation import Relation

_MASK32 = 0xFFFFFFFF


def build_sorted(r_key: torch.Tensor, r_payload: torch.Tensor):
    """Build phase, once: R's keys sorted, and its payloads in that
    order."""
    keys, order = torch.sort(r_key, stable=True)
    return keys, r_payload[order]


def probe_chunk(rk_sorted, rp_sorted, s_key, s_payload):
    """(matches, checksum mod 2^32) of one S chunk against the sorted R
    side, as 0-dim int64 tensors on its device.  S keys < 0 never
    match."""
    if rk_sorted.numel() == 0 or s_key.numel() == 0:
        zero = torch.zeros((), dtype=torch.int64, device=s_key.device)
        return zero, zero.clone()
    idx = torch.searchsorted(rk_sorted, s_key)
    idx.clamp_(max=rk_sorted.numel() - 1)
    hit = (rk_sorted[idx] == s_key) & (s_key >= 0)
    pair = ((rp_sorted[idx].long() & _MASK32)
            + (s_payload.long() & _MASK32))
    return (hit.sum(),
            torch.where(hit, pair, 0).sum() & _MASK32)


def _host_tensor(a) -> torch.Tensor:
    t = torch.as_tensor(a)
    if t.device.type != "cpu":
        raise ValueError(f"an S chunk must be on the host, not on {t.device}")
    return t


def streaming_join_count(relR: Relation,
                         s_chunks: Iterable[Tuple[object, object]],
                         device="cuda") -> Tuple[int, int]:
    """Join R, on `device`, against S streamed from the host.

    s_chunks yields (key, payload) host chunks: numpy arrays or CPU
    tensors (pinned for the copies to overlap the probes), of any equal
    length per chunk.  Returns (matches, checksum mod 2^32) as Python
    ints; the host waits for the device once, at the end."""
    dev = check_device(device, relR.key, relR.payload)
    rk, rp = build_sorted(relR.key, relR.payload)
    matches = torch.zeros((), dtype=torch.int64, device=dev)
    checksum = torch.zeros((), dtype=torch.int64, device=dev)
    if dev.type != "cuda":
        for key_h, pay_h in s_chunks:
            m, c = probe_chunk(rk, rp, _host_tensor(key_h),
                               _host_tensor(pay_h))
            matches += m
            checksum = (checksum + c) & _MASK32
        return int(matches), int(checksum)
    compute = torch.cuda.current_stream(dev)
    copy = torch.cuda.Stream(dev)
    bufs = [None, None]                 # (key, payload) staging buffers
    done = [torch.cuda.Event(), torch.cuda.Event()]   # a buffer's probe ended
    for i, (key_h, pay_h) in enumerate(s_chunks):
        key_h, pay_h = _host_tensor(key_h), _host_tensor(pay_h)
        n, b = key_h.numel(), i % 2
        if pay_h.numel() != n:
            raise ValueError(f"chunk {i}: {n} keys but {pay_h.numel()} "
                             "payloads")
        if bufs[b] is None or bufs[b][0].numel() < n:
            # both buffers at once, at the first chunk's size (a later
            # chunk is as long or shorter); made on the compute stream,
            # their memory may still be in use there: the copy stream
            # waits for it before writing
            bufs = [(torch.empty(n, dtype=key_h.dtype, device=dev),
                     torch.empty(n, dtype=pay_h.dtype, device=dev))
                    for _ in range(2)]
            copy.wait_stream(compute)
        sk, sp = bufs[b][0][:n], bufs[b][1][:n]
        with torch.cuda.stream(copy):
            copy.wait_event(done[b])           # its previous probe ended
            sk.copy_(key_h, non_blocking=True)
            sp.copy_(pay_h, non_blocking=True)
        compute.wait_stream(copy)
        m, c = probe_chunk(rk, rp, sk, sp)
        matches += m
        checksum = (checksum + c) & _MASK32
        done[b].record(compute)
    return int(matches), int(checksum)


def chunk_host_relation(key, payload, chunk_rows: int):
    """Standard chunker for a host-resident relation (numpy arrays or CPU
    tensors; views, so chunks of pinned tensors stay pinned)."""
    n = key.shape[0]
    for lo in range(0, n, chunk_rows):
        hi = min(n, lo + chunk_rows)
        yield key[lo:hi], payload[lo:hi]
