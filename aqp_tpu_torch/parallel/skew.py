"""Skew-aware distributed join: heavy-hitter detection + broadcast join
(counterpart of aqp_tpu/parallel/skew.py).

The reference absorbs skew by stealing oversized partitions from a task
queue (radix_join.cpp:1086-1335); across ranks the strategy is structural:

  1. detect the globally heavy probe keys (exact local run lengths of a
     sorted shard, then the candidates gathered and counted on every rank);
  2. route the heavy keys' build rows by REPLICATION (all_gather) and leave
     their probe rows LOCAL (hashing them would overload one rank);
  3. shuffle only the light rows with the hash all_to_all.

Each (r, s) match is counted once: a heavy S row lives on one rank, heavy
R rows on every rank; light pairs meet on the hash owner.  Counts and
checksums reduce with all_reduce.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.parallel.dist_join import (
    _U32, _all_reduce, _capacity, _shard_call)
from aqp_tpu_torch.parallel.shuffle import PAD_R, PAD_S, shuffle_relation


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors `t`, concatenated in group rank order."""
    out = t.new_empty((dist.get_world_size(group) * t.numel(),))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def _local_topk_runs(key, k: int, pad_key):
    """The k longest runs (key, count) of the local shard, exact, from a
    sort: a stable descending sort of the run lengths keeps the lower
    index first among equal counts, as jax.lax.top_k does."""
    sk = torch.sort(key).values
    n = sk.numel()
    start = torch.ones(n, dtype=torch.bool, device=key.device)
    start[1:] = sk[1:] != sk[:-1]
    run_id = torch.cumsum(start, 0) - 1
    counts = torch.bincount(run_id, minlength=n)
    run_keys = torch.where(start, sk, pad_key)
    run_counts = torch.where(start & (run_keys != pad_key), counts[run_id], 0)
    top = torch.sort(run_counts, descending=True, stable=True).indices[:k]
    return run_keys[top], run_counts[top]


def detect_heavy_keys(s_key, group, k: int, threshold: int,
                      pad_key=PAD_S):
    """The global set of up to n * k candidate heavy keys whose global
    count exceeds `threshold`: a sorted (n * k,) key array padded with
    pad_key, the same on every rank of `group`."""
    cand_k, _ = _local_topk_runs(s_key, k, pad_key)
    all_cand = _all_gather(cand_k, group)
    # each candidate's exact count on this shard, summed over the group
    sk = torch.sort(s_key).values
    glob = (torch.searchsorted(sk, all_cand, side="right")
            - torch.searchsorted(sk, all_cand, side="left"))
    dist.all_reduce(glob, group=group)
    heavy = (glob > threshold) & (all_cand != pad_key)
    # dedup (a candidate can come from several ranks) and keep the array
    # sorted, so that searchsorted membership tests stay valid
    so = torch.sort(torch.where(heavy, all_cand, pad_key)).values
    dup = torch.zeros_like(heavy)
    dup[1:] = so[1:] == so[:-1]
    return torch.sort(torch.where(dup, pad_key, so)).values


def _split_by_membership(key, payload, heavy_sorted, pad_key,
                         capacity: int):
    """(heavy rows compacted to `capacity`, their payloads, the light rows
    with the heavy ones keyed pad_key, their payloads, the heavy rows past
    capacity)."""
    pos = torch.searchsorted(heavy_sorted, key).clamp(
        0, heavy_sorted.numel() - 1)
    is_heavy = (heavy_sorted[pos] == key) & (key != pad_key)
    m = is_heavy.long()
    slot = torch.cumsum(m, 0) - m
    ovf = (is_heavy & (slot >= capacity)).sum()
    tgt = torch.where(is_heavy & (slot < capacity), slot, capacity)
    hk = key.new_full((capacity + 1,), pad_key)
    hp = payload.new_zeros(capacity + 1)
    hk[tgt] = key
    hp[tgt] = payload
    lk = torch.where(is_heavy, pad_key, key)
    lp = torch.where(is_heavy, 0, payload)
    return hk[:-1], hp[:-1], lk, lp, ovf


def _heavy_rows(key, heavy_sorted, pad_key):
    """This shard's rows whose key is in heavy_sorted, a 0-dim int64."""
    pos = torch.searchsorted(heavy_sorted, key).clamp(
        0, heavy_sorted.numel() - 1)
    return ((heavy_sorted[pos] == key) & (key != pad_key)).sum()


HEAVY_K = 32          # candidate heavy keys a rank
CAP_HEAVY = 4096      # the heavy buffer's default rows
# bytes the skew tier holds a heavy-buffer row on each rank at most: the
# buffers and the all-gathered R rows (key and payload), then the general
# core's sorted union of them with its int64 scans
_SKEW_BYTES_PER_ROW = 96


def heavy_capacity(rk, sk, group, heavy_threshold: int, limit: int) -> int:
    """The heavy buffer's rows (cap_heavy) that the skew tier needs on
    `group`: the most heavy rows that any rank holds (its S rows, or its R
    rows, under the keys detect_heavy_keys finds with HEAVY_K candidates a
    rank), from one all_reduce (MAX), with an eighth more for margin, at
    least CAP_HEAVY, at most `limit` (the rank's S shard, which holds every
    heavy S row).  The same on every rank.  Raises, with the row count,
    where the tier's buffers would not fit in the free memory of some
    rank's card."""
    heavy = detect_heavy_keys(sk, group, HEAVY_K, heavy_threshold, PAD_S)
    free = (torch.cuda.mem_get_info(sk.device)[0] if sk.is_cuda
            else 1 << 62)
    # one collective: the largest heavy counts and the least free bytes
    t = torch.stack([_heavy_rows(sk, heavy, PAD_S),
                     _heavy_rows(rk, heavy, PAD_R),
                     torch.tensor(-free, device=sk.device)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    need, free = int(t[:2].max()), -int(t[2])
    cap = min(limit, max(CAP_HEAVY, need + need // 8))
    n = dist.get_world_size(group)
    if (n + 2) * cap * _SKEW_BYTES_PER_ROW > free:
        raise RuntimeError(
            f"the skew tier's heavy buffers do not fit: {need} heavy rows "
            f"on a rank, {cap} rows a buffer over {n} ranks, "
            f"{free} bytes free")
    return cap


def dist_join_count_skew_body(rk, rp, sk, sp, group, cap_r: int,
                              cap_s: int, heavy_threshold: int,
                              heavy_k: int = 16, cap_heavy: int = 1024):
    """The skew-aware distributed count join on this rank's shard: returns
    (matches, checksum, overflow), the same on every rank of `group`.  A
    key is heavy when its global count exceeds heavy_threshold."""
    heavy = detect_heavy_keys(sk, group, heavy_k, heavy_threshold, PAD_S)
    # S: heavy rows stay local; R: heavy rows replicate everywhere
    hs_k, hs_p, ls_k, ls_p, ovf_hs = _split_by_membership(
        sk, sp, heavy, PAD_S, cap_heavy)
    hr_k, hr_p, lr_k, lr_p, ovf_hr = _split_by_membership(
        rk, rp, heavy, PAD_R, cap_heavy)
    # the pads never meet: R's -1, S's -2
    heavy_local = mergejoin.merge_join_count_general(
        _all_gather(hr_k, group), _all_gather(hr_p, group), hs_k, hs_p)
    rk2, rp2, ovf_r = shuffle_relation(lr_k, lr_p, group, cap_r, PAD_R)
    sk2, sp2, ovf_s = shuffle_relation(ls_k, ls_p, group, cap_s, PAD_S)
    light_local = mergejoin.merge_join_count(rk2, rp2, sk2, sp2)
    m, c, ovf_h = _all_reduce(
        light_local.matches + heavy_local.matches,
        light_local.checksum + heavy_local.checksum, ovf_hs + ovf_hr,
        groups=(group,))
    return m, c & _U32, ovf_r + ovf_s + ovf_h


def make_dist_join_count_skew(mesh: DeviceMesh, nr_shard: int,
                              ns_shard: int, axis: str = "shard",
                              safety: float = 2.0, heavy_k: int = HEAVY_K,
                              cap_heavy: int = CAP_HEAVY,
                              heavy_threshold: int = 0):
    """The skew-aware distributed join (cf. make_dist_join_count):
    fn(rk, rp, sk, sp) on this rank's shard returns (matches, checksum,
    overflow).  The default heavy threshold follows the light path's
    bucket capacity: a key whose global multiplicity alone could overflow
    a destination bucket must be heavy."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    cap_r = _capacity(nr_shard, n, safety)
    cap_s = _capacity(ns_shard, n, safety)
    if heavy_threshold <= 0:
        heavy_threshold = max(32, cap_s // 8)
    return _shard_call(mesh, functools.partial(
        dist_join_count_skew_body, group=mesh.get_group(axis), cap_r=cap_r,
        cap_s=cap_s, heavy_k=heavy_k, cap_heavy=cap_heavy,
        heavy_threshold=heavy_threshold))
