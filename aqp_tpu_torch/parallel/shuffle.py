"""Hash shuffle: the distributed radix-partition pass (counterpart of
aqp_tpu/parallel/shuffle.py).

Each rank buckets its rows by destination (`partition_hash` of the key
over the group's size), packs them into fixed-capacity per-destination send
buffers (the capacity plays the reference's partition padding,
prj_params.h:94), and one `all_to_all_single` routes them: NCCL between
cards, gloo between CPU ranks.

Rows are (key, payload) pairs; unused buffer slots carry sentinel keys that
never match (PAD_R = -1 on the build side, PAD_S = -2 on the probe side).
The overflow count reports the rows dropped where a destination bucket
exceeds its capacity; callers size capacity with a safety factor and
re-shuffle under another salt, then take the skew tier (parallel/skew.py).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from aqp_tpu_torch.ops.hashing import partition_hash

PAD_R = -1
PAD_S = -2


def _dest_bits(n_dest: int) -> int:
    return max(1, (n_dest - 1).bit_length())


def destination(key, n_dest: int, salt: int = 0):
    """The group rank that owns each key: its hash bucket mod n_dest."""
    return partition_hash(key, _dest_bits(n_dest), salt=salt) % n_dest


def _pack_send_buffers(key, payload, n_dest: int, capacity: int, pad_key,
                       salt: int):
    """Bucket local rows by hash destination into (n_dest, capacity)
    buffers: the destination, then _pack_by_dest."""
    return _pack_by_dest(key, payload, destination(key, n_dest, salt),
                         n_dest, capacity, pad_key)


def _pack_by_dest(key, payload, dest, n_dest: int, capacity: int, pad_key):
    """Pack rows into per-destination send buffers given each row's
    destination.  A stable sort by destination reorders the rows; a row's
    slot is its position less its destination's start (the histogram
    prefix, the reference's exchange-plan idiom, radix_join.cpp:886-931).
    Returns (keys (n_dest, capacity), payloads, overflow as a 0-dim int64):
    each destination's rows in their input order, then pad_key / 0.

    Every negative key is dropped, not only this side's pad: every sentinel
    is negative (PAD_R -1, PAD_S -2, materialized holes -3, shard_relation's
    padding) and no generator or TPC-H key is, so a padded row of the other
    side never meets a receive buffer's pad slot."""
    n = key.numel()
    dev = key.device
    drop = (key == pad_key) | (key < 0)
    dest = torch.where(drop, n_dest, dest)
    # the destination in the narrowest type that holds n_dest: fewer radix
    # passes for the same stable order
    narrow = torch.uint8 if n_dest < 255 else torch.int32
    d, order = torch.sort(dest.to(narrow), stable=True)
    d = d.long()
    k, p = key[order], payload[order]
    hist = torch.bincount(d, minlength=n_dest + 1)
    starts = torch.cumsum(hist, 0) - hist
    slot = torch.arange(n, device=dev) - starts[d]
    live = d < n_dest
    in_cap = live & (slot < capacity)
    overflow = (live & (slot >= capacity)).sum()
    trash = n_dest * capacity
    flat = torch.where(in_cap, d * capacity + slot, trash)
    buf_k = torch.full((trash + 1,), pad_key, dtype=key.dtype, device=dev)
    buf_p = torch.zeros((trash + 1,), dtype=payload.dtype, device=dev)
    buf_k[flat] = k
    buf_p[flat] = p
    return (buf_k[:-1].view(n_dest, capacity),
            buf_p[:-1].view(n_dest, capacity), overflow)


def _exchange(buf: torch.Tensor, group) -> torch.Tensor:
    """all_to_all of (n, capacity) buffers: row i goes to group rank i, and
    row j of the result came from group rank j.  Returns it flat."""
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out.view(-1)


def shuffle_relation(key, payload, group, capacity: int, pad_key,
                     salt: int = 0):
    """Route this rank's rows to the rank of `group` owning hash(key).

    Returns (key[n * capacity], payload[n * capacity], overflow): the rows
    now resident on this rank (padded with pad_key) and the rows dropped on
    every rank of the group (summed, the same on each)."""
    n = dist.get_world_size(group)
    bk, bp, ovf = _pack_send_buffers(key, payload, n, capacity, pad_key,
                                     salt)
    dist.all_reduce(ovf, group=group)
    return _exchange(bk, group), _exchange(bp, group), ovf


def shuffle_relation_hier(key, payload, host_group, chip_group,
                          cap_host: int, cap_chip: int, pad_key,
                          salt: int = 0):
    """Two-level shuffle over a (host x chip) mesh: pass 1 routes rows to
    the owning HOST over the host axis (destination = the hash bucket's
    high part), pass 2 within the host to the owning CHIP: the cluster
    analog of the reference's 2-pass radix partition
    (radix_join.cpp:319-329), the slow exchange moving each row once.

    A key's owner is mesh position (dest // nc, dest % nc), dest =
    partition_hash(key) % (nh * nc), the same for every sender.  Returns
    (key, payload, overflow): overflow counts the rows dropped at either
    level on every rank."""
    nh = dist.get_world_size(host_group)
    nc = dist.get_world_size(chip_group)
    dest = destination(key, nh * nc, salt)
    bk, bp, ovf1 = _pack_by_dest(key, payload, dest // nc, nh, cap_host,
                                 pad_key)
    k1, p1 = _exchange(bk, host_group), _exchange(bp, host_group)
    dest2 = destination(k1, nh * nc, salt) % nc
    bk2, bp2, ovf2 = _pack_by_dest(k1, p1, dest2, nc, cap_chip, pad_key)
    ovf = ovf1 + ovf2
    dist.all_reduce(ovf, group=host_group)
    dist.all_reduce(ovf, group=chip_group)
    return _exchange(bk2, chip_group), _exchange(bp2, chip_group), ovf
