"""Distributed joins: hash shuffle + shard-local join on every rank
(counterpart of aqp_tpu/parallel/dist_join.py).

Distributed RHO: the first radix pass becomes the inter-rank hash shuffle
(all_to_all over the mesh axis); the local passes and the build and probe
run on each rank (SURVEY.md §2c).  Counts and checksums reduce with
all_reduce, the cross-rank analog of the reference's "sum results over
threads" (radix_join.cpp:1542-1557).  Matches and checksums are
order-invariant sums, so the result equals the single-device engine's for
any mesh size.

Calling convention.  The reference's shard_map bodies are plain functions
of this rank's tensors and a process group here.  The `make_*` builders
return a callable that each rank of the mesh calls with its own shard
(`mesh.shard_relation`); it returns replicated scalars (0-dim int64
tensors, equal on every rank) or, for the materializing join, this rank's
output columns.  The convenience wrappers take whole relations, which
every rank holds, and shard them.  Checksums are summed as int64 across
ranks and reduced mod 2^32: the reference's wrapping uint32 psum.

Engines of the shard-local count ("auto" resolves by the mesh's device):
  "pallas"  the rho3 pipeline, K1, K2 and K3: the CUDA kernels on a card
            (they launch or raise, never fall back), their plain versions
            on the CPU; int32 shards only (int64 ones take the exact
            core), a real key equal to rho3's input pad reported as
            overflow;
  "xla"     the exact sort core, ops/mergejoin.merge_join_count.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from aqp_tpu_torch import check_device
from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.parallel.mesh import (
    CHIP_AXIS, DEFAULT_AXIS, HOST_AXIS, make_mesh, shard_relation)
from aqp_tpu_torch.parallel.shuffle import (
    PAD_R, PAD_S, shuffle_relation, shuffle_relation_hier)
from aqp_tpu_torch.relation import Relation

_U32 = 0xFFFFFFFF


def _resolve_engine(engine: str, device_type: str) -> str:
    """auto -> the rho3 pipeline on a card, the exact core on the CPU."""
    if engine == "auto":
        return "pallas" if device_type == "cuda" else "xla"
    if engine not in ("pallas", "xla"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine


def _capacity(rows_per_shard: int, n: int, safety: float) -> int:
    """A destination bucket's capacity, the static-shape analog of the
    reference's partition padding (radix_join.cpp:339-345)."""
    return max(8, int(rows_per_shard / n * safety))


def _all_reduce(*scalars, groups) -> list:
    """Sum 0-dim int64 tensors over each group in turn, in one collective
    a group; returns them summed."""
    t = torch.stack([s.reshape(()).long() for s in scalars])
    for g in groups:
        dist.all_reduce(t, group=g)
    return list(t.unbind())


def _local_count(rk, rp, sk, sp, engine: str):
    """Shard-local count join.  Returns (matches, checksum, local_overflow)
    as 0-dim int64 tensors.

    engine="pallas" runs the fixed-slot rho3 pipeline, the one the
    single-device RHO serves: the shuffle's pad rows (negative keys) take
    rho3's designated input pads, which K1 drops.  A slot overflow under
    skew is returned for the caller's escalation ladder, never silent.
    So is a real key equal to an input pad (2^30 - 2 or 2^30 - 1), which
    rho3 would drop unseen: each such row counts as local overflow, as
    `joins/radix.holds_input_pads` sends the single-device RHO to the
    exact core.  int64 tensors reach no kernel (`joins/radix.is_key64`):
    they take the exact core under either engine."""
    wide = any(t.dtype == torch.int64 for t in (rk, rp, sk, sp))
    if engine == "pallas" and not wide:
        from aqp_tpu_torch.ops.kernels.rho3 import (
            PAD_R_INPUT, PAD_S_INPUT, rho_join_count_v3)

        real_pads = sum(((k == PAD_R_INPUT) | (k == PAD_S_INPUT)).sum()
                        for k in (rk, sk))
        rk = torch.where(rk < 0, PAD_R_INPUT, rk)
        sk = torch.where(sk < 0, PAD_S_INPUT, sk)
        m, c, ovf = rho_join_count_v3(rk, rp, sk, sp)
        return m, c, ovf + real_pads
    local = mergejoin.merge_join_count(rk, rp, sk, sp)
    return local.matches, local.checksum, torch.zeros_like(local.matches)


def _dist_join_count_body(rk, rp, sk, sp, group, cap_r: int, cap_s: int,
                          salt: int = 0, engine: str = "xla"):
    rk2, rp2, ovf_r = shuffle_relation(rk, rp, group, cap_r, PAD_R, salt=salt)
    sk2, sp2, ovf_s = shuffle_relation(sk, sp, group, cap_s, PAD_S, salt=salt)
    m, c, ovf_l = _local_count(rk2, rp2, sk2, sp2, engine)
    m, c, ovf_l = _all_reduce(m, c, ovf_l, groups=(group,))
    return m, c & _U32, ovf_r + ovf_l, ovf_s


def _shard_call(mesh: DeviceMesh, body):
    """The callable each rank of `mesh` calls with its own shard."""
    def call(rk, rp, sk, sp):
        check_device(mesh.device_type, rk, rp, sk, sp)
        return body(rk, rp, sk, sp)
    return call


def make_dist_join_count(mesh: DeviceMesh, nr_shard: int, ns_shard: int,
                         axis: str = DEFAULT_AXIS, safety: float = 2.0,
                         salt: int = 0, engine: str = "auto"):
    """The distributed count join for the given rows per shard: fn(rk, rp,
    sk, sp) on this rank's shard returns (matches, checksum, overflow_r,
    overflow_s), each the same on every rank.  A destination bucket holds
    (rows per shard / n) * safety rows.  engine: "auto" | "pallas" |
    "xla", the shard-local join (see _local_count)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    return _shard_call(mesh, functools.partial(
        _dist_join_count_body, group=mesh.get_group(axis),
        cap_r=_capacity(nr_shard, n, safety),
        cap_s=_capacity(ns_shard, n, safety), salt=salt,
        engine=_resolve_engine(engine, mesh.device_type)))


# ---------------------------------------------------------------------------
# Ring-rotation join: communication under compute


def _dist_join_count_ring_body(rk, rp, sk, sp, group):
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    # disjoint pad sentinels: shard_relation pads both sides with -1, and
    # no shuffle pack drops negatives here
    sk = torch.where(sk < 0, PAD_S, sk)
    # local S sorted once with a payload prefix sum (the histogram join's
    # counting structure, radix_join.cpp:476-612); each step probes the
    # visiting R block with two binary searches a row
    ks, order = torch.sort(sk)
    spref = torch.cat([torch.zeros(1, dtype=torch.int64, device=sk.device),
                       torch.cumsum(sp[order].long() & _U32, 0)])
    m = torch.zeros((), dtype=torch.int64, device=sk.device)
    ck = torch.zeros_like(m)
    if n > 1:
        nxt = dist.get_global_rank(group, (me + 1) % n)
        prv = dist.get_global_rank(group, (me - 1) % n)
    for t in range(n):
        # post the next block's transfer first: the probe of this block
        # does not depend on it, so the transfer runs under the probe
        if t < n - 1:
            nk, np_ = torch.empty_like(rk), torch.empty_like(rp)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, rk, nxt, group),
                dist.P2POp(dist.isend, rp, nxt, group),
                dist.P2POp(dist.irecv, nk, prv, group),
                dist.P2POp(dist.irecv, np_, prv, group)])
        lo = torch.searchsorted(ks, rk, side="left")
        hi = torch.searchsorted(ks, rk, side="right")
        valid = rk >= 0
        mult = torch.where(valid, hi - lo, 0)
        m += mult.sum()
        ck += (mult * (rp.long() & _U32)
               + torch.where(valid, spref[hi] - spref[lo], 0)).sum()
        if t < n - 1:
            for r in reqs:
                r.wait()
            rk, rp = nk, np_
    m, ck = _all_reduce(m, ck & _U32, groups=(group,))
    return m, ck & _U32


def make_dist_join_count_ring(mesh: DeviceMesh, axis: str = DEFAULT_AXIS):
    """Overlapped ring join: R rotates around the `axis` ring while each
    rank joins the resident R block against its local S.  fn(rk, rp, sk,
    sp) returns (matches, checksum), the same on every rank.

    Step t posts the send of its block and the receive of the next before
    it probes, so the transfer runs under the probe (the SWWC analog,
    radix_join.cpp:1010-1055).  No capacities, no overflow: every R block
    meets every S shard once, so the count is exact for any key
    distribution (the broadcast-join analog for a small R).  n - 1
    transfers; at n = 1 none (the rotation is the identity)."""
    return _shard_call(mesh, functools.partial(
        _dist_join_count_ring_body, group=mesh.get_group(axis)))


def dist_join_count_ring(relR: Relation, relS: Relation,
                         mesh: Optional[DeviceMesh] = None,
                         axis: str = DEFAULT_AXIS):
    """Convenience wrapper: returns (matches, checksum)."""
    mesh = mesh or make_mesh(axis=axis, device=relR.device)
    R = shard_relation(relR, mesh, axis)
    S = shard_relation(relS, mesh, axis)
    return make_dist_join_count_ring(mesh, axis)(R.key, R.payload, S.key,
                                                  S.payload)


def dist_join_count(relR: Relation, relS: Relation,
                    mesh: Optional[DeviceMesh] = None,
                    axis: str = DEFAULT_AXIS):
    """Convenience wrapper: shard, shuffle, join, reduce.  Returns
    (matches, checksum, overflow_r, overflow_s)."""
    mesh = mesh or make_mesh(axis=axis, device=relR.device)
    R = shard_relation(relR, mesh, axis)
    S = shard_relation(relS, mesh, axis)
    fn = make_dist_join_count(mesh, R.num_tuples, S.num_tuples, axis)
    return fn(R.key, R.payload, S.key, S.payload)


# Salt ladder for shuffle-overflow retries: distinct keys that collide into
# one destination under one mixer salt spread under another.  True heavy
# hitters (single-key mass) overflow under every salt; they go to the skew
# tier (parallel/skew.py), the replacement for the reference's dynamic task
# stealing (radix_join.cpp:1086-1335).
SHUFFLE_SALTS = (0, 0x5BD1E995, 0x27D4EB2F)


def make_skew_tier(mesh: DeviceMesh, R: Relation, S: Relation,
                   axis: str = DEFAULT_AXIS, safety: float = 2.0,
                   skew_threshold: float = 8.0):
    """auto's last tier for this rank's shards R and S: the skew-aware
    join (parallel/skew.py) with a key heavy when its global S mass passes
    skew_threshold times the mean rows a key (|S| / |R|, the analog of the
    reference's MWAY skew constants, joincommon.h:25-29), its heavy buffer
    sized from the heavy rows a rank holds (skew.heavy_capacity: heavy S
    rows stay on their rank, and make_dist_join_count_skew's default of
    4,096 rows overflows on a rank holding more).  Every rank of the mesh
    calls it.  Returns (fn, cap_heavy)."""
    from aqp_tpu_torch.parallel.skew import (
        heavy_capacity, make_dist_join_count_skew)

    n = mesh.size(mesh.mesh_dim_names.index(axis))
    nr_s, ns_s = R.num_tuples, S.num_tuples
    heavy_threshold = max(32, int(skew_threshold * ns_s * n
                                  / max(1, nr_s * n)))
    cap_heavy = heavy_capacity(R.key, S.key, mesh.get_group(axis),
                               heavy_threshold, limit=ns_s)
    return make_dist_join_count_skew(
        mesh, nr_s, ns_s, axis, safety, heavy_threshold=heavy_threshold,
        cap_heavy=cap_heavy), cap_heavy


def dist_join_count_auto(relR: Relation, relS: Relation,
                         mesh: Optional[DeviceMesh] = None,
                         axis: str = DEFAULT_AXIS, safety: float = 2.0,
                         skew_threshold: float = 8.0):
    """Distributed count join with automatic overflow recovery.

    Ladder: hash shuffle, salted re-shuffles (x2), the exact core at salt 0
    where the shard-local engine is the rho3 pipeline (a slot overflow is
    local skew the exact core absorbs without re-salting), then the
    skew-aware heavy-hitter join (make_skew_tier).  Every tier reports
    overflow 0 or escalates: the answer is never silently wrong.  Returns
    (matches, checksum, tier) as Python ints and "hash", "hash+salt" or
    "skew"; each rank takes the same decisions (the overflows are
    replicated).  Raises on overflow beyond every tier."""
    mesh = mesh or make_mesh(axis=axis, device=relR.device)
    R = shard_relation(relR, mesh, axis)
    S = shard_relation(relS, mesh, axis)
    nr_s, ns_s = R.num_tuples, S.num_tuples
    eng = _resolve_engine("auto", mesh.device_type)
    tiers = [(s, eng) for s in SHUFFLE_SALTS]
    if eng != "xla":
        tiers.append((SHUFFLE_SALTS[0], "xla"))
    for i, (salt, engine) in enumerate(tiers):
        fn = make_dist_join_count(mesh, nr_s, ns_s, axis, safety, salt=salt,
                                  engine=engine)
        m, ck, ovf_r, ovf_s = fn(R.key, R.payload, S.key, S.payload)
        if int(ovf_r) == 0 and int(ovf_s) == 0:
            return int(m), int(ck), ("hash" if i == 0 else "hash+salt")
    fn, _ = make_skew_tier(mesh, R, S, axis, safety, skew_threshold)
    m, ck, ovf = fn(R.key, R.payload, S.key, S.payload)
    if int(ovf) != 0:
        raise RuntimeError(
            f"distributed join overflow beyond every tier: {int(ovf)} rows")
    return int(m), int(ck), "skew"


# ---------------------------------------------------------------------------
# Two-axis (host x chip) distributed join


def _dist_join_count_2d_body(rk, rp, sk, sp, host_group, chip_group,
                             cap_hr, cap_cr, cap_hs, cap_cs, salt: int = 0,
                             engine: str = "xla"):
    rk2, rp2, ovf_r = shuffle_relation_hier(
        rk, rp, host_group, chip_group, cap_hr, cap_cr, PAD_R, salt=salt)
    sk2, sp2, ovf_s = shuffle_relation_hier(
        sk, sp, host_group, chip_group, cap_hs, cap_cs, PAD_S, salt=salt)
    m, c, ovf_l = _local_count(rk2, rp2, sk2, sp2, engine)
    m, c, ovf_l = _all_reduce(m, c, ovf_l, groups=(host_group, chip_group))
    return m, c & _U32, ovf_r + ovf_l, ovf_s


def make_dist_join_count_2d(mesh: DeviceMesh, nr_shard: int, ns_shard: int,
                            host_axis: str = HOST_AXIS,
                            chip_axis: str = CHIP_AXIS,
                            safety: float = 2.0, salt: int = 0,
                            engine: str = "auto"):
    """The join over a (host x chip) mesh with the two-level shuffle
    (SURVEY.md §2c rows 5/8): fn(rk, rp, sk, sp) on this rank's shard (rows
    sharded over both axes) returns (matches, checksum, overflow_r,
    overflow_s).  Level-1 capacity: rows / nh a host; level 2: what a host
    received, over nc; both padded by `safety`."""
    names = mesh.mesh_dim_names
    nh = mesh.size(names.index(host_axis))
    nc = mesh.size(names.index(chip_axis))
    cap_hr = _capacity(nr_shard, nh, safety)
    cap_cr = _capacity(cap_hr * nh, nc, safety)
    cap_hs = _capacity(ns_shard, nh, safety)
    cap_cs = _capacity(cap_hs * nh, nc, safety)
    return _shard_call(mesh, functools.partial(
        _dist_join_count_2d_body, host_group=mesh.get_group(host_axis),
        chip_group=mesh.get_group(chip_axis), cap_hr=cap_hr, cap_cr=cap_cr,
        cap_hs=cap_hs, cap_cs=cap_cs, salt=salt,
        engine=_resolve_engine(engine, mesh.device_type)))


def dist_join_count_2d(relR: Relation, relS: Relation, mesh: DeviceMesh):
    """Convenience wrapper for the two-axis mesh."""
    R = shard_relation(relR, mesh)
    S = shard_relation(relS, mesh)
    fn = make_dist_join_count_2d(mesh, R.num_tuples, S.num_tuples)
    return fn(R.key, R.payload, S.key, S.payload)


# ---------------------------------------------------------------------------
# Distributed materializing join


def _dist_join_mat_body(rk, rp, sk, sp, group, cap_r, cap_s, out_cap,
                        salt: int = 0):
    rk2, rp2, ovf_r = shuffle_relation(rk, rp, group, cap_r, PAD_R, salt=salt)
    sk2, sp2, ovf_s = shuffle_relation(sk, sp, group, cap_s, PAD_S, salt=salt)
    out = mergejoin.merge_join_materialize(rk2, rp2, sk2, sp2, out_cap)
    ovf_out = (out.matches - out_cap).clamp(min=0)
    m, c, ovf_out = _all_reduce(out.matches, out.checksum, ovf_out,
                                groups=(group,))
    return (m, c & _U32, out.key, out.r_payload, out.s_payload,
            ovf_r + ovf_s + ovf_out)


def make_dist_join_materialize(mesh: DeviceMesh, nr_shard: int,
                               ns_shard: int, axis: str = DEFAULT_AXIS,
                               safety: float = 2.0, salt: int = 0):
    """Distributed materializing join: hash shuffle + the exact core's
    materialize on each rank.  fn(rk, rp, sk, sp) returns (matches,
    checksum, key, r_payload, s_payload, overflow): the scalars the same on
    every rank, the columns this rank's, ns_shard * safety long (the
    matches of its key range, the analog of the reference's per-thread
    chunked tables, ChunkedTable.cpp:146-171), unused slots keyed -3 (< 0)
    with payloads 0.  Overflow (shuffle drops or output capacity) is
    reported, never silent."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    return _shard_call(mesh, functools.partial(
        _dist_join_mat_body, group=mesh.get_group(axis),
        cap_r=_capacity(nr_shard, n, safety),
        cap_s=_capacity(ns_shard, n, safety),
        out_cap=max(8, int(ns_shard * safety)), salt=salt))


def dist_join_materialize(relR: Relation, relS: Relation,
                          mesh: Optional[DeviceMesh] = None,
                          axis: str = DEFAULT_AXIS, safety: float = 2.0):
    """Convenience wrapper.  Returns (matches, checksum, key, r_payload,
    s_payload, overflow); the columns are this rank's."""
    mesh = mesh or make_mesh(axis=axis, device=relR.device)
    R = shard_relation(relR, mesh, axis)
    S = shard_relation(relS, mesh, axis)
    fn = make_dist_join_materialize(mesh, R.num_tuples, S.num_tuples, axis,
                                    safety)
    return fn(R.key, R.payload, S.key, S.payload)
