"""The port's side of tests/test_torch_parallel.py: what every gloo rank
runs, importable by name in the spawned processes (this module imports
torch and aqp_tpu_torch only, never jax).

`run_cases(rank, world, inputs)` brings nothing up itself (bringup.
spawn_ranks did) and returns, per case, this rank's results as Python ints
and numpy arrays."""

from __future__ import annotations

import numpy as np

from aqp_tpu_torch.parallel import bringup, dist_join as dj, shuffle
from aqp_tpu_torch.parallel import skew
from aqp_tpu_torch.parallel.mesh import (make_mesh, make_mesh_2d,
                                         shard_relation)
from aqp_tpu_torch.relation import Relation

SAFETY = 2.0
HEAVY_K = 32


def relation(cols) -> Relation:
    return Relation.from_numpy(cols[0], cols[1], device="cpu")


def ints(*ts) -> tuple:
    return tuple(int(t) for t in ts)


def live(key, rp, sp) -> np.ndarray:
    """The live (key, R payload, S payload) rows, sorted."""
    k = key.numpy()
    t = np.stack([k, rp.numpy(), sp.numpy()], 1)[k >= 0].astype(np.int64)
    return t[np.lexsort(t.T[::-1])]


def capacities(nr: int, ns: int, n: int) -> tuple:
    """The shuffle's bucket capacities for relations of nr and ns rows
    sharded over n ranks."""
    per = lambda rows: -(-rows // n)   # noqa: E731
    return (dj._capacity(per(nr), n, SAFETY),
            dj._capacity(per(ns), n, SAFETY))


def run_cases(rank: int, world: int, inputs: dict) -> dict:
    mesh = make_mesh(world, device="cpu")
    rel = {name: (relation(c[:2]), relation(c[2:]))
           for name, c in inputs.items()}
    out = {}

    r, s = rel["fk"]
    R, S = shard_relation(r, mesh), shard_relation(s, mesh)
    for engine in ("xla", "pallas"):
        fn = dj.make_dist_join_count(mesh, R.num_tuples, S.num_tuples,
                                     engine=engine)
        out[f"count {engine}"] = ints(*fn(R.key, R.payload, S.key,
                                          S.payload))
    out["count nondivisible"] = ints(*dj.dist_join_count(*rel["nd1"], mesh))
    out["overflow z=1.25"] = ints(*dj.dist_join_count(*rel["z125"], mesh))
    if world % 2 == 0 and world >= 4:
        mesh2 = make_mesh_2d(2, world // 2, device="cpu")
        out["2d"] = ints(*dj.dist_join_count_2d(*rel["fk2d"], mesh2))
    m, c, key, rp, sp, ovf = dj.dist_join_materialize(*rel["mat"], mesh)
    out["materialize"] = ints(m, c, ovf) + (live(key, rp, sp),)
    out["ring"] = ints(*dj.dist_join_count_ring(*rel["ring"], mesh))
    out["ring nondivisible"] = ints(*dj.dist_join_count_ring(*rel["nd2"],
                                                             mesh))
    r, z = rel["z14"]
    R, Z = shard_relation(r, mesh), shard_relation(z, mesh)
    fn = skew.make_dist_join_count_skew(mesh, R.num_tuples, Z.num_tuples)
    out["skew z=1.4"] = ints(*fn(R.key, R.payload, Z.key, Z.payload))
    if world == 8:
        out["auto z=1.5"] = dj.dist_join_count_auto(*rel["z15"], mesh)

    # the shuffle's receive buffers and the heavy-key set of this rank
    r, s = rel["nd1"][0], rel["z125"][1]
    R, S = shard_relation(r, mesh), shard_relation(s, mesh)
    cap_r, cap_s = capacities(r.num_tuples, s.num_tuples, world)
    group = mesh.get_group("shard")
    rk, rp_, ovf_r = shuffle.shuffle_relation(R.key, R.payload, group,
                                              cap_r, shuffle.PAD_R)
    sk, sp_, ovf_s = shuffle.shuffle_relation(S.key, S.payload, group,
                                              cap_s, shuffle.PAD_S)
    out["shard"] = (R.key.numpy(), R.payload.numpy())
    out["shuffle"] = (rk.numpy(), rp_.numpy(), int(ovf_r), sk.numpy(),
                      sp_.numpy(), int(ovf_s))
    z = rel["z14"][1]
    Z = shard_relation(z, mesh)
    _, cap_z = capacities(z.num_tuples, z.num_tuples, world)
    out["heavy"] = skew.detect_heavy_keys(
        Z.key, group, HEAVY_K, max(32, cap_z // 8)).numpy()
    return out


def truth_pk(rk, rp, sk, sp) -> tuple:
    """(matches, checksum) of unique R keys against S, in numpy: each S row
    meets the R row of its key, the checksum the sum of both payloads' low
    32 bits mod 2^32."""
    order = np.argsort(rk)
    at = np.clip(np.searchsorted(rk[order], sk), 0, rk.size - 1)
    hit = rk[order][at] == sk
    ck = ((rp[order][at][hit].astype(np.int64) & 0xFFFFFFFF).sum()
          + (sp[hit].astype(np.int64) & 0xFFFFFFFF).sum())
    return int(hit.sum()), int(ck) & 0xFFFFFFFF


def auto_case(rank: int, world: int, cols) -> tuple:
    """dist_join_count_auto over every rank of the group, on the whole
    relations (R keys, R payloads, S keys, S payloads)."""
    mesh = make_mesh(world, device="cpu")
    return dj.dist_join_count_auto(relation(cols[:2]), relation(cols[2:]),
                                   mesh)


def broken_ring_rank(rank: int, world: int, *args) -> list:
    """experiments/dist_forms.run_rank with rank 1's ring answering one
    match too many: that rank's check must fail."""
    from aqp_tpu_torch.experiments import dist_forms

    if rank == 1:
        make = dj.make_dist_join_count_ring

        def broken(*a, **k):
            fn = make(*a, **k)

            def call(*x):
                m, c = fn(*x)
                return m + 1, c
            return call
        dj.make_dist_join_count_ring = broken
    return dist_forms.run_rank(rank, world, *args)


def spawn_cases(world: int, inputs: dict) -> list:
    """run_cases on `world` gloo ranks; each rank's results in rank order."""
    return bringup.spawn_ranks(run_cases, world, (inputs,), timeout_s=240.0)


def _kernel_called(*args, **kw):
    raise AssertionError("a kernel wrapper was called")


def pad_key_cases(rank: int, world: int, name: str, cols) -> dict:
    """The shard-local "pallas" engine (1-D and 2-D, and "auto" resolved
    as on a card: "pallas") beside "xla" on one relation pair: "pads",
    int32 relations holding real keys equal to rho3's input pads, or
    "wide", int64 relations, with every rho3 kernel wrapper made to
    raise (no int64 tensor may reach one)."""
    from aqp_tpu_torch.ops.kernels import rho3

    mesh = make_mesh(world, device="cpu")
    mesh2 = make_mesh_2d(1, world, device="cpu")
    dj._resolve_engine = lambda engine, device_type: (
        "pallas" if engine == "auto" else engine)
    if name == "wide":
        for attr in ("k1", "k2", "k3", "k3m"):
            setattr(rho3, attr, _kernel_called)
    r, s = relation(cols[:2]), relation(cols[2:])
    R, S = shard_relation(r, mesh), shard_relation(s, mesh)
    out = {}
    for engine in ("pallas", "xla"):
        fn = dj.make_dist_join_count(mesh, R.num_tuples, S.num_tuples,
                                     engine=engine)
        out[engine] = ints(*fn(R.key, R.payload, S.key, S.payload))
    R2, S2 = shard_relation(r, mesh2), shard_relation(s, mesh2)
    fn = dj.make_dist_join_count_2d(mesh2, R2.num_tuples, S2.num_tuples,
                                    engine="pallas")
    out["2d pallas"] = ints(*fn(R2.key, R2.payload, S2.key, S2.payload))
    out["auto"] = dj.dist_join_count_auto(r, s, mesh)
    return out


def spawn_pad_key_cases(world: int, name: str, cols) -> list:
    """pad_key_cases on `world` gloo ranks, in rank order."""
    return bringup.spawn_ranks(pad_key_cases, world, (name, cols),
                               timeout_s=240.0)


def fail_on_rank_one(rank: int, world: int):
    if rank == 1:
        raise ValueError("rank one fails")
    return rank


def bringup_cluster(rank: int, world: int, how: str) -> tuple:
    """On a one-process group that spawn_ranks brought up from the
    arguments: its world size and backend, a second call (a no-op), or
    (how="environment") the group made again from AQP_COORDINATOR /
    AQP_NUM_PROCS / AQP_PROC_ID on a port bound now; then a join on the
    group's mesh.  Returns (world size, backend, matches, checksum,
    overflows)."""
    import os

    import torch.distributed as dist

    if how == "environment":
        dist.destroy_process_group()
        os.environ.update(AQP_COORDINATOR=f"127.0.0.1:{bringup.free_port()}",
                          AQP_NUM_PROCS="1", AQP_PROC_ID="0")
        n = bringup.initialize_distributed()
    else:   # the group is up: the call returns its size, no port is read
        n = bringup.initialize_distributed("127.0.0.1:1", 1, 0)
    k = np.arange(1, 257, dtype=np.int32)
    r = Relation.from_numpy(k, k * 3, device="cpu")
    s = Relation.from_numpy(np.tile(k, 4), np.tile(k, 4), device="cpu")
    m, ck, ovf_r, ovf_s = dj.dist_join_count(r, s, make_mesh(device="cpu"))
    return (n, dist.get_world_size(), dist.get_backend()) + ints(
        m, ck, ovf_r, ovf_s)


def hang(rank: int, world: int):
    import time

    time.sleep(3600)
