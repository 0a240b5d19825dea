"""Device meshes and relation sharding on torch.distributed (counterpart of
aqp_tpu/parallel/mesh.py).

One process is one rank and holds one device (a card, or the CPU under
gloo).  The reference's `jax.sharding.Mesh` becomes a
`torch.distributed.device_mesh.DeviceMesh` with the reference's axis names;
a named axis's collectives run on `mesh.get_group(name)`.  The intra-host
axis (CHIP_AXIS) rides NVLink, the inter-host axis (HOST_AXIS) the network:
the analog of the reference's NUMA-local and cross-NUMA layers.

Every rank of the process group calls `make_mesh` / `make_mesh_2d` (a
sub-group is made collectively); a rank past the mesh's size is in no
position of it (`get_coordinate()` is None) and takes no part in its
joins.  `shard_relation` hands each rank its own row block of a relation
that every rank holds whole.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from aqp_tpu_torch import check_device, resolve_device
from aqp_tpu_torch.relation import Relation

DEFAULT_AXIS = "shard"
HOST_AXIS = "host"   # inter-host axis: collectives ride the network
CHIP_AXIS = "chip"   # intra-host axis: collectives ride NVLink


def _world(device) -> tuple:
    """(device type, world size) of the initialized default group."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "aqp_tpu_torch.parallel.bringup.initialize_distributed (or "
            "torch.distributed.init_process_group) on every rank first")
    return dev.type, dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, axis: str = DEFAULT_AXIS,
              device="cuda") -> DeviceMesh:
    """A 1-D mesh over ranks 0 .. n_devices - 1 (default: every rank)."""
    dev_type, world = _world(device)
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    return DeviceMesh(dev_type, torch.arange(n), mesh_dim_names=(axis,))


def _local_devices(dev_type: str, world: int) -> int:
    """Ranks on this host: its cards, or (CPU ranks) the whole world."""
    return torch.cuda.device_count() if dev_type == "cuda" else world


def make_mesh_2d(n_hosts: Optional[int] = None,
                 chips_per_host: Optional[int] = None,
                 axes=(HOST_AXIS, CHIP_AXIS), device="cuda") -> DeviceMesh:
    """Two-axis (host x chip) mesh, the topology analog of the reference's
    NUMA layer.  Ranks are laid out process-major, rank = h * nc + c, as
    launchers number them host by host: each row of the grid is one host,
    the chip axis intra-host, the host axis across hosts.  n_hosts
    defaults to the world size over this host's devices."""
    dev_type, world = _world(device)
    if n_hosts is None:
        n_hosts = max(1, world // max(1, _local_devices(dev_type, world)))
    if chips_per_host is None:
        chips_per_host = world // n_hosts
    n = n_hosts * chips_per_host
    if not 1 <= n <= world:
        raise ValueError(f"a {n_hosts} x {chips_per_host} mesh in a world "
                         f"of {world}")
    return DeviceMesh(dev_type, torch.arange(n).view(n_hosts,
                                                     chips_per_host),
                      mesh_dim_names=tuple(axes))


def _shard_index(mesh: DeviceMesh, axis: Optional[str] = None) -> tuple:
    """(this rank's block index, block count): over every axis jointly
    (row-major in the mesh's shape) for axis=None, else over `axis`."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    if axis is not None:
        return mesh.get_local_rank(axis), mesh.size(
            mesh.mesh_dim_names.index(axis))
    index = 0
    for c, size in zip(coord, mesh.shape):
        index = index * size + c
    return index, mesh.size()


def row_block(rel: Relation, i: int, n: int) -> tuple:
    """(key, payload) of row block i of n of `rel`, padded at the end with
    key -1 and payload 0 to ceil(|rel| / n) rows."""
    rows = -(-rel.num_tuples // n)
    lo, hi = min(i * rows, rel.num_tuples), min((i + 1) * rows,
                                                rel.num_tuples)
    pad = rows - (hi - lo)
    key, payload = rel.key[lo:hi], rel.payload[lo:hi]
    if pad:
        key = torch.cat([key, key.new_full((pad,), -1)])
        payload = torch.cat([payload, payload.new_zeros(pad)])
    return key.contiguous(), payload.contiguous()


def shard_relation(rel: Relation, mesh: DeviceMesh,
                   axis: Optional[str] = None) -> Relation:
    """This rank's contiguous row block of `rel` (which every rank holds
    whole), padded at the end with key -1 and payload 0 to a multiple of
    the shard count: the block a NamedSharding gives device i.  Every
    shuffle and join stage drops the negative keys.  axis=None shards
    over all of the mesh's axes jointly; an explicit axis shards over it
    alone (the other axes hold the same blocks)."""
    check_device(mesh.device_type, rel.key, rel.payload)
    return Relation(*row_block(rel, *_shard_index(mesh, axis)))
