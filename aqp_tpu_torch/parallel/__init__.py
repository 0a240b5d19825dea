"""The distributed layer on torch.distributed (counterpart of
aqp_tpu/parallel): meshes, bring-up, the hash shuffle, the distributed
joins and the skew tier."""

from aqp_tpu_torch.parallel.mesh import make_mesh, shard_relation
from aqp_tpu_torch.parallel.dist_join import dist_join_count

__all__ = ["make_mesh", "shard_relation", "dist_join_count"]
