"""Known-bad: PartitionSpec literals inconsistent with the module.

Three shapes: an axis name the module's own mesh never declared (a
typo jax only rejects when the spec finally meets the mesh — often on
the chip); one axis named twice in a single spec (jax rejects it at
run time); and a donated jit arg whose in-sharding matches no
out-sharding (XLA cannot alias a resharded buffer: the input still
dies, the memory saving silently doesn't happen)."""

from functools import partial

from hpc_patterns_tpu_torch.models.sharding_util import shard_at
from hpc_patterns_tpu_torch.topology import make_mesh
from hpc_patterns_tpu_torch.models.sharding import sharded


def build(x, coord):
    mesh = make_mesh({"dp": 2, "tp": 4})
    batch = shard_at(x, ("dp", None), mesh, coord)
    typo = shard_at(x, ("pp", None), mesh, coord)  # EXPECT: spec-mismatch
    doubled = shard_at(x, ("dp", "dp"), mesh, coord)  # EXPECT: spec-mismatch
    return batch, typo, doubled


@partial(sharded, inplace_argnums=(0,),
         in_specs=(("dp", None),),  # EXPECT: spec-mismatch
         out_specs=(("tp", None),))
def resharding_inplace(x):
    return x.mul_(2)
