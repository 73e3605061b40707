"""Known-clean: specs consistent with the module's declared mesh axes,
multi-axis dims as tuples, and a donation whose in/out shardings
match (the buffer can alias). Variable axis names are never judged —
a module building specs for a caller-provided mesh stays silent."""

from functools import partial

from hpc_patterns_tpu_torch.models.sharding_util import shard_at
from hpc_patterns_tpu_torch.topology import make_mesh
from hpc_patterns_tpu_torch.models.sharding import sharded


def build(x, coord, cfg):
    mesh = make_mesh({"dp": 2, "tp": 4})
    batch = shard_at(x, ("dp", None), mesh, coord)
    fused = shard_at(x, (("dp", "tp"), None), mesh, coord)
    by_cfg = shard_at(x, (cfg.axis, None), mesh, coord)  # variable: unjudged
    return batch, fused, by_cfg


@partial(sharded, inplace_argnums=(0,),
         in_specs=(("dp", None),),
         out_specs=(("dp", None), ("tp", None)))
def aliasable_inplace(x):
    return x * 2, x.sum(axis=0, keepdims=True)
