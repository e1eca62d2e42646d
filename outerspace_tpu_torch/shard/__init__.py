"""The sharded mode on ``torch.distributed``: the mesh of ranks and its
launcher (``shard.mesh``), the flat-expand sharded SpGEMM in 1-D and 2-D
(``shard.spgemm_sharded``) and the tiled one, global or rebased keys
(``shard.tiled``), each an SPMD function every rank of the mesh runs,
exchanging partial products with its row owners by all_to_all; the
device-resident Markov clustering loop (``shard.mcl``), the dp × tp MLP1
training step (``shard.train``), the jobs a launched rank runs
(``shard.world``) and the multi-device dry run (``shard.dryrun``)."""

from outerspace_tpu_torch.shard.mesh import Mesh, make_mesh, run_world  # noqa: F401
from outerspace_tpu_torch.shard.spgemm_sharded import (  # noqa: F401
    shard_plan,
    spgemm_sharded,
)
from outerspace_tpu_torch.shard.tiled import (  # noqa: F401
    shard_plan_tiled,
    sharded_tiled_to_csr,
    spgemm_sharded_tiled,
)
from outerspace_tpu_torch.shard.mcl import markov_cluster_sharded_device  # noqa: F401
