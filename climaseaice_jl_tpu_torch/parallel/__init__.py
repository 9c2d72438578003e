"""Distributed stepping over ``torch.distributed`` (counterpart of
`climaseaice_jl_tpu/parallel`): the mesh of ranks, the distributed step,
the moves between global states and the ranks' shards, and a launcher of
local ranks."""

from .stepper import (ProcessMesh, make_mesh, make_distributed_step, strip_halos,
                      unstrip_halos)
from .multihost import (initialize, process_index, process_count, default_device,
                        shard_state, gather_state, save_rank_snapshot,
                        reassemble_rank_snapshots, save_sharded_checkpoint,
                        load_sharded_checkpoint)

__all__ = ["ProcessMesh", "make_mesh", "make_distributed_step", "strip_halos",
           "unstrip_halos", "initialize", "process_index", "process_count", "default_device",
           "shard_state", "gather_state", "save_rank_snapshot", "reassemble_rank_snapshots",
           "save_sharded_checkpoint", "load_sharded_checkpoint"]
