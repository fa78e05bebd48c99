"""The grid-sharded step (the z shards of one map, driven by one process or
one shard a process) and the streams' step (one detector state per sensor
stream).

comm.LocalComm (the shards' threads, streams and collectives) and
comm.ProcessComm (one shard a process, the same collectives over
torch.distributed), gridops.ZShardOps (the sharded grid primitives),
grid_step (make_grid_sharded_step, shard_state, gather_state; the 2-D
streams x grid fleet's make_fleet_grid_step and its state's numpy form);
sharding (make_batched_step, init_batched_state, the batched state's numpy
form, which runtime/fleet.py serves).  The submodules are imported by name:
the stage code imports gridops, and grid_step and sharding import the step.
"""
