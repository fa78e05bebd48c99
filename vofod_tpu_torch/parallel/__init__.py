"""The grid-sharded step (one process drives the z shards of one map) and
the streams' step (one detector state per sensor stream).

comm.LocalComm (the shards' threads, streams and collectives),
gridops.ZShardOps (the sharded grid primitives), grid_step
(make_grid_sharded_step, shard_state, gather_state); sharding
(make_batched_step, init_batched_state, the batched state's numpy form,
which runtime/fleet.py serves).  The submodules are imported by name: the
stage code imports gridops, and grid_step and sharding import the step.
"""
