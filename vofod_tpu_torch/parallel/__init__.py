"""The grid-sharded step: one process drives the z shards of one map.

comm.LocalComm (the shards' threads, streams and collectives),
gridops.ZShardOps (the sharded grid primitives), grid_step
(make_grid_sharded_step, shard_state, gather_state).  The submodules are
imported by name: the stage code imports gridops, and grid_step imports
the step.
"""
