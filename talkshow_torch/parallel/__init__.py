"""Multi-device layer of the port (talkshow_tpu/parallel).

`mesh`: the (dp, tp) device grid, which rows of a batch a dp rank holds,
and which parameters tensor parallelism splits (`param_spec`).
`multihost`: the process group (`initialize_multihost`), a mesh over every
rank (`global_mesh`) and a rank's rows of the global batch.
`collectives`: the reductions the steps need under dp x tp and the
tensor-parallel layers (`shard_state`).
"""
