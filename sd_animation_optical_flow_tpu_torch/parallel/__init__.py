"""Port of sd_animation_optical_flow_tpu/parallel: the mesh, ring and
Ulysses attention, row-sharded sequence parallelism (the serving side),
and the UNet's tensor-parallel layout with its collectives
(``sharding.py``, ``tensor.py``; the dp x tp fine-tuning step is
``training/train_step.shard_train_state``)."""
