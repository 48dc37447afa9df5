"""Port of sd_animation_optical_flow_tpu/parallel: the serving side (the
mesh, ring and Ulysses attention, row-sharded sequence parallelism)."""
