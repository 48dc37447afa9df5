"""Port of sd_animation_optical_flow_tpu/ops."""
