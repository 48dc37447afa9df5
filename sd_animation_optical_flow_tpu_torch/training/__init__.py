"""Port of sd_animation_optical_flow_tpu/training (the diffusion
fine-tuning step)."""
