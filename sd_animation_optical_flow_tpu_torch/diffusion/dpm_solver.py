"""DPM-Solver++(2M) helpers.

Counterpart of ``sd_animation_optical_flow_tpu/diffusion/dpm_solver.py``:
only :func:`uniform_timesteps_desc` is ported; the solver's steps run as
coefficients through the multistep engine (``make_dpmpp_coeffs``).
"""

from __future__ import annotations

import numpy as np

from .schedule import DiffusionSchedule


def uniform_timesteps_desc(sched: DiffusionSchedule, t_start: int,
                           num_steps: int) -> np.ndarray:
    """[num_steps+1] descending ddpm timesteps (int32) from t_start down
    to ~1, matching the img2img t_enc entry point. Spaced in float32 and
    rounded half-to-even, as ``jnp.linspace`` + ``jnp.round`` do."""
    del sched   # kept for the JAX signature; the spacing needs no schedule
    ts = np.linspace(np.float32(t_start), np.float32(1), num_steps + 1,
                     dtype=np.float32)
    return np.round(ts).astype(np.int32)
