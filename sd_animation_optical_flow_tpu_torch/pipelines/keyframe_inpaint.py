"""Keyframe inpainting pipeline — so far only the K/V store helper.

Counterpart of ``sd_animation_optical_flow_tpu/pipelines/keyframe_inpaint.py``:
``concat_ref_kv`` joins the K/V stores of several reference frames into
the ``reference_kv`` of one generation step. The pipeline itself (seed
strips, warp-and-inpaint levels, the workspace) is not ported yet
(ROADMAP §1 item 5).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def concat_ref_kv(kv_hists: Sequence) -> Optional[tuple]:
    """Concatenate several stored K/V tuples along the token axis, layer
    by layer (None entries are skipped; None if nothing is left)."""
    kv_hists = [kv for kv in kv_hists if kv is not None]
    if not kv_hists:
        return None
    return tuple((torch.cat([kv[i][0] for kv in kv_hists], dim=1),
                  torch.cat([kv[i][1] for kv in kv_hists], dim=1))
                 for i in range(len(kv_hists[0])))
