"""Flow evaluation runner over an indexable of samples (EPE / px accuracy).

Counterpart of ``sd_animation_optical_flow_tpu/training/flow_eval.py``:
pad to /8, run the model at eval iterations, and accumulate masked
end-point-error statistics (the RAFT ``evaluate.py`` contract).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..models import raft as RF


@torch.no_grad()
def evaluate(params, cfg: RF.RAFTConfig, ds: Sequence, *, iters: int = 24,
             max_samples: int | None = None, device="cuda"
             ) -> Dict[str, float]:
    """``ds[i]`` -> (img1 [H, W, 3] RGB 0..255, img2, flow_gt [H, W, 2],
    valid [H, W]) as numpy arrays. Returns {'epe', '1px', '3px', '5px',
    'n'} over the dataset: final-iteration EPE, valid-masked."""
    tot = {"epe": 0.0, "1px": 0.0, "3px": 0.0, "5px": 0.0}
    count = 0.0
    n = len(ds) if max_samples is None else min(len(ds), max_samples)
    for i in range(n):
        img1, img2, flow_gt, valid = ds[i]
        p1, (h, w) = RF.pad_to_multiple(_upload(img1, device), 8)
        p2, _ = RF.pad_to_multiple(_upload(img2, device), 8)
        _, flow_up = RF.raft_apply(params, cfg, p1, p2, iters=iters)
        flow = flow_up[0, :h, :w].cpu().numpy()
        epe = np.sqrt(((flow - flow_gt) ** 2).sum(-1))
        m = valid >= 0.5
        k = float(m.sum())
        if k == 0:
            continue
        tot["epe"] += float((epe * m).sum())
        tot["1px"] += float(((epe < 1.0) * m).sum())
        tot["3px"] += float(((epe < 3.0) * m).sum())
        tot["5px"] += float(((epe < 5.0) * m).sum())
        count += k
    out = {k: v / max(count, 1.0) for k, v in tot.items()}
    out["n"] = float(n)
    return out


def _upload(img, device):
    return torch.as_tensor(np.asarray(img, np.float32), device=device)[None]
