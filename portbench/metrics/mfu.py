"""Model FLOPs of the window's first clips (``counts/flops.py``: the
UNets, the VAE, RAFT and its head, padded rows included, RAFT's float32
convolutions counted like the rest) over their host seconds times one
H100's bf16 peak, in %. Read over the CUDA-only profiled part, whose host
runs as it does untraced."""

from portbench.counts.kernels import PEAK_FLOPS


def read(rec):
    t = rec.timed
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * t.model_flops / (t.window_s * PEAK_FLOPS)
