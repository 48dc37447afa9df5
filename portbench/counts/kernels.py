"""The least time each hand-written kernel of the port could take on one
H100: max(bytes / 3.35 TB/s, FLOP / 989 TFLOP/s), each input read once and
each output written once, bf16 (2 bytes) throughout. The arithmetic of
the port's kernel table (PERF.md), frozen here.

Each function takes a launch's integer arguments as the port's C entry
points receive them (``ops/_cuda.py``'s signatures, pointers dropped) and
returns (FLOP, bytes).
"""

from __future__ import annotations

import re

PEAK_FLOPS = 989e12       # bf16 dense, H100 SXM data sheet
PEAK_BYTES = 3.35e12      # HBM3
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)


def attention(b, h, nq, nk, d):
    """#1 / #2 (and #10's product): softmax(q k^T) v over every key."""
    flops = 4.0 * b * h * nq * nk * d
    nbytes = BF16 * (2 * b * h * nq * d + 2 * b * h * nk * d)
    return flops, nbytes


def attention_keymask(b, h, nq, nk, d, n_own, n_uncond):
    """#6: the first ``n_uncond`` batch rows see only their ``n_own`` keys
    (the injected ones are masked), the others every key."""
    keys = n_uncond * min(nk, n_own) + (b - n_uncond) * nk
    flops = 4.0 * h * nq * d * keys
    nbytes = BF16 * (2 * b * h * nq * d + 2 * h * d * keys)
    return flops, nbytes


def linear_ln(m, din, dout):
    """#3: LayerNorm(x) W^T, x [m, din], W [dout, din]."""
    flops = 2.0 * m * din * dout
    nbytes = BF16 * (m * din + din * dout + m * dout + 2 * din)
    return flops, nbytes


def geglu(m, din, dff):
    """#4: x + W2 (a * gelu(g)) + b2, [a | g] = W1 LN(x) + b1; W1 [2 dff,
    din], W2 [din, dff]."""
    flops = 2.0 * m * din * 2 * dff + 2.0 * m * dff * din
    nbytes = BF16 * (2 * m * din + 3 * din * dff + 2 * dff + 3 * din)
    return flops, nbytes


# the entry point -> (kernel family, its (FLOP, bytes) from the launch's
# integer arguments, pointers dropped: ``call(name, device, *args)``)
ENTRIES = {
    "sdaof_attention": ("attn", lambda a: attention(*a[4:9])),
    "sdaof_attention_keymask": (
        "attn", lambda a: attention_keymask(*a[4:9], a[19], a[20])),
    "sdaof_attention_mfr": ("attn", lambda a: attention(*a[4:9])),
    "sdaof_linear_ln": ("ffn", lambda a: linear_ln(*a[5:8])),
    "sdaof_geglu": ("ffn", lambda a: geglu(*a[9:12])),
}

# device kernels of each family in a trace, and how many each entry
# point launches (#4 launches two: the up and the down GEMM)
DEVICE_KERNELS = {
    "attn": r"\battention(_wide)?_sm90_kernel",
    "ffn": r"\b(linear_ln_sm90_kernel|geglu_up_sm90_kernel"
           r"|geglu_down_sm90_kernel)",
}
LAUNCHES_PER_CALL = {"sdaof_geglu": 2}


def family_share(calls, kernels, family: str):
    """Sum of the least times over sum of the device times of a family's
    launches (a share of its roofline, 0..1), or None where the window
    launched none of them or the logged calls and the traced kernels do
    not pair up one to one."""
    pat = re.compile(DEVICE_KERNELS[family])
    dev = [(e - s) / 1e9 for name, s, e, _ in kernels if pat.search(name)]
    bound, launched = 0.0, 0
    for name, args in calls:
        fam = ENTRIES.get(name)
        if fam is None or fam[0] != family:
            continue
        bound += bound_s(*fam[1](args))
        launched += LAUNCHES_PER_CALL.get(name, 1)
    if not dev or launched != len(dev):
        return None
    return bound / sum(dev)
