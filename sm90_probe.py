#!/usr/bin/env python3
"""Where the time of the Hopper attention forward (kernels #1 / #7,
``csrc/attention_sm90.cu``) goes, on one NVIDIA card:

    python3 sm90_probe.py [--shape self_l0|self_l1|cross_l0|cross_l1]

Builds copies of ``attention_sm90.cu`` with one part of the work left
out (``-DSM90_SKIP=<bits>``, the kernel's ``SKIP_*`` parts), each into
its own library under ``build/probe/`` (git-ignored), and times each
against the unchanged kernel and SDPA on the same inputs (CUDA events,
interleaved rounds, the median of each). The first five copies compute
wrong results; they only time what remains:

* ``no_exp``: p = s * scale - m, no ex2 (the special-function units idle);
* ``no_loads``: the producer loads the first ring of K/V tiles of each
  unit only, so later tiles reuse them (no device-memory / L2 traffic
  past the ring);
* ``no_pv``: no p v products (q k^T and the softmax only);
* ``no_softmax``: neither the exponentials nor the max and sums (q k^T,
  packing and p v);
* ``no_stores``: no output stores to device memory (the bf16 staging in
  shared memory stays);
* ``no_turns``: the consumer warpgroups issue their products without
  taking turns (this one computes the right result).

Nothing of the port uses these copies.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from sd_animation_optical_flow_tpu_torch.ops import _cuda

ROOT = Path(__file__).resolve().parent
PROBE_DIR = ROOT / "build" / "probe"
SHAPES = {"self_l0": (2, 6144, 6144, 8, 40), "self_l1": (2, 1536, 1536, 8, 80),
          "cross_l0": (2, 6144, 231, 8, 40), "cross_l1": (2, 1536, 231, 8, 80)}

# SM90_SKIP bits per variant (attention_sm90.cu: SKIP_EXP = 1, SKIP_LOADS
# = 2, SKIP_PV = 4, SKIP_SOFTMAX = 8, SKIP_STORES = 16, SKIP_TURNS = 32)
VARIANTS = {"full": 0, "no_exp": 1, "no_loads": 2, "no_pv": 4, "no_softmax": 8,
            "no_stores": 16, "no_turns": 32}


def build(name: str) -> Path:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    so = PROBE_DIR / f"{name}.so"
    out = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                          f"-DSM90_SKIP={VARIANTS[name]}", "-shared",
                          str(_cuda.CSRC / "attention_sm90.cu"), "-o", str(so)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc {name}:\n{out.stdout}{out.stderr}")
    return so


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", choices=list(SHAPES), default="self_l0")
    ap.add_argument("--nq", type=int, default=None,
                    help="query tokens in place of the shape's")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sm90_probe: no CUDA device")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    fns = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).sdaof_attention_fwd_stats
        fn.argtypes = _cuda._SIGNATURES["sdaof_attention_fwd_stats"]
        fn.restype = ctypes.c_int
        fns[name] = fn

    b, nq, nk, h, d = SHAPES[args.shape]
    self_attn = nq == nk
    nq = args.nq or nq
    gen = torch.Generator("cuda").manual_seed(0)
    mk = lambda n, parts: torch.randn((b, n, parts * h * d), generator=gen,
                                      device="cuda").to(torch.bfloat16)
    if self_attn:       # fused-QKV slices, as the UNet's self-attention
        nk = nq
        q, k, v = (t.reshape(b, nq, h, d) for t in mk(nq, 3).chunk(3, -1))
    else:
        q = mk(nq, 1).reshape(b, nq, h, d)
        k, v = (t.reshape(b, nk, h, d) for t in mk(nk, 2).chunk(2, -1))
    out = torch.empty((b, nq, h, d), dtype=torch.bfloat16, device="cuda")
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    scale_log2 = math.log2(math.e) / math.sqrt(d)

    def call(fn):
        return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), None, b, h, nq, nk, d, *strides,
                          scale_log2, torch.cuda.current_device(), stream)

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    runs = {name: call(fn) for name, fn in fns.items()}
    runs["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt)
    outs = {}
    for name, run in runs.items():
        if name != "sdpa":
            run()
            torch.cuda.synchronize()
            outs[name] = out.float().clone()
    times = {name: [] for name in runs}
    for _ in range(args.rounds):
        for name, run in runs.items():
            for _ in range(2):
                run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                err = run()
                if name != "sdpa" and err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / args.iters)
    print(f"[probe] {card}; {args.shape} q [{b},{nq},{h},{d}] kv {nk}; "
          f"median of {args.rounds} rounds of {args.iters} calls")
    full = statistics.median(times["full"])
    for name, ts in times.items():
        ms = statistics.median(ts)
        diff = "" if name not in outs else \
            f", max |out - full's| {(outs[name] - outs['full']).abs().max().item():.3e}"
        print(f"[probe] {name:11s} {ms:.4f} ms ({ms / full:.2f} of full){diff}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
