"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled for Hopper (``sm_90a``) by ``nvcc`` at first use
into one shared library with a plain C interface, loaded with ``ctypes``.
Each source compiles in its own ``nvcc`` process, all started together,
then one link. The library lands in ``build/kernels/`` beside the
package (git-ignored), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads at once.

Nothing here runs at import: the CPU tests import every module, and this
machine may have neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, o, B, H, Nq, Nk, D, 9 strides, scale_log2, device, stream
    "sdaof_attention": [_P] * 4 + [_I] * 5 + [_L] * 9 + [_F, _I, _P],
    # ... scale_log2, n_own, n_uncond, device, stream
    "sdaof_attention_keymask": [_P] * 4 + [_I] * 5 + [_L] * 9
    + [_F, _I, _I, _I, _P],
    # ... scale_log2, w_strip, w_tile, radius, target_only, bias_log2,
    # inv_sigma, device, stream
    "sdaof_attention_mfr": [_P] * 4 + [_I] * 5 + [_L] * 9
    + [_F, _I, _I, _I, _I, _F, _F, _I, _P],
    # ... scale_log2, fh, fw, radius, bias_log2, base_log2, inv_sigma,
    # device, stream
    "sdaof_attention_banded": [_P] * 4 + [_I] * 5 + [_L] * 9
    + [_F, _I, _I, _I, _F, _F, _F, _I, _P],
    # q, k, v, o, lse, B, H, Nq, Nk, D, 9 strides, scale_log2, device,
    # stream
    "sdaof_attention_fwd_stats": [_P] * 5 + [_I] * 5 + [_L] * 9
    + [_F, _I, _P],
    # q, k, v, do, lse, dvec, dk, dv, B, H, Nq, Nk, D, 12 strides (q, k,
    # v, do), scale_log2, device, stream
    "sdaof_attention_bwd_dkv": [_P] * 8 + [_I] * 5 + [_L] * 12
    + [_F, _I, _P],
    # q, k, v, do, lse, dvec, dq, B, H, Nq, Nk, D, 12 strides, scale_log2,
    # device, stream
    "sdaof_attention_bwd_dq": [_P] * 7 + [_I] * 5 + [_L] * 12
    + [_F, _I, _P],
    # x, ln_scale, ln_bias, w, y, M, din, dout, eps, device, stream
    "sdaof_linear_ln": [_P] * 5 + [_I] * 3 + [_F, _I, _P],
    # x, ln_scale, ln_bias, w1, b1, w2, b2, a (the [M, dff] scratch), y, M,
    # din, dff, eps, residual, device, stream
    "sdaof_geglu": [_P] * 9 + [_I] * 3 + [_F, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC} at first use and need the CUDA toolkit")


def library_path() -> Path:
    """Path of the built library for the current sources (may not exist)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsdaof_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link one library.
    Returns its path; raises with the compiler's output on failure. The
    ptxas report (registers, shared memory, spills) is kept beside the
    library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"tmp_{so.stem}_{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
         "-o", str(tmp / f"{src.stem}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sources]
    logs = []
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *(str(tmp / f"{s.stem}.o")
                                        for s in sources),
         "-o", str(tmp / so.name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {so.name} failed:\n{link.stdout}")
    (tmp / f"{so.stem}.log").write_text("\n".join(logs))
    os.replace(tmp / f"{so.stem}.log", so.with_suffix(".log"))
    os.replace(tmp / so.name, so)       # atomic: racing builders agree
    shutil.rmtree(tmp, ignore_errors=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sdaof_error_string.argtypes = [ctypes.c_int]
            lib.sdaof_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


class Kernel(NamedTuple):
    """What a wrapper's ``.kernel`` holds after a launch: the device
    kernel's source in the repo and its design, in a line."""
    source: str
    design: str


def kernel(source: str, design: str) -> Kernel:
    """The :class:`Kernel` of ``csrc/<source>``."""
    return Kernel(f"sd_animation_optical_flow_tpu_torch/csrc/{source}",
                  design)


def records_grad(*tensors) -> bool:
    """True when autograd would record an op on these inputs: grad mode
    is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """A kernel without a backward raises where a gradient would be
    recorded through it: its output, written through a raw pointer, has
    no ``grad_fn``, so autograd would drop the gradient silently."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on "
            "tensors that do not require grad (the differentiable attention "
            "is flash_attention_diff / shortk_attention; the fused FFN "
            "kernels have no gradient route)")


def call(name: str, device: torch.device, *args) -> None:
    """Launch ``name`` on ``device``'s current stream; raise on a launch
    error (a refused launch never runs, and no synchronize reports it)."""
    lib = library()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    err = getattr(lib, name)(*args, index, stream)
    if err != 0:
        msg = lib.sdaof_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")

