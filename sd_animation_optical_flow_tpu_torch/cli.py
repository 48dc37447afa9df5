"""Command-line entry points of the port.

Counterpart of ``sd_animation_optical_flow_tpu/cli.py``: the same nine
subcommands with the same flags and defaults, and one flag more,
``--device`` (``cuda`` unless the caller asks for ``cpu``; nothing falls
back to the CPU):

    python -m sd_animation_optical_flow_tpu_torch.cli pixel-inpaint \\
        -i video.mp4 -o out --ckpt model.safetensors \\
        --inpaint-ckpt model_inpainting.safetensors --bf16

Checkpoints with ldm names (``.ckpt`` / ``.safetensors``) are ported by
``utils/port_weights.py``; without them the pipelines run with random
weights (smoke mode: shapes and timing, not output quality). Video files
are decoded with cv2, imported only where a file is decoded.

``--dp`` / ``--sp`` run one rank a device: start the command under
``torchrun --nproc-per-node N``; the process group (NCCL on ``cuda``,
gloo on ``cpu``) is initialised from torchrun's environment, or an
initialised one is used, and its world size must equal the flag.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import re
import sys

import torch
import torch.distributed as dist


def _sampler(text: str) -> str:
    """``--sampler``: 'ddim', 'dpmpp' or 'dpmpp:N' with N >= 1."""
    if text in ("ddim", "dpmpp") or re.fullmatch(r"dpmpp:[1-9][0-9]*", text):
        return text
    raise argparse.ArgumentTypeError(
        f"unknown sampler {text!r}: ddim, dpmpp or dpmpp:N (N >= 1)")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device of the models (cuda, cuda:N or cpu)")


def _add_common(p):
    p.add_argument("-i", "--input", required=True, help="input video")
    p.add_argument("-o", "--output", required=True, help="output dir")
    p.add_argument("--ckpt", default=None, help="SD checkpoint "
                   "(.safetensors/.ckpt); random weights if omitted")
    p.add_argument("--inpaint-ckpt", default=None,
                   help="9-ch inpainting checkpoint")
    p.add_argument("--spec", default="sd15",
                   help="model spec: builtin name or YAML path (ours or "
                        "the reference's OmegaConf schema)")
    p.add_argument("--inpaint-spec", default="sd15-inpaint9",
                   help="inpainting model spec (builtin name or YAML)")
    p.add_argument("--flow-iters", type=int, default=20,
                   help="RAFT refinement iterations (reference: 20)")
    p.add_argument("--flow-corr-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of the RAFT all-pairs correlation "
                        "pyramid (bfloat16 halves its memory)")
    p.add_argument("--raft-ckpt", default=None, help="raft-things weights")
    p.add_argument("--flow-uncertainty", default="fb",
                   choices=["fb", "learned", "min"],
                   help="confidence source: forward-backward consistency "
                        "(fb), the trained Laplace-scale uncertainty head "
                        "(learned), or the elementwise min of both")
    p.add_argument("--uncertainty-head", default=None,
                   help="trained uncertainty-head params (npz in the "
                        "utils/checkpoint.py format). For --flow-uncertainty "
                        "learned/min without --raft-ckpt, defaults to the "
                        "committed artifacts/uncertainty_head_synth.npz "
                        "(paired with artifacts/raft_synth.npz). With "
                        "ported raft-things weights, train one first: "
                        "`cli train-uncertainty --raft <ported.npz>`")
    p.add_argument("--tagger-model", default=None, help="WD tagger .onnx")
    p.add_argument("--tagger-tags", default=None, help="selected_tags.csv")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--keep-every", type=int, default=3)
    p.add_argument("--ddim-steps", type=int, default=50)
    p.add_argument("--denoising-strength", type=float, default=0.4)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--prompt-extra", default="",
                   help="extra positive-prompt tags")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 weights and compute (the card's fast "
                        "path: the hand-written kernels run in bf16)")
    p.add_argument("--sampler", default="ddim", type=_sampler,
                   help="ddim | dpmpp | dpmpp:N — dpmpp is "
                        "DPM-Solver++(2M), usable at ~half the steps of "
                        "ddim; dpmpp:N pins N solver steps")
    _add_device(p)


def _device(args) -> torch.device:
    return torch.device(args.device)


def _dtype(args):
    return torch.bfloat16 if args.bf16 else torch.float32


def _smoke_note(args):
    if not args.ckpt:
        print("[cli] no --ckpt: random weights (smoke mode)")


# ---------------------------------------------------------------------------
# ranks (--dp / --sp)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _ranks(n: int, device: torch.device):
    """The process group of the ``n`` ranks a --dp / --sp run needs, for
    the length of the block: an initialised one, or one initialised from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT;
    NCCL on cuda, gloo on cpu; each cuda rank on device LOCAL_RANK) and
    destroyed at the end. Raises when there is neither, or when the world
    size is not ``n``."""
    own = not dist.is_initialized()
    if own:
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(f"--dp/--sp {n} runs one rank a device: start "
                             f"it under torchrun --nproc-per-node {n}")
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        world = dist.get_world_size()
        if world != n:
            raise ValueError(f"the flag asks for {n} ranks, the process "
                             f"group has {world}")
        yield
    finally:
        if own:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _build_models(args):
    """(sd, sd9, flow estimator, tagger) on ``--device``: the bundles from
    their specs and checkpoints; RAFT from --raft-ckpt, else, for a
    learned confidence without --uncertainty-head, the committed
    synthetic pair, else random weights; the tagger from its files."""
    from . import config as C
    from .models import flowconf as FC
    from .models import raft as RF
    from .models.layers import Init
    from .pipelines.tagger import Tagger
    from .utils.jax_params import ARTIFACTS, load_npz_tree

    dev, dtype = _device(args), _dtype(args)
    sd = C.create_model(args.spec, args.ckpt, dtype=dtype, device=dev)
    sd9 = C.create_model(args.inpaint_spec, args.inpaint_ckpt, dtype=dtype,
                         device=dev)

    fcfg = FC.FlowConfidenceConfig(raft=RF.RAFTConfig(
        iters=args.flow_iters, corr_dtype=args.flow_corr_dtype),
        uncertainty=args.flow_uncertainty)
    head_p = None
    if args.flow_uncertainty != "fb":
        head_path = args.uncertainty_head
        if not head_path and not args.raft_ckpt:
            # the committed synthetic-suite pair: the head reads the
            # RAFT's GRU state, so it pairs only with the RAFT it was
            # trained against
            head_path = os.path.join(ARTIFACTS,
                                     "uncertainty_head_synth.npz")
        if not head_path or not os.path.exists(head_path):
            raise SystemExit(
                "--flow-uncertainty learned/min needs --uncertainty-head "
                "params (with --raft-ckpt, train one against the ported "
                "flow: cli train-uncertainty --raft <ported.npz>)")
        head_p = C._channels_last(load_npz_tree(head_path, device=dev))
    if args.raft_ckpt:
        from .utils.port_weights import load_state_dict, port_raft
        raft_p, _ = port_raft(load_state_dict(args.raft_ckpt), device=dev)
    else:
        synth = os.path.join(ARTIFACTS, "raft_synth.npz")
        if (head_p is not None and not args.uncertainty_head
                and os.path.exists(synth)):
            raft_p = C._channels_last(load_npz_tree(synth, device=dev))
            print(f"[cli] no --raft-ckpt: loaded the paired synthetic "
                  f"RAFT ({synth})")
        else:
            raft_p = C._channels_last(RF.raft_init(
                Init(torch.Generator(dev).manual_seed(0), device=dev),
                fcfg.raft))
            print("[cli] no --raft-ckpt: flow estimator runs with random "
                  "weights (smoke mode)")
    flow_est = FC.FlowConfidenceEstimator(raft_p, fcfg, head_params=head_p,
                                          device=dev)
    tagger = Tagger(args.tagger_model, args.tagger_tags, device=dev)
    if not tagger.available:
        print("[cli] tagger unavailable; using fixed prompt prefix")
    return sd, sd9, flow_est, tagger


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def pixel_inpaint_config(args):
    """The ``PixelInpaintConfig`` of a pixel-inpaint / verify-parity argv."""
    from .pipelines import pixel_inpaint as PI
    return PI.PixelInpaintConfig(
        size=(args.width, args.height), keep_every=args.keep_every,
        key_frame_thres=args.key_frame_thres,
        denoising_strength=args.denoising_strength,
        confidence_thres=args.confidence_thres,
        propagated_pixel_weight=args.propagated_pixel_weight,
        ddim_steps=args.ddim_steps, seed=args.seed,
        prompt_extra=args.prompt_extra, frame_batch=args.frame_batch,
        sampler=args.sampler, cfg_interval=args.cfg_interval,
        deepcache_interval=args.deepcache_interval, dp=args.dp)


def cmd_pixel_inpaint(args):
    from .pipelines import pixel_inpaint as PI
    cfg = pixel_inpaint_config(args)
    if cfg.dp > 0 and cfg.frame_batch <= 1:
        sys.exit("--dp requires --frame-batch > 1 (dp shards the "
                 "frame batch; see run_batched)")
    # run_batched builds the dp mesh over the ranks' group (make_mesh)
    with _ranks(cfg.dp, _device(args)) if cfg.dp > 0 else \
            contextlib.nullcontext():
        sd, sd9, flow_est, tagger = _build_models(args)
        if cfg.frame_batch > 1:
            from .pipelines.keyframes import FrameGenConfig, frame_generator
            gen = frame_generator(args.input, FrameGenConfig(
                size=cfg.size, keep_every=cfg.keep_every,
                threshold=cfg.key_frame_thres), device=sd9.device)
            out = PI.run_batched(gen, args.output, sd, sd9, flow_est,
                                 tagger, cfg)
        else:
            out = PI.run_video(args.input, args.output, sd, sd9, flow_est,
                               tagger, cfg)
    print(f"[cli] wrote {out}")
    return out


def cmd_verify_parity(args):
    """One-command quality gate (warped-region PSNR >= 40 dB against the
    reference's ``converted_%06d.png`` outputs): run the pixel-inpaint
    pipeline (or, with --ours, score an existing output directory),
    compare every converted frame against --ref-frames over the warped
    (high-confidence) region, print the report, exit nonzero if the gate
    fails."""
    import json

    from .utils import parity as P

    ours = args.ours
    if ours is None:
        ours = cmd_pixel_inpaint(args)
    report = P.compare_dirs(ours, args.ref_frames,
                            conf_thres=args.conf_thres)
    print(json.dumps(report, indent=2))
    if not report["gate_40db"]:
        raise SystemExit(1)


def cmd_ofgen(args):
    import cv2
    from .pipelines import ofgen as OF
    sd, _, flow_est, tagger = _build_models(args)

    def frames():
        video = cv2.VideoCapture(args.input)
        while True:
            ret, frame = video.read()
            if not ret:
                break
            yield cv2.resize(frame, (args.width, args.height),
                             interpolation=cv2.INTER_AREA)
        video.release()

    def flow_calc(prev, cur):
        flow, _, _ = flow_est.calc(prev[..., ::-1].astype("float32"),
                                   cur[..., ::-1].astype("float32"))
        return flow

    cfg = OF.OfgenConfig(denoising_strength=args.denoising_strength,
                         ddim_steps=args.ddim_steps, seed=args.seed,
                         prompt_extra=args.prompt_extra)
    out = OF.run(frames(), args.output, sd, flow_calc, tagger, cfg)
    print(f"[cli] wrote {out}")


def cmd_keyframe_inpaint(args):
    from .pipelines import keyframe_inpaint as KI
    dev = _device(args)
    with _ranks(args.sp, dev) if args.sp > 0 else contextlib.nullcontext():
        sp, workspace = None, args.output
        if args.sp > 0:
            from .models.unet import SeqParallelConfig
            from .parallel.mesh import make_mesh, replicate_tree
            sp = SeqParallelConfig(mesh=make_mesh(dp=args.sp,
                                                  device_type=dev.type),
                                   axis="dp")
            if dist.get_rank() > 0:
                # every rank runs the pipeline in a workspace of its own
                workspace = f"{args.output}.rank{dist.get_rank()}"
        sd, sd9, flow_est, tagger = _build_models(args)
        if sp is not None:
            for b in (sd, sd9):
                replicate_tree((b.unet_params, b.vae_params, b.clip_params),
                               sp.mesh)
        ws = KI.VideoWorkspace(workspace, video_path=args.input,
                               size=(args.width, args.height),
                               keep_every=args.keep_every,
                               max_len_sec=args.max_len_sec, device=dev)
        cfg = KI.KeyframeInpaintConfig(
            size=(args.width, args.height), keep_every=args.keep_every,
            kernel_size=args.kernel_size, stride=args.stride,
            num_ref_for_generation=args.num_refs,
            denoising_strength=args.denoising_strength,
            ddim_steps=args.ddim_steps, seed=args.seed, mode=args.mode,
            prompt_extra=args.prompt_extra, level_batch=args.level_batch,
            flow_batch=args.flow_batch, sp=sp)
        out = KI.run(ws, sd, sd9, flow_est, tagger, cfg)
    print(f"[cli] wrote {out}")


def cmd_depth2img(args):
    """Single-image depth-conditioned img2img (a 5-channel UNet whose
    fifth channel is a DPT's depth; pipelines/specializations.py)."""
    from . import config as C
    from .models import depth as DP
    from .models.layers import Init
    from .pipelines import specializations as SP
    from .utils.images import (bgr_u8_to_model, model_to_bgr_u8,
                               read_png_bgr, write_png)

    dev = _device(args)
    sd = C.create_model("sd15-depth", args.ckpt, dtype=_dtype(args),
                        device=dev)
    dcfg = DP.DPTConfig()
    dp_params = C._channels_last(DP.dpt_init(
        Init(torch.Generator(dev).manual_seed(0), device=dev), dcfg))
    _smoke_note(args)
    depth = SP.DepthConditioner(params=dp_params, cfg=dcfg)
    img = bgr_u8_to_model(read_png_bgr(args.input), device=dev)
    out, _ = SP.img2img_depth2img(
        sd, depth, img, args.prompt, args.negative_prompt,
        denoising_strength=args.denoising_strength,
        ddim_steps=args.ddim_steps, seed=args.seed)
    write_png(args.output, model_to_bgr_u8(out))
    print(f"[cli] wrote {args.output}")


def cmd_upscale(args):
    """Latent upscaling of one image (a 7-channel UNet, class-conditional
    on the noise level; pipelines/specializations.py)."""
    from . import config as C
    from .pipelines import specializations as SP
    from .utils.images import (bgr_u8_to_model, model_to_bgr_u8,
                               read_png_bgr, write_png)

    dev = _device(args)
    sd = C.create_model("sd-upscale", args.ckpt, dtype=_dtype(args),
                        device=dev)
    _smoke_note(args)
    x_low = bgr_u8_to_model(read_png_bgr(args.input), device=dev)
    out, lvl = SP.upscale(sd, x_low, args.prompt, args.negative_prompt,
                          noise_level=[args.noise_level]
                          if args.noise_level is not None else None,
                          ddim_steps=args.ddim_steps, seed=args.seed)
    write_png(args.output, model_to_bgr_u8(out))
    print(f"[cli] wrote {args.output} (noise level {int(lvl[0])})")


def cmd_txt2img(args):
    """Text-to-image through the full DDIM chain from pure noise."""
    from . import config as C
    from .pipelines import facades as F
    from .utils.images import model_to_bgr_u8, write_png

    sd = C.create_model("sd15", args.ckpt, dtype=_dtype(args),
                        device=_device(args))
    _smoke_note(args)
    out = F.txt2img(sd, args.prompt, args.negative_prompt,
                    height=args.height, width=args.width,
                    ddim_steps=args.ddim_steps, cfg_scale=args.cfg_scale,
                    seed=args.seed)
    write_png(args.output, model_to_bgr_u8(out))
    print(f"[cli] wrote {args.output}")


def cmd_port(args):
    """One-shot weight porting: a torch .ckpt / .safetensors -> the JAX
    package's npz trees (``utils/checkpoint.save_npz_tree``: its
    ``load_pytree`` and the port's ``jax_params.load_npz_tree`` read
    them), so later runs load the ported trees directly."""
    from . import config as C
    from .utils.checkpoint import save_npz_tree

    bundle = C.create_model(args.spec, args.ckpt, dtype=_dtype(args),
                            device=_device(args))
    os.makedirs(args.output, exist_ok=True)
    for name, tree in (("unet", bundle.unet_params),
                       ("vae", bundle.vae_params),
                       ("clip", bundle.clip_params)):
        path = os.path.join(args.output, f"{name}.npz")
        save_npz_tree(path, tree)
        print(f"[cli] wrote {path}")
    if args.raft_ckpt:
        from .utils.port_weights import load_state_dict, port_raft
        raft_p, missing = port_raft(load_state_dict(args.raft_ckpt),
                                    device=_device(args))
        save_npz_tree(os.path.join(args.output, "raft.npz"), raft_p)
        print(f"[cli] wrote raft.npz ({len(missing)} missing keys)")


def cmd_train_uncertainty(args):
    """Train (and evaluate) the learned flow-uncertainty head. With
    --raft <npz> (e.g. ported raft-things from `port`) only the head
    trains, against the frozen flow; without it RAFT itself is first
    trained on the synthetic suite, so the committed pair of artifacts
    can be remade end to end."""
    import numpy as np

    from .models import raft as RF
    from .training import uncertainty_pretrain as UP
    from .utils.checkpoint import save_npz_tree
    from .utils.jax_params import load_npz_tree

    dev = _device(args)
    h, w = (int(x) for x in args.size.split("x"))
    # training keeps the exact f32 correlation numerics; the params are
    # the same for either storage dtype at inference
    cfg = RF.RAFTConfig(corr_dtype="float32")
    os.makedirs(args.output, exist_ok=True)

    if args.raft:
        raft_p = load_npz_tree(args.raft, device=dev)
        print(f"[cli] loaded frozen RAFT from {args.raft}")
    else:
        init_p = None
        if args.resume_raft:
            init_p = load_npz_tree(args.resume_raft, device=dev)
            print(f"[cli] resuming RAFT stage 1 from {args.resume_raft}")
        raft_p, m = UP.train_raft_synthetic(
            cfg, steps=args.raft_steps, batch=args.batch, h=h, w=w,
            iters=args.train_iters, lr=args.lr, seed=args.seed,
            init_params=init_p, log=print, device=dev)
        path = os.path.join(args.output, "raft_synth.npz")
        save_npz_tree(path, raft_p, dtype=np.float16)
        heldout = UP.eval_epe(raft_p, cfg, device=dev)
        print(f"[cli] wrote {path} (train epe {m['epe']:.3f}, "
              f"held-out epe {heldout:.3f})")

    head_p, m = UP.train_head_synthetic(
        raft_p, cfg, steps=args.head_steps, batch=args.batch, h=h, w=w,
        iters=args.train_iters, lr=args.head_lr, seed=args.seed + 1,
        bce_weight=args.bce_weight, log=print, device=dev)
    path = os.path.join(args.output, "uncertainty_head_synth.npz")
    save_npz_tree(path, head_p)
    print(f"[cli] wrote {path} (err/scale corr "
          f"{m['err_scale_corr']:.3f})")

    if args.eval_scenes > 0:
        ev = UP.evaluate_masks(raft_p, head_p, cfg,
                               n_scenes=args.eval_scenes, h=h, w=w,
                               device=dev)
        for mode, r in ev.items():
            ts = sorted(float(k.split("@")[1]) for k in r
                        if k.startswith("recall@"))
            pts = "  ".join(
                f"@{t:g}: recall {r[f'recall@{t}']:.3f}/"
                f"false {r[f'false_rate@{t}']:.3f}"
                for t in ts)
            print(f"[cli] mask {mode}: disocclusion AUROC "
                  f"{r['auroc']:.3f}  {pts}")


def _add_pixel_args(p):
    """Pixel-inpaint pipeline knobs (shared with verify-parity, which
    runs the same pipeline before scoring it)."""
    _add_common(p)
    p.add_argument("--key-frame-thres", type=float, default=24.0)
    p.add_argument("--confidence-thres", type=float, default=0.95)
    p.add_argument("--propagated-pixel-weight", type=float, default=0.0)
    p.add_argument("--frame-batch", type=int, default=1,
                   help=">1: batch the non-key frames of a segment "
                        "through one flow, warp and inpaint call each")
    p.add_argument("--dp", type=int, default=0,
                   help=">0: shard the frame batch over this many ranks "
                        "(data parallel; requires --frame-batch divisible "
                        "by it, and torchrun)")
    p.add_argument("--cfg-interval", type=int, default=1,
                   help="turbo: refresh the uncond CFG branch every "
                        "k-th step (approximation, 1 = exact)")
    p.add_argument("--deepcache-interval", type=int, default=0,
                   help="turbo: reuse the deep UNet segment between "
                        "steps for keyframe img2img (0 = off)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sd_animation_optical_flow_tpu_torch",
        description="flow-guided animation pipelines on PyTorch + CUDA")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("pixel-inpaint",
                        help="keyframe img2img + warp + masked inpainting "
                             "(the README main pipeline)")
    _add_pixel_args(p1)
    p1.set_defaults(fn=cmd_pixel_inpaint)

    p2 = sub.add_parser("ofgen", help="warp-as-guidance pipeline")
    _add_common(p2)
    p2.set_defaults(fn=cmd_ofgen)

    p3 = sub.add_parser("keyframe-inpaint",
                        help="hierarchical keyframe pipeline")
    _add_common(p3)
    p3.add_argument("--max-len-sec", type=int, default=30)
    p3.add_argument("--kernel-size", type=int, default=30)
    p3.add_argument("--stride", type=int, default=15)
    p3.add_argument("--num-refs", type=int, default=1)
    p3.add_argument("--level-batch", type=int, default=4,
                    help="frames a call in the level back-fill (frames of "
                         "one level are independent given the previous "
                         "level)")
    p3.add_argument("--mode", default="warp_and_inpaint_crossattn",
                    choices=["warp_and_inpaint", "self_attn", "both",
                             "warp_and_inpaint_crossattn"])
    p3.add_argument("--flow-batch", type=int, default=8,
                    help="pairs a RAFT batch of the flow cache (halved "
                         "where a batch runs out of device memory)")
    p3.add_argument("--sp", type=int, default=0,
                    help=">0: sequence-parallel strip denoising over this "
                         "many ranks (Ulysses attention; the strip's rows "
                         "shard across them; torchrun). Requires the UNet "
                         "head count divisible by it.")
    p3.set_defaults(fn=cmd_keyframe_inpaint)

    def _add_single_image(p):
        p.add_argument("-i", "--input", required=True, help="input image")
        p.add_argument("-o", "--output", required=True, help="output png")
        p.add_argument("--ckpt", default=None)
        p.add_argument("--prompt", default="masterpiece,best quality")
        p.add_argument("--negative-prompt", default="")
        p.add_argument("--ddim-steps", type=int, default=50)
        p.add_argument("--seed", type=int, default=1234)
        p.add_argument("--bf16", action="store_true")
        _add_device(p)

    p4 = sub.add_parser("depth2img",
                        help="depth-conditioned img2img (one image)")
    _add_single_image(p4)
    p4.add_argument("--denoising-strength", type=float, default=0.5)
    p4.set_defaults(fn=cmd_depth2img)

    p5 = sub.add_parser("upscale", help="latent upscaling (one image)")
    _add_single_image(p5)
    p5.add_argument("--noise-level", type=int, default=None)
    p5.set_defaults(fn=cmd_upscale)

    p6 = sub.add_parser("txt2img",
                        help="generation from pure noise (full DDIM chain)")
    p6.add_argument("-o", "--output", required=True, help="output png")
    p6.add_argument("--ckpt", default=None)
    p6.add_argument("--prompt", default="masterpiece,best quality")
    p6.add_argument("--negative-prompt", default="")
    p6.add_argument("--height", type=int, default=512)
    p6.add_argument("--width", type=int, default=768)
    p6.add_argument("--ddim-steps", type=int, default=50)
    p6.add_argument("--cfg-scale", type=float, default=7.0)
    p6.add_argument("--seed", type=int, default=1234)
    p6.add_argument("--bf16", action="store_true")
    _add_device(p6)
    p6.set_defaults(fn=cmd_txt2img)

    p7 = sub.add_parser("port", help="port torch checkpoints to npz tree "
                                     "files")
    p7.add_argument("--spec", default="sd15",
                    help="builtin name or YAML (ours or reference schema)")
    p7.add_argument("--ckpt", default=None, help="torch .ckpt/.safetensors")
    p7.add_argument("--raft-ckpt", default=None)
    p7.add_argument("-o", "--output", required=True, help="output dir")
    p7.add_argument("--bf16", action="store_true")
    _add_device(p7)
    p7.set_defaults(fn=cmd_port)

    p8 = sub.add_parser(
        "train-uncertainty",
        help="train the learned flow-uncertainty decoder (and, without "
             "--raft, a synthetic-suite RAFT for it to pair with)")
    p8.add_argument("-o", "--output", required=True, help="output dir")
    p8.add_argument("--raft", default=None,
                    help="frozen RAFT params npz (e.g. ported "
                         "raft-things); omit to train one on the "
                         "synthetic suite first")
    p8.add_argument("--resume-raft", default=None,
                    help="continue stage-1 RAFT training from a prior "
                         "raft_synth.npz instead of from scratch")
    p8.add_argument("--raft-steps", type=int, default=600)
    p8.add_argument("--head-steps", type=int, default=400)
    p8.add_argument("--batch", type=int, default=4)
    p8.add_argument("--size", default="128x192",
                    help="training crop HxW (multiples of 8)")
    p8.add_argument("--train-iters", type=int, default=8,
                    help="RAFT GRU iterations during training")
    p8.add_argument("--lr", type=float, default=4e-4,
                    help="stage-1 (RAFT) learning rate")
    p8.add_argument("--head-lr", type=float, default=1e-3,
                    help="stage-2 (head) learning rate")
    p8.add_argument("--bce-weight", type=float, default=0.3,
                    help="disocclusion-BCE sharpening weight on the "
                         "served confidence mapping (0 = pure NLL)")
    p8.add_argument("--seed", type=int, default=0)
    p8.add_argument("--eval-scenes", type=int, default=16,
                    help="held-out scenes for the mask recall/false-rate "
                         "report (0 = skip)")
    _add_device(p8)
    p8.set_defaults(fn=cmd_train_uncertainty)

    p9 = sub.add_parser(
        "verify-parity",
        help="run the pixel-inpaint pipeline and score warped-region "
             "PSNR against reference converted_*.png frames (the 40 dB "
             "gate) — or score an existing dir with --ours")
    _add_pixel_args(p9)
    p9.add_argument("--ref-frames", required=True,
                    help="reference output dir (converted_%%06d.png)")
    p9.add_argument("--ours", default=None,
                    help="already-generated output dir to score "
                         "(skips pipeline execution)")
    p9.add_argument("--conf-thres", type=int, default=242,
                    help="warped-region selector on the 0-255 "
                         "confidence map (242 ~ 0.95)")
    p9.set_defaults(fn=cmd_verify_parity)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
