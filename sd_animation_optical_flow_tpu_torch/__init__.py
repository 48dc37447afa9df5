"""sd_animation_optical_flow_tpu_torch — the PyTorch + CUDA port of
``sd_animation_optical_flow_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module
tree and public names and imports neither JAX nor the JAX package. The
TPU's Pallas kernels become hand-written CUDA kernels for Hopper
(``csrc/``, built at first use; see ``ops/_cuda.py``). Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.

Ported so far: the SD-1.5 img2img main path, the keyframe pipeline's
generation step (K/V capture and injection, inpainting on the 9-channel
model, MFR strips), the diffusion fine-tuning step, and the pixel-inpaint
pipeline (RAFT flow with confidence from the committed artifacts, the
fused warp + mask, ``run``, the segment-batched ``run_batched`` and
``run_video``; key-frame detection with a cv2-exact Canny; the tagger;
the warped-region PSNR report), and the flow-training path (synthetic
scenes rendered on the card, RAFT's sequence loss and train step, the
uncertainty head's step, pretraining and evaluation; the npz writer),
and ControlNet with the HED annotator and the sampler hooks (guidance
blending, CFG caching, DeepCache; ``models/controlnet.py``,
``models/hed.py``, ``diffusion/ddim.ddim_decode``), and the keyframe
pipeline (``pipelines/keyframe_inpaint.py``: the resumable workspace
behind the native frame pipe, the flow cache, the level pyramid, the
fused flow + warp + merge prep, the seed strip and the serial and
level-batched back-fill) with the warp-as-guidance ``pipelines/ofgen.py``,
and the other samplers and model variants (``txt2img``, the DDIM
inversion, PLMS, DDPM, the standalone DPM-Solver++(2M), class
conditioning, depth2img with a DPT, latent upscaling, the VQ first stage
and the OpenCLIP / T5 text encoders), and ``parallel/`` (sequence
parallelism and dp batches for serving; tensor x data parallel
fine-tuning, ``training/train_step.shard_train_state``), and the
host-side training data and logging (flow datasets and augmentors, BSRGAN
degradations, flow IO and visualization, image panels, profiling)
—

    import sd_animation_optical_flow_tpu_torch as M
    sd = M.create_model("sd15", dtype=torch.bfloat16)     # random weights
    img, kv = M.img2img(sd, image, prompt, negative, 0.4, capture_kv=True)
    sd9 = M.create_model("sd15-inpaint9", dtype=torch.bfloat16)
    flow = M.load_flow_estimator()      # artifacts/raft_synth.npz + head
    out_dir = M.run_pixel_inpaint(frames, "out/clip", sd, sd9, flow)
    cfg = M.PixelInpaintConfig(frame_batch=8)
    triples = M.array_frame_generator(clip_bgr_u8, M.FrameGenConfig())
    out_dir = M.run_pixel_inpaint_batched(triples, "out/clip", sd, sd9,
                                          flow, cfg=cfg)
    raft, m = M.train_raft_synthetic(M.RAFTConfig(corr_dtype="float32"),
                                     h=512, w=768, init_params=raft)
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        keyframe_inpaint as KI
    KI.run(KI.VideoWorkspace("out/ws", frames=clip_bgr_u8), sd, sd9, flow,
           cfg=KI.KeyframeInpaintConfig(level_batch=4))
    img = M.txt2img(sd, prompt, negative, 512, 768)
    lat = M.img2img_invert(sd, image, prompt)
    sdd = M.create_model("sd15-depth", dtype=torch.bfloat16)
    img, _ = M.img2img_depth2img(sdd, depth, image, prompt, negative)
    big, lvl = M.upscale(M.create_model("sd-upscale"), x_low, prompt, "")
"""

_LAZY = {
    "create_model": ("sd_animation_optical_flow_tpu_torch.config",
                     "create_model"),
    "load_spec": ("sd_animation_optical_flow_tpu_torch.config", "load_spec"),
    "BundleSpec": ("sd_animation_optical_flow_tpu_torch.config",
                   "BundleSpec"),
    "StableDiffusionBundle": (
        "sd_animation_optical_flow_tpu_torch.pipelines.facades",
        "StableDiffusionBundle"),
    "img2img": ("sd_animation_optical_flow_tpu_torch.pipelines.facades",
                "img2img"),
    "img2img_inpaint": (
        "sd_animation_optical_flow_tpu_torch.pipelines.facades",
        "img2img_inpaint"),
    "img2img_inpaint_batch": (
        "sd_animation_optical_flow_tpu_torch.pipelines.facades",
        "img2img_inpaint_batch"),
    "img2img_latent_inpaint": (
        "sd_animation_optical_flow_tpu_torch.pipelines.facades",
        "img2img_latent_inpaint"),
    "txt2img": ("sd_animation_optical_flow_tpu_torch.pipelines.facades",
                "txt2img"),
    "img2img_invert": (
        "sd_animation_optical_flow_tpu_torch.pipelines.facades",
        "img2img_invert"),
    "img2img_depth2img": (
        "sd_animation_optical_flow_tpu_torch.pipelines.specializations",
        "img2img_depth2img"),
    "upscale": (
        "sd_animation_optical_flow_tpu_torch.pipelines.specializations",
        "upscale"),
    "StripConfig": ("sd_animation_optical_flow_tpu_torch.models.unet",
                    "StripConfig"),
    "FlowConfidenceConfig": (
        "sd_animation_optical_flow_tpu_torch.models.flowconf",
        "FlowConfidenceConfig"),
    "FlowConfidenceEstimator": (
        "sd_animation_optical_flow_tpu_torch.models.flowconf",
        "FlowConfidenceEstimator"),
    "load_flow_estimator": (
        "sd_animation_optical_flow_tpu_torch.utils.jax_params",
        "load_flow_estimator"),
    "PixelInpaintConfig": (
        "sd_animation_optical_flow_tpu_torch.pipelines.pixel_inpaint",
        "PixelInpaintConfig"),
    "run_pixel_inpaint": (
        "sd_animation_optical_flow_tpu_torch.pipelines.pixel_inpaint", "run"),
    "run_pixel_inpaint_batched": (
        "sd_animation_optical_flow_tpu_torch.pipelines.pixel_inpaint",
        "run_batched"),
    "run_pixel_inpaint_video": (
        "sd_animation_optical_flow_tpu_torch.pipelines.pixel_inpaint",
        "run_video"),
    "FrameGenConfig": (
        "sd_animation_optical_flow_tpu_torch.pipelines.keyframes",
        "FrameGenConfig"),
    "array_frame_generator": (
        "sd_animation_optical_flow_tpu_torch.pipelines.keyframes",
        "array_frame_generator"),
    "frame_generator": (
        "sd_animation_optical_flow_tpu_torch.pipelines.keyframes",
        "frame_generator"),
    "Tagger": ("sd_animation_optical_flow_tpu_torch.pipelines.tagger",
               "Tagger"),
    "compare_dirs": ("sd_animation_optical_flow_tpu_torch.utils.parity",
                     "compare_dirs"),
    "RAFTConfig": ("sd_animation_optical_flow_tpu_torch.models.raft",
                   "RAFTConfig"),
    "render_scene": (
        "sd_animation_optical_flow_tpu_torch.training.synthetic_flow",
        "render_scene"),
    "flow_train_step": (
        "sd_animation_optical_flow_tpu_torch.training.flow_train",
        "flow_train_step"),
    "uncertainty_train_step": (
        "sd_animation_optical_flow_tpu_torch.training.flow_train",
        "uncertainty_train_step"),
    "train_raft_synthetic": (
        "sd_animation_optical_flow_tpu_torch.training.uncertainty_pretrain",
        "train_raft_synthetic"),
    "train_head_synthetic": (
        "sd_animation_optical_flow_tpu_torch.training.uncertainty_pretrain",
        "train_head_synthetic"),
    "eval_epe": (
        "sd_animation_optical_flow_tpu_torch.training.uncertainty_pretrain",
        "eval_epe"),
    "evaluate_masks": (
        "sd_animation_optical_flow_tpu_torch.training.uncertainty_pretrain",
        "evaluate_masks"),
    "save_npz_tree": ("sd_animation_optical_flow_tpu_torch.utils.checkpoint",
                      "save_npz_tree"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(name)
