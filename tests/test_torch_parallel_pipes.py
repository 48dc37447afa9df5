"""Port parity: the serving side of ``parallel/`` in the pipelines — the
strip ``img2img(sp=)``, ``img2img_inpaint_batch(mesh=)``, the keyframe
pipeline's seed strip with ``cfg.sp`` and ``pixel_inpaint.run_batched``
with ``dp`` — on gloo ranks on the CPU (``tests/torch_parallel_ranks.py``,
world sizes 2 and 4 running at once), against the JAX package on the same
weights and the same noises (the port's draws replaced by the JAX
program's, rebuilt along its key splits).

The JAX side is each function's single-device run: JAX's own
``tests/test_parallel.py`` holds its sharded runs (the strip at :194, the
dp batch at :214, whose cases these are) to those, within 5e-4. Gates:
images within rtol = atol = 5e-4 of JAX's and the captured K/V within
5e-4 of max |JAX| (JAX's pipeline tolerance); the seed strip's uint8
frames within 1 LSB of JAX's (its floats agree to ~1e-6, so a pixel can
round either way); ``run_batched`` at dp 2 byte-equal to the port's dp 0
files, written by rank 0 alone."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sd_animation_optical_flow_tpu.models import clip as JCL
from sd_animation_optical_flow_tpu.models import raft as JR
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models import vae as JV
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.pipelines import facades as JF
from sd_animation_optical_flow_tpu.pipelines import keyframe_inpaint as JKI
from sd_animation_optical_flow_tpu.pipelines.tokenizer import \
    PromptTokenizer as JTok
from sd_animation_optical_flow_tpu_torch.models import clip as TCL
from sd_animation_optical_flow_tpu_torch.models import flowconf as TFC
from sd_animation_optical_flow_tpu_torch.models import raft as TR
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.models import vae as TV
from sd_animation_optical_flow_tpu_torch.pipelines import facades as TF
from sd_animation_optical_flow_tpu_torch.pipelines.tokenizer import \
    PromptTokenizer as TTok
from test_pipeline import _synthetic_frames
from test_torch_guidance import _img2img_noise
from test_torch_inpaint import jax_noise
from torch_parallel_ranks import Ranks
from torch_port_common import perturb_zero_convs, rel_err, to_port

TOL = 5e-4
WORLDS = (2, 4)
# the seed strip on the strip case's bundle, strength, steps and seed
KF_KW = dict(size=(32, 32), keep_every=1, denoising_strength=0.4,
             ddim_steps=4, seed=3)
PIXEL_KW = dict(denoising_strength=0.3, ddim_steps=10)


def _bundles(key, in_channels, heads):
    """A tiny SD bundle (VAE 16 x (1, 2), UNet 16 x (1, 2), CLIP 32 x 1) in
    both frameworks on shared weights, the output convs perturbed."""
    kv, ku, kc = jax.random.split(key, 3)
    vcfg = JV.VAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1)
    ucfg = JU.UNetConfig(in_channels=in_channels, model_channels=16,
                         channel_mult=(1, 2), attention_resolutions=(1,),
                         num_heads=heads, context_dim=32)
    ccfg = JCL.CLIPTextConfig(vocab_size=49408, width=32, layers=1, heads=2)
    with numpy_init():
        jsd = JF.StableDiffusionBundle(
            unet_params=JU.unet_init(ku, ucfg), unet_cfg=ucfg,
            vae_params=JV.vae_init(kv, vcfg), vae_cfg=vcfg,
            clip_params=JCL.clip_text_init(kc, ccfg), clip_cfg=ccfg,
            tokenizer=JTok(hf_name_or_path=None))
    perturb_zero_convs(jsd.unet_params, np.random.default_rng(in_channels))
    tsd = TF.StableDiffusionBundle(
        unet_params=to_port(jsd.unet_params),
        unet_cfg=TU.UNetConfig(**ucfg.__dict__),
        vae_params=to_port(jsd.vae_params),
        vae_cfg=TV.VAEConfig(**vcfg.__dict__),
        clip_params=to_port(jsd.clip_params),
        clip_cfg=TCL.CLIPTextConfig(**ccfg.__dict__),
        tokenizer=TTok(hf_name_or_path=None), device="cpu")
    return jsd, tsd


def _strip_case():
    """JAX tests/test_parallel.py:194: a 2-tile 'target' strip of 32 x 32
    tiles (latent 16 x 32), 8 heads, 4 DDIM steps at strength 0.4."""
    jsd, tsd = _bundles(jax.random.PRNGKey(21), 4, heads=8)
    img = np.random.default_rng(5).uniform(-1, 1, (1, 32, 64, 3)).astype(
        np.float32)
    lat = (1, 16, 32, 4)
    return jsd, {"sd": tsd, "img": img, "img2img_noise": {
        lat: _img2img_noise(3, lat, 1, target=False, pixel=False)}}


def _inpaint_case():
    """JAX tests/test_parallel.py:214: 8 frames of 32 x 32 on the 9-channel
    model, 4 DDIM steps at strength 0.3, no mask blur; here also with a
    per-frame reference_kv (two references' tokens a frame) and the K/V
    capture."""
    jsd9, tsd9 = _bundles(jax.random.PRNGKey(22), 9, heads=2)
    rng = np.random.default_rng(7)
    b = 8
    masks = np.zeros((b, 32, 32), np.float32)
    masks[:, 8:24, 8:24] = 1.0
    # the tiny UNet's six self-attentions: level 0 (16 x 16 tokens, 16
    # channels) but the middle block's (level 1, 32 channels)
    kv = [(rng.standard_normal((b, 2 * n, c)).astype(np.float32),
           rng.standard_normal((b, 2 * n, c)).astype(np.float32))
          for n, c in [(256, 16)] * 2 + [(64, 32)] + [(256, 16)] * 3]
    lat = (b, 16, 16, 4)
    return jsd9, {
        "sd9": tsd9, "imgs": rng.uniform(-1, 1, (b, 32, 32, 3)).astype(
            np.float32),
        "refs": rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
        "masks": masks, "texts": [f"p{i % 3}" for i in range(b)],
        "reference_kv": kv, "inpaint_noise": {
            lat: jax_noise(11, lat, 1, 1, "ddim", tile_noise=True,
                           has_reference=True)}}


def _pixel_case(tmp, tsd, tsd9):
    """Five frames (a key frame, then four) for run_batched with two
    frames a rank, the strip and inpaint cases' bundles and a tiny random
    RAFT."""
    rcfg = JR.RAFTConfig(iters=2, corr_levels=2, corr_radius=2)
    with numpy_init():
        rp = JR.raft_init(jax.random.PRNGKey(11), rcfg)
    est = TFC.FlowConfidenceEstimator(
        to_port(rp), TFC.FlowConfidenceConfig(
            raft=TR.RAFTConfig(**rcfg.__dict__)), device="cpu")
    triples = [(f, i == 0, i) for i, f in enumerate(_synthetic_frames(n=5))]
    return {"sd": tsd, "sd9": tsd9, "est": est, "triples": triples,
            "per_rank": 2, "kw": PIXEL_KW, "dir": str(tmp)}


def _seed_case(tmp, strip):
    """The keyframe pipeline's 2-frame seed strip ('mutual') of 32 x 32
    frames on the strip case's bundle (latent 16 x 32), its strength,
    steps and seed."""
    return {"sd": strip["sd"], "frames": _synthetic_frames(4, 32, 32),
            "seeds": [0, 3], "kw": KF_KW, "dir": str(tmp),
            "img2img_noise": strip["img2img_noise"]}


def _jax_refs(jsd, jsd9, cases, tmp):
    strip = cases["strip_img2img"]
    out, kv = JF.img2img(jsd, jnp.asarray(strip["img"]), "a", "b", 0.4,
                         ddim_steps=4, seed=3, capture_kv=True,
                         strip=JU.StripConfig(n_tiles=2, mode="target"))
    inp = cases["inpaint_batch"]
    bout, bkv = JF.img2img_inpaint_batch(
        jsd9, inp["imgs"], inp["texts"], "n", inp["masks"], inp["refs"],
        denoising_strength=0.3, ddim_steps=4, mask_blur=0, seed=11,
        reference_kv=tuple((jnp.asarray(k), jnp.asarray(v))
                           for k, v in inp["reference_kv"]),
        capture_kv=True)
    seed = cases["seed_strip"]
    ws = JKI.VideoWorkspace(str(tmp / "jax_ws"), frames=seed["frames"],
                            size=(32, 32), keep_every=1)
    frames, skv = JKI.generate_seed_frames(
        jsd, None, ws, JKI.FrameIndices(seed["seeds"]),
        JKI.KeyframeInpaintConfig(**KF_KW))
    return {"strip_img2img": (out, kv), "inpaint_batch": (bout, bkv),
            "seed_strip": (frames, skv)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results {world: {job: [rank 0's, ...]}}, JAX results, cases):
    the ranks run while JAX computes its side here."""
    tmp = tmp_path_factory.mktemp("pipes")
    jsd, strip = _strip_case()
    jsd9, inpaint = _inpaint_case()
    cases = {"strip_img2img": strip, "inpaint_batch": inpaint,
             "seed_strip": _seed_case(tmp / "seed", strip),
             "run_batched": _pixel_case(tmp / "pixel", strip["sd"],
                                        inpaint["sd9"])}
    started = {
        2: Ranks(2, tmp / "w2", ["strip_img2img", "inpaint_batch",
                                 "run_batched_dp", "seed_strip"], cases),
        4: Ranks(4, tmp / "w4", ["strip_img2img", "inpaint_batch"],
                 {k: cases[k] for k in ("strip_img2img", "inpaint_batch")})}
    refs = _jax_refs(jsd, jsd9, cases, tmp)
    return {w: r.results() for w, r in started.items()}, refs, cases


def _kv_close(got, want):
    assert len(got) == len(want)
    for (k, v), (wk, wv) in zip(got, want):
        assert k.shape == wk.shape and v.shape == wv.shape
        assert rel_err(k, wk) < TOL and rel_err(v, wv) < TOL


@pytest.mark.parametrize("world", WORLDS)
def test_strip_img2img_sp_matches_jax(runs, world):
    """The strip img2img with ``sp`` (rows, Ulysses with the MFR strip
    attention, the capture pass's K/V gathered): every rank returns JAX's
    image and K/V."""
    ranks, refs, _ = runs
    want, want_kv = refs["strip_img2img"]
    for r in ranks[world]["strip_img2img"]:
        np.testing.assert_allclose(r["out"], np.asarray(want), rtol=TOL,
                                   atol=TOL)
        _kv_close(r["kv"], want_kv)


@pytest.mark.parametrize("world", WORLDS)
def test_inpaint_batch_mesh_matches_jax(runs, world):
    """``img2img_inpaint_batch(mesh=)`` at dp 2 and 4 (4 and 2 frames a
    rank, each with its slice of the per-frame reference_kv): every rank
    returns JAX's whole batch and its captured K/V."""
    ranks, refs, _ = runs
    want, want_kv = refs["inpaint_batch"]
    for r in ranks[world]["inpaint_batch"]:
        assert r["out"].shape == (8, 32, 32, 3)
        np.testing.assert_allclose(r["out"], np.asarray(want), rtol=TOL,
                                   atol=TOL)
        _kv_close(r["kv"], want_kv)


def test_seed_strip_sp_matches_jax(runs):
    """``generate_seed_frames`` with ``cfg.sp`` at world 2 (each rank in a
    workspace of its own): JAX's frames within 1 LSB, its K/V shapes."""
    ranks, refs, _ = runs
    want, want_kv = refs["seed_strip"]
    for r in ranks[2]["seed_strip"]:
        assert len(r["frames"]) == len(want) == 2
        for got, ref in zip(r["frames"], want):
            diff = np.abs(got.astype(np.int16) - np.asarray(ref, np.int16))
            assert got.shape == (32, 32, 3) and diff.max() <= 1
        assert r["kv_shapes"] == [tuple(k.shape) for k, _ in want_kv]


def test_run_batched_dp_writes_the_dp0_files_from_rank_0(runs):
    """``run_batched`` at dp 2 (frame batch 4: two frames a rank) writes
    the files of the same frames at dp 0 (frame batch 2, RAFT two pairs a
    call in both, so every call sees the batch it sees at dp 2: the CPU's
    f32 rounding depends on it), byte for byte, the key frame's included;
    the other rank writes nothing, not even its directory."""
    ranks, _, _ = runs
    rank0, rank1 = ranks[2]["run_batched_dp"]
    assert len(rank0["dp0"]) == 15 and rank0["files"] == rank0["dp0"]
    assert rank1["files"] is None and not os.path.exists(rank1["out_dir"])
