"""The pixel-inpaint pipeline's frames, recomputed in plain PyTorch.

A key frame is SD img2img at the configured strength: VAE encode (the
posterior sample), the DDIM forward noising to step t_enc, t_enc
eta-0 DDIM steps with classifier-free guidance, VAE decode. A non-key
frame is the AI key frame warped along the RAFT flow from the key frame
to it (cv2 bicubic), the mask dilate(confidence < threshold), the mask
blurred and composited with the raw frame, and the 9-channel inpainting
model's img2img with the known region re-noised before every step and
composited once more at the end (the reference's ``ofgen_pixel_inpaint``
with its ``guided_ldm`` sampler).

The noises are the seeded draws a user's run makes from its ``seed``: a
``torch.Generator`` on the device seeded with it, [1, h, w, 4] latents
in the order of use (key frame: the encode's posterior noise, the
forward noise; inpaint: the two encodes' posterior noises, the forward
noise, one re-noise a step). The prompts and the tokenizer's fallback
(word hashing into the vocabulary, three chunks of 77) are the
configuration's. Nothing here imports the program.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

BOS, EOS, PAD = 49406, 49407, 49407
CHUNKS, CHUNK_LEN = 3, 77


@dataclass(frozen=True)
class PixelSettings:
    """What a run of the pipeline states (the configuration's file)."""
    prompt: str
    negative_prompt: str
    strength: float
    ddim_steps: int
    cfg_scale: float
    confidence_thres: float
    mask_dilate: int
    mask_blur: int
    timesteps: int
    linear_start: float
    linear_end: float

    @classmethod
    def from_config(cls, cfg: dict) -> "PixelSettings":
        p = cfg["pipeline"]
        s = cfg["schedule"]
        return cls(p["prompt"], p["negative_prompt"], p["strength"],
                   p["ddim_steps"], p["cfg_scale"], p["confidence_thres"],
                   p["mask_dilate"], p["mask_blur"], s["timesteps"],
                   s["linear_start"], s["linear_end"])


def token_ids(text: str, vocab: int = 49408) -> torch.Tensor:
    """[3, 77] ids: the CLIP BPE when its vocabulary is on this machine,
    else word hashing into the vocabulary; each chunk of up to 75 ids
    wrapped in BOS / EOS and padded."""
    text = text.replace("_", " ")
    ids = None
    try:
        from transformers import CLIPTokenizer
        tok = CLIPTokenizer.from_pretrained("openai/clip-vit-large-patch14",
                                            local_files_only=True)
        ids = tok(text, truncation=False, add_special_tokens=False)[
            "input_ids"]
    except Exception:           # no transformers or no local vocabulary
        words = re.findall(r"[a-zA-Z0-9']+|[^\sa-zA-Z0-9]", text.lower())
        ids = [int(hashlib.sha1(w.encode()).hexdigest(), 16) % (vocab - 3)
               + 1 for w in words]
    rows = []
    for i in range(CHUNKS):
        part = [BOS] + list(ids[75 * i:75 * (i + 1)]) + [EOS]
        rows.append(part[:CHUNK_LEN] + [PAD] * (CHUNK_LEN - len(part)))
    return torch.tensor(rows, dtype=torch.long)


def text_context(clip, text: str, device) -> torch.Tensor:
    """[1, 231, width]: the three chunks encoded and concatenated."""
    ids = token_ids(text, clip.embeddings.token_embedding.num_embeddings)
    ids = ids.clamp(max=clip.embeddings.token_embedding.num_embeddings - 1)
    return clip(ids.to(device)).reshape(1, CHUNKS * CHUNK_LEN, -1)


def alphas_cumprod(s: PixelSettings) -> np.ndarray:
    betas = np.linspace(s.linear_start ** 0.5, s.linear_end ** 0.5,
                        s.timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32).astype(np.float64)


def t_enc(s: PixelSettings) -> int:
    return int(min(s.strength, 0.999) * s.ddim_steps)


class Sampler:
    """Eta-0 DDIM over the uniform sub-schedule (every T / steps timesteps,
    shifted by one), entered at step t_enc."""

    def __init__(self, s: PixelSettings):
        self.s = s
        ac = alphas_cumprod(s)
        self.ac = ac
        c = s.timesteps // s.ddim_steps
        self.ts = (np.arange(0, s.timesteps, c)[:s.ddim_steps] + 1)
        self.a = ac[self.ts]
        self.a_prev = np.concatenate([ac[:1], ac[self.ts[:-1]]])
        self.t_enc = t_enc(s)

    def forward_noise(self, x0, noise):
        a = self.a[self.t_enc]
        return float(np.sqrt(a)) * x0 + float(np.sqrt(1.0 - a)) * noise

    def decode(self, eps_fn, x, *, init=None, nmask=None, renoise=None):
        """The t_enc steps down to 0. ``eps_fn(x, t)`` is the guided model;
        with ``init`` / ``nmask`` / ``renoise`` [S, ...] the known region
        (nmask 0) is re-noised to each step's level before the model call
        and composited back at the end."""
        for k, i in enumerate(range(self.t_enc - 1, -1, -1)):
            t = int(self.ts[i])
            a, a_prev = self.a[i], self.a_prev[i]
            if init is not None:
                noised = float(np.sqrt(self.ac[t])) * init \
                    + float(np.sqrt(1.0 - self.ac[t])) * renoise[k]
                x = (1.0 - nmask) * noised + nmask * x
            e = eps_fn(x, t)
            x0 = (x - float(np.sqrt(1.0 - a)) * e) / float(np.sqrt(a))
            x = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(1.0 - a_prev)) * e
        if init is not None:
            x = init * (1.0 - nmask) + x * nmask
        return x


def guided(unet, ctx_c, ctx_u, scale, concat=None):
    """eps(x, t) with classifier-free guidance: [uncond | cond] in one
    batch of 2B, ``concat`` channels appended to x."""
    def fn(x, t):
        b = x.shape[0]
        xin = x if concat is None else torch.cat([x, concat], 1)
        tt = torch.full((2 * b,), t, device=x.device, dtype=torch.long)
        ctx = torch.cat([ctx_u.expand(b, -1, -1), ctx_c.expand(b, -1, -1)])
        e_u, e_c = unet(torch.cat([xin, xin]), tt, ctx).chunk(2)
        return e_u + scale * (e_c - e_u)
    return fn


def draws(seed: int, latent_hw, n: int, device, steps: int = 0):
    """The run's seeded draws: ``n`` [1, 4, h, w] latents, then a stack of
    ``steps`` more (NCHW views of the [1, h, w, 4] draws)."""
    h, w = latent_hw
    g = torch.Generator(device).manual_seed(seed)
    nchw = lambda t: t.movedim(-1, -3)
    out = [nchw(torch.randn((1, h, w, 4), generator=g, device=device))
           for _ in range(n)]
    if steps:
        out.append(nchw(torch.randn((steps, 1, h, w, 4), generator=g,
                                    device=device)))
    return out


def bgr_u8_to_model(frames_bgr):
    """uint8 BGR [B, H, W, 3] (tensor) -> RGB [-1, 1] NCHW float32."""
    return frames_bgr.flip(-1).permute(0, 3, 1, 2).float() / 127.5 - 1.0


def model_to_bgr_u8(img):
    """[-1, 1] RGB NCHW -> uint8 BGR [B, H, W, 3] (clipped, truncated)."""
    x = torch.floor((img.clamp(-1, 1) * 127.5 + 127.5).clamp(0, 255))
    return x.permute(0, 2, 3, 1).flip(-1).to(torch.uint8)


def key_frame(models, ctx, s: PixelSettings, frame_bgr, seed: int):
    """The AI key frame (uint8 BGR [H, W, 3]) of one raw key frame."""
    dev = frame_bgr.device
    h, w = frame_bgr.shape[0] // 8, frame_bgr.shape[1] // 8
    enc, fwd = draws(seed, (h, w), 2, dev)
    sam = Sampler(s)
    x0 = models["vae"].encode(bgr_u8_to_model(frame_bgr[None]), enc)
    x = sam.decode(guided(models["unet"], ctx["c"], ctx["u"], s.cfg_scale),
                   sam.forward_noise(x0, fwd))
    return model_to_bgr_u8(models["vae"].decode(x))[0]


def cubic_weights(f, a=-0.75):
    w0 = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
    w1 = ((a + 2) * f - (a + 3)) * f * f + 1
    g = 1 - f
    w2 = ((a + 2) * g - (a + 3)) * g * g + 1
    return w0, w1, w2, 1.0 - w0 - w1 - w2


def warp_cubic(img, flow):
    """cv2.remap(INTER_CUBIC, BORDER_CONSTANT 0) of img [H, W, C] float at
    (x + flow_x, y + flow_y); flow [2, H, W]."""
    h, w, c = img.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=img.device,
                                         dtype=torch.float32),
                            torch.arange(w, device=img.device,
                                         dtype=torch.float32), indexing="ij")
    mx, my = xs + flow[0], ys + flow[1]
    x0, y0 = torch.floor(mx), torch.floor(my)
    wx, wy = cubic_weights(mx - x0), cubic_weights(my - y0)
    flat = img.reshape(h * w, c)
    out = torch.zeros_like(img)
    for j in range(4):
        iy = y0.long() + j - 1
        for i in range(4):
            ix = x0.long() + i - 1
            ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            tap = flat[(iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1))]
            out = out + torch.where(ok[..., None], tap, 0.0) \
                * (wx[i] * wy[j])[..., None]
    return out


def ellipse(size: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (size, size))."""
    r = c = size // 2
    k = np.zeros((size, size), np.float32)
    if r == 0:
        return k + 1
    for i in range(size):
        dx = int(np.rint(c * np.sqrt((r * r - (i - r) ** 2) / (r * r))))
        k[i, max(c - dx, 0):min(c + dx + 1, size)] = 1
    return k


def gaussian_blur(m, sigma: float):
    """cv2.GaussianBlur(ksize 0 -> round(3 sigma) * 2 + 1, edge replicate)
    of m [B, 1, H, W]."""
    n = int(round(sigma * 3)) * 2 + 1
    x = np.arange(n) - (n - 1) / 2
    k = np.exp(-x ** 2 / (2 * sigma ** 2))
    k = torch.tensor(k / k.sum(), dtype=torch.float32, device=m.device)
    r = n // 2
    m = F.conv2d(F.pad(m, (0, 0, r, r), mode="replicate"),
                 k.view(1, 1, n, 1))
    return F.conv2d(F.pad(m, (r, r, 0, 0), mode="replicate"),
                    k.view(1, 1, 1, n))


def non_key_frames(models, raft_p, head_p, ctx, s: PixelSettings, key_raw,
                   key_ai, frames, seed: int, flow_round=None):
    """The AI frames (uint8 BGR [B, H, W, 3]) of raw non-key ``frames``
    [B, H, W, 3] (uint8 BGR) in the segment of raw key frame ``key_raw``
    whose AI frame is ``key_ai``, with the flow [B, 2, H, W] and
    confidence [B, H, W] they were warped and masked by and the share of
    each frame's pixels that the inpaint fills [B]. ``flow_round``: the
    flow's products' operands rounded by it (the control)."""
    from .raft import flow_confidence
    dev = frames.device
    b, hh, ww, _ = frames.shape
    rgb = lambda f: f.flip(-1).permute(0, 3, 1, 2).float()
    flow, conf = flow_confidence(raft_p, head_p,
                                 rgb(key_raw[None]).expand(b, -1, -1, -1),
                                 rgb(frames), round_fn=flow_round)
    ai = key_ai.float()
    warped = torch.stack([warp_cubic(ai, f) for f in flow]).clamp(0, 255)
    low = (conf < s.confidence_thres).float()[:, None]
    k = torch.tensor(ellipse(s.mask_dilate), device=dev)[None, None]
    r = s.mask_dilate // 2
    mask = (F.conv2d(F.pad(low, (r, r, r, r)), k) > 0).float()
    soft = gaussian_blur(mask, float(s.mask_blur)).clamp(0, 1) \
        if s.mask_blur > 0 else mask
    image = warped.flip(-1).permute(0, 3, 1, 2) / 127.5 - 1.0
    ref = bgr_u8_to_model(frames)
    composited = image * (1 - soft) + ref * soft
    h, w = hh // 8, ww // 8
    enc, cdt, fwd, renoise = draws(seed, (h, w), 3, dev, steps=t_enc(s))
    vae = models["vae"]
    init = vae.encode(composited, enc)
    nmask = torch.round(F.interpolate(soft, size=(h, w), mode="bilinear",
                                      align_corners=False))
    cmask = torch.round(soft)
    cond_latent = vae.encode(composited * (1 - cmask), cdt)
    concat = torch.cat([cmask[:, :, 4::8, 4::8], cond_latent], 1)
    sam = Sampler(s)
    x = sam.decode(guided(models["unet9"], ctx["c"], ctx["u"], s.cfg_scale,
                          concat),
                   sam.forward_noise(init, fwd), init=init, nmask=nmask,
                   renoise=renoise)
    return (model_to_bgr_u8(vae.decode(x)), flow, conf,
            cmask.mean((1, 2, 3)))
