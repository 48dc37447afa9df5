"""Plain PyTorch Stable Diffusion 1.x: the UNet, the KL VAE and the CLIP
text tower, under the CompVis/ldm and Hugging Face parameter names of the
published checkpoints. Written from the architecture (CompVis
``ldm/modules/diffusionmodules/openaimodel.py``, ``model.py``,
``attention.py``; OpenAI CLIP ViT-L/14's text tower), NCHW, no kernel, no
cache, no batching trick. It imports nothing of the program.

``quantize_fp8(module)`` turns a module into the benchmark's control: every
convolution's and linear layer's weight and input rounded to float8 e4m3
with one scale per tensor, the next precision below the bfloat16 the
configuration serves.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
CLIP_PREFIX = "cond_stage_model.transformer.text_model."


def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, ch, out_ch, emb_dim, groups=32):
        super().__init__()
        self.in_layers = nn.Sequential(
            nn.GroupNorm(groups, ch), nn.SiLU(),
            nn.Conv2d(ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_dim, out_ch))
        self.out_layers = nn.Sequential(
            nn.GroupNorm(groups, out_ch), nn.SiLU(), nn.Dropout(0.0),
            nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = nn.Conv2d(ch, out_ch, 1) if ch != out_ch \
            else nn.Identity()

    def forward(self, x, emb):
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None]
        h = self.out_layers(h)
        return self.skip_connection(x) + h


class CrossAttention(nn.Module):
    def __init__(self, dim, context_dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim, dim, bias=False)
        self.to_out = nn.Sequential(nn.Linear(dim, dim), nn.Dropout(0.0))

    def forward(self, x, context=None):
        context = x if context is None else context
        b, n, c = x.shape
        h = self.heads
        q = self.to_q(x).view(b, n, h, c // h).transpose(1, 2)
        k = self.to_k(context).view(b, -1, h, c // h).transpose(1, 2)
        v = self.to_v(context).view(b, -1, h, c // h).transpose(1, 2)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, c))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, context_dim):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads)
        self.ff = nn.Module()
        self.ff.net = nn.Sequential(GEGLU(dim, dim * 4), nn.Dropout(0.0),
                                    nn.Linear(dim * 4, dim))
        self.attn2 = CrossAttention(dim, context_dim, heads)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff.net(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, ch, heads, context_dim, groups=32):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, heads, context_dim)])
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x, context):
        b, c, hh, ww = x.shape
        res = x
        x = self.proj_in(self.norm(x))
        x = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for blk in self.transformer_blocks:
            x = blk(x, context)
        x = x.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.proj_out(x) + res


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet(nn.Module):
    """The SD-1.x UNet under ldm names (``input_blocks.i.j`` ...)."""

    def __init__(self, in_channels=4, out_channels=4, model_channels=320,
                 num_res_blocks=2, attention_resolutions=(4, 2, 1),
                 channel_mult=(1, 2, 4, 4), num_heads=8, context_dim=768):
        super().__init__()
        mc = model_channels
        ted = mc * 4
        self.model_channels = mc
        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(),
                                        nn.Linear(ted, ted))
        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([nn.Conv2d(in_channels, mc, 3, padding=1)])])
        ch, chans, ds = mc, [mc], 1
        for lvl, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                mods = [ResBlock(ch, mult * mc, ted)]
                ch = mult * mc
                if ds in attention_resolutions:
                    mods.append(SpatialTransformer(ch, num_heads, context_dim))
                self.input_blocks.append(nn.ModuleList(mods))
                chans.append(ch)
            if lvl != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([
            ResBlock(ch, ch, ted),
            SpatialTransformer(ch, num_heads, context_dim),
            ResBlock(ch, ch, ted)])
        self.output_blocks = nn.ModuleList()
        for lvl, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                mods = [ResBlock(ch + chans.pop(), mult * mc, ted)]
                ch = mult * mc
                if ds in attention_resolutions:
                    mods.append(SpatialTransformer(ch, num_heads, context_dim))
                if lvl != 0 and i == num_res_blocks:
                    mods.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(mods))
        self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                 nn.Conv2d(ch, out_channels, 3, padding=1))

    @staticmethod
    def _run(mods, h, emb, ctx):
        for m in mods:
            if isinstance(m, ResBlock):
                h = m(h, emb)
            elif isinstance(m, SpatialTransformer):
                h = m(h, ctx)
            else:
                h = m(h)
        return h

    def forward(self, x, t, context):
        emb = self.time_embed(timestep_embedding(t, self.model_channels))
        hs, h = [], x
        for mods in self.input_blocks:
            h = self._run(mods, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context)
        for mods in self.output_blocks:
            h = self._run(mods, torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h)


class VAEResnetBlock(nn.Module):
    def __init__(self, ch, out_ch):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, ch, eps=1e-6)
        self.conv1 = nn.Conv2d(ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if ch != out_ch:
            self.nin_shortcut = nn.Conv2d(ch, out_ch, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.q = nn.Conv2d(ch, ch, 1)
        self.k = nn.Conv2d(ch, ch, 1)
        self.v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q = self.q(h).view(b, c, -1).permute(0, 2, 1)
        k = self.k(h).view(b, c, -1)
        v = self.v(h).view(b, c, -1)
        w = torch.softmax(torch.bmm(q, k) / math.sqrt(c), dim=-1)
        out = torch.bmm(v, w.transpose(1, 2)).view(b, c, hh, ww)
        return x + self.proj_out(out)


class VAEEncoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                 in_channels=3, z_channels=4):
        super().__init__()
        chs = [ch * m for m in ch_mult]
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        self.down = nn.ModuleList()
        in_ch = ch
        for lvl, out_ch in enumerate(chs):
            level = nn.Module()
            level.block = nn.ModuleList(
                [VAEResnetBlock(in_ch if b == 0 else out_ch, out_ch)
                 for b in range(num_res_blocks)])
            in_ch = out_ch
            if lvl != len(chs) - 1:
                level.downsample = nn.Module()
                level.downsample.conv = nn.Conv2d(in_ch, in_ch, 3, stride=2)
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = VAEResnetBlock(in_ch, in_ch)
        self.mid.attn_1 = VAEAttnBlock(in_ch)
        self.mid.block_2 = VAEResnetBlock(in_ch, in_ch)
        self.norm_out = nn.GroupNorm(32, in_ch, eps=1e-6)
        self.conv_out = nn.Conv2d(in_ch, 2 * z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for lvl in self.down:
            for blk in lvl.block:
                h = blk(h)
            if hasattr(lvl, "downsample"):
                # ldm pads (0, 1) on the right and bottom before the stride
                h = lvl.downsample.conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class VAEDecoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                 out_ch=3, z_channels=4):
        super().__init__()
        chs = [ch * m for m in ch_mult]
        block_in = chs[-1]
        self.conv_in = nn.Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = VAEResnetBlock(block_in, block_in)
        self.mid.attn_1 = VAEAttnBlock(block_in)
        self.mid.block_2 = VAEResnetBlock(block_in, block_in)
        self.up = nn.ModuleList([nn.Module() for _ in chs])
        for lvl in reversed(range(len(chs))):
            level = self.up[lvl]
            level.block = nn.ModuleList(
                [VAEResnetBlock(block_in if b == 0 else chs[lvl], chs[lvl])
                 for b in range(num_res_blocks + 1)])
            block_in = chs[lvl]
            if lvl != 0:
                level.upsample = nn.Module()
                level.upsample.conv = nn.Conv2d(block_in, block_in, 3,
                                                padding=1)
        self.norm_out = nn.GroupNorm(32, block_in, eps=1e-6)
        self.conv_out = nn.Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for lvl in reversed(range(len(self.up))):
            level = self.up[lvl]
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = level.upsample.conv(
                    F.interpolate(h, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.norm_out(h)))


class VAE(nn.Module):
    """The KL autoencoder with the latent scale factor: ``encode`` takes
    the posterior sample ``mean + std * noise``."""

    def __init__(self, scale_factor=0.18215, z_channels=4, **kw):
        super().__init__()
        self.scale_factor = scale_factor
        self.encoder = VAEEncoder(z_channels=z_channels, **kw)
        self.decoder = VAEDecoder(z_channels=z_channels, **kw)
        self.quant_conv = nn.Conv2d(2 * z_channels, 2 * z_channels, 1)
        self.post_quant_conv = nn.Conv2d(z_channels, z_channels, 1)

    def encode(self, x, noise):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        return z * self.scale_factor

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z / self.scale_factor))


class CLIPLayer(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.layer_norm1 = nn.LayerNorm(width)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(width, width))
        self.layer_norm2 = nn.LayerNorm(width)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(width, 4 * width)
        self.mlp.fc2 = nn.Linear(4 * width, width)

    def forward(self, x):
        b, n, c = x.shape
        a = self.self_attn
        h = self.layer_norm1(x)
        split = lambda t: t.view(b, n, self.heads, -1).transpose(1, 2)
        o = F.scaled_dot_product_attention(
            split(a.q_proj(h)), split(a.k_proj(h)), split(a.v_proj(h)),
            is_causal=True)
        x = x + a.out_proj(o.transpose(1, 2).reshape(b, n, c))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))


class CLIPText(nn.Module):
    """CLIP ViT-L/14's text tower (HF ``CLIPTextModel`` names): token and
    position embeddings, pre-LN causal layers with quick-GELU, the final
    layer norm over every position (the conditioning SD-1.x reads)."""

    def __init__(self, vocab_size=49408, max_position=77, width=768,
                 layers=12, heads=12):
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(vocab_size, width)
        self.embeddings.position_embedding = nn.Embedding(max_position, width)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [CLIPLayer(width, heads) for _ in range(layers)])
        self.final_layer_norm = nn.LayerNorm(width)

    def forward(self, ids):
        x = self.embeddings.token_embedding(ids)
        x = x + self.embeddings.position_embedding.weight[None, :ids.shape[1]]
        for layer in self.encoder.layers:
            x = layer(x)
        return self.final_layer_norm(x)


def build_modules(cfg: dict, device="meta"):
    """The configuration's modules, uninitialised on ``device``:
    {'unet': 4-channel UNet, 'unet9': the 9-channel inpainting UNet,
    'vae', 'clip'} (one VAE and one text tower serve both UNets, as the
    inpainting checkpoint's are SD-1.5's)."""
    with torch.device(device):
        u = dict(cfg["unet"])
        out = {"unet": UNet(in_channels=4, **u),
               "unet9": UNet(in_channels=9, **u),
               "vae": VAE(scale_factor=cfg["scale_factor"], **cfg["vae"]),
               "clip": CLIPText(**cfg["clip"])}
    return out


def load(modules: dict, state: dict):
    """Fill ``modules`` from ``state`` ({part: {parameter name: tensor}},
    the names of ``named_parameters``) in float32."""
    for part, mod in modules.items():
        for name, _ in list(mod.named_parameters()):
            *path, leaf = name.split(".")
            owner = mod
            for p in path:
                owner = getattr(owner, p)
            setattr(owner, leaf, nn.Parameter(state[part][name].float(),
                                              requires_grad=False))
    return modules


def fp8_round(t):
    """Round to float8 e4m3 with one scale per tensor (amax to 448)."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    s = 448.0 / amax
    return ((t * s).clamp(-448.0, 448.0).to(torch.float8_e4m3fn)
            .to(t.dtype) / s)


def quantize_fp8(module: nn.Module) -> nn.Module:
    """The control: every Conv2d / Linear weight rounded to e4m3 now, and
    its input rounded on each call."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.data = fp8_round(m.weight.data)
            m.register_forward_pre_hook(lambda _m, args: (fp8_round(args[0]),)
                                        + tuple(args[1:]))
    return module
