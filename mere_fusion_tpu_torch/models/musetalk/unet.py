"""Audio-conditioned UNet (stable-diffusion family) in PyTorch, NCHW.

Port of mere_fusion_tpu/models/musetalk/unet.py: SD-1.5 block layout with
in_channels=8 (masked + reference latents), out_channels=4 and
cross-attention over 384-d whisper features, run by MuseTalk as a one-step
regressor at timestep 0. Module names follow the diffusers
``UNet2DConditionModel`` state dict (``down_blocks.{i}.resnets.{j}``,
``down_blocks.{i}.attentions.{j}.transformer_blocks.0.attn1.to_q``,
``time_embedding.linear_1``, ...), so the MuseTalk torch checkpoint loads
with ``load_state_dict(strict=True)``.

Self-attention at sequence length >= 512 goes through kernel K1
(``ops/attention.self_attention``), exactly where the JAX package calls its
Pallas kernel; every other attention stays plain torch. GroupNorm eps is
``cfg.norm_eps`` (1e-5) in the resnets and 1e-6 in the transformers' norm.

``UNet2DCondition(int8=True)`` (the JAX ``int8``) runs the resnets' convs
and the down- and upsample convs on the int8 route (``QConv``, kernel K5);
``conv_in``, ``conv_out``, attention, ``proj_in``/``proj_out`` and the time
MLP stay float. ``set_int8`` switches a built model without a second copy
of its weights.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mere_fusion_tpu_torch.models.musetalk.vae import (
    Downsample2D,
    ResnetBlock2D,
    Upsample2D,
    _Block,
    set_quant,
)
from mere_fusion_tpu_torch.ops import attention


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    down_block_types: tuple = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: tuple = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    attention_head_dim: int = 8      # = number of heads (SD-1.5 convention)
    cross_attention_dim: int = 384
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @classmethod
    def from_json(cls, path: str) -> "UNetConfig":
        with open(path) as f:
            raw = json.load(f)
        keys = set(cls.__dataclass_fields__)
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in raw.items() if k in keys})


MUSETALK_UNET = UNetConfig()

# Attention implementation (mirrors the JAX switch):
#   "auto"  — K1 (ops/attention.self_attention) for self-attention with
#             lq >= 512: the CUDA kernel on the card, the plain version on
#             the CPU; plain torch everywhere else
#   "plain" — plain torch for every attention (the comparison path)
ATTN_IMPL = "auto"


def positional_encoding(x: torch.Tensor) -> torch.Tensor:
    """Sinusoidal PE added to the audio feature sequence [B, L, D]."""
    seq_len, d_model = x.shape[1], x.shape[2]
    position = np.arange(seq_len)[:, None].astype(np.float32)
    div_term = np.exp(np.arange(0, d_model, 2).astype(np.float32)
                      * (-math.log(10000.0) / d_model))
    pe = np.zeros((seq_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return x + torch.from_numpy(pe).to(x.device, x.dtype)[None]


def timestep_embedding(t: torch.Tensor, dim: int, flip: bool, shift: float) -> torch.Tensor:
    """diffusers get_timestep_embedding semantics. t: [B] → [B, dim] f32."""
    half = dim // 2
    exponent = -math.log(10000.0) * np.arange(half, dtype=np.float32) / (half - shift)
    freqs = torch.from_numpy(np.exp(exponent).astype(np.float32)).to(t.device)
    args = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip else [sin, cos], dim=-1)


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        is_self = context is None
        context = x if is_self else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        b, lq, inner = q.shape
        lk = k.shape[1]
        hd = inner // self.heads
        q = q.reshape(b, lq, self.heads, hd).transpose(1, 2).contiguous()
        k = k.reshape(b, lk, self.heads, hd).transpose(1, 2).contiguous()
        v = v.reshape(b, lk, self.heads, hd).transpose(1, 2).contiguous()
        if ATTN_IMPL == "auto" and is_self and lq >= 512:
            out = attention.self_attention(q, k, v)
        elif ATTN_IMPL in ("auto", "plain"):
            out = attention.self_attention_plain(q, k, v)
        else:
            raise ValueError(f"unknown ATTN_IMPL {ATTN_IMPL!r}")
        return self.to_out[0](out.transpose(1, 2).reshape(b, lq, inner))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, heads)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = _Block()
        self.ff.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                     nn.Linear(dim * 4, dim)])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff.net[2](self.ff.net[0](self.norm3(x))) + x


class Transformer2D(nn.Module):
    """GN → conv1x1 in → one transformer block → conv1x1 out + residual."""

    def __init__(self, c: int, context_dim: int, heads: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.proj_in = nn.Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(c, context_dim, heads)])
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.transformer_blocks[0](y, context)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + x


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig | None = None, int8: bool = False):
        super().__init__()
        self.cfg = cfg = cfg or MUSETALK_UNET
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        heads, ctx = cfg.attention_head_dim, cfg.cross_attention_dim
        chans = cfg.block_out_channels
        tdim = chans[0] * 4

        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.time_embedding = _Block()
        self.time_embedding.linear_1 = nn.Linear(chans[0], tdim)
        self.time_embedding.linear_2 = nn.Linear(tdim, tdim)

        skip_c = [chans[0]]
        c = chans[0]
        self.down_blocks = nn.ModuleList()
        for i, (btype, ch) in enumerate(zip(cfg.down_block_types, chans)):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(c, ch, g, eps, tdim))
                c = ch
                if btype == "CrossAttnDownBlock2D":
                    blk.attentions.append(Transformer2D(ch, ctx, heads, g))
                skip_c.append(ch)
            if i < len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch, asymmetric=False)])
                skip_c.append(ch)
            self.down_blocks.append(blk)

        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock2D(c, c, g, eps, tdim), ResnetBlock2D(c, c, g, eps, tdim)])
        self.mid_block.attentions = nn.ModuleList([Transformer2D(c, ctx, heads, g)])

        self.up_blocks = nn.ModuleList()
        for i, (btype, ch) in enumerate(zip(cfg.up_block_types, reversed(chans))):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(c + skip_c.pop(), ch, g, eps, tdim))
                c = ch
                if btype == "CrossAttnUpBlock2D":
                    blk.attentions.append(Transformer2D(ch, ctx, heads, g))
            if i < len(chans) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)

        self.conv_norm_out = nn.GroupNorm(g, c, eps=eps)
        self.conv_out = nn.Conv2d(c, cfg.out_channels, 3, padding=1)
        self.set_int8(int8)

    def set_int8(self, on: bool) -> None:
        """The int8 route for every resnet conv and resample conv (the
        QConvs of the down, mid and up blocks), or the float one."""
        for part in (self.down_blocks, self.mid_block, self.up_blocks):
            set_quant(part, on)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """latents [B, in_ch, H, W]; timesteps [B] or scalar; context
        [B, L, cross_attention_dim] → [B, out_ch, H, W]."""
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(latents.shape[0])
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift).to(dtype)
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(temb)))
        context = context.to(dtype)

        h = self.conv_in(latents.to(dtype))
        skips = [h]
        for blk in self.down_blocks:
            for j, r in enumerate(blk.resnets):
                h = r(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, context)
        h = self.mid_block.resnets[1](h, temb)
        for blk in self.up_blocks:
            for j, r in enumerate(blk.resnets):
                h = r(torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))
