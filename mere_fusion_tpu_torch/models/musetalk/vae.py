"""AutoencoderKL (stable-diffusion VAE) in PyTorch, NCHW, float only.

Port of mere_fusion_tpu/models/musetalk/vae.py. Module names follow the
diffusers ``AutoencoderKL`` state dict (``encoder.down_blocks.{i}.resnets.{j}``,
``encoder.mid_block.attentions.0.to_q``, ``quant_conv``, ...), so an
sd-vae-ft-mse torch checkpoint loads with ``load_state_dict(strict=True)``.
Encoder: down blocks × resnets, then mid (resnet, attention, resnet) →
8-channel moments; the decoder mirrors it with one more resnet per up block.
GroupNorm eps is 1e-6 throughout; the stride-2 downsample pads (0, 1)
asymmetrically like diffusers.

The int8 decode tier (``AutoencoderKL(int8_decode=True)``, the JAX
``Decoder(int8=True)``): the resnets' convs, the upsample convs and the
decoder's ``conv_in`` are ``QConv`` (ops/quant.py, kernel K5), whose
``quant`` flag switches the arithmetic over the same parameters. Up block i
is quantised when ``i < len(up_blocks) − int8_fp_up_blocks``, with its
upsample conv; ``conv_out``, ``quant_conv``, ``post_quant_conv`` and the
whole encoder stay float. ``set_int8_decode`` moves a built model between
rungs without a second copy of its weights.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from mere_fusion_tpu_torch.ops.quant import QConv


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


class ResnetBlock2D(nn.Module):
    """GN → SiLU → conv3x3 → (+ time) → GN → SiLU → conv3x3, plus a 1x1
    shortcut when the width changes. ``temb_dim`` None: no time input."""

    def __init__(self, cin: int, cout: int, groups: int, eps: float,
                 temb_dim: int | None = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = QConv(cin, cout, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = QConv(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = QConv(cin, cout, 1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full self-attention over spatial positions (VAE mid);
    scores and softmax in float32."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        s = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(c)
        y = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
        y = self.to_out[0](y)
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class Downsample2D(nn.Module):
    def __init__(self, c: int, asymmetric: bool):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = QConv(c, c, 3, stride=2, padding=0 if asymmetric else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric:   # diffusers' VAE pads (0, 1) before a VALID conv
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = QConv(c, c, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """Container so state-dict paths read like diffusers'."""


def set_quant(module: nn.Module, on: bool) -> int:
    """Switch every QConv inside ``module`` to the int8 route (on) or the
    float one; returns how many it switched."""
    convs = [m for m in module.modules() if isinstance(m, QConv)]
    for m in convs:
        m.quant = on
    return len(convs)


def _mid_block(c: int, groups: int) -> _Block:
    mid = _Block()
    mid.resnets = nn.ModuleList([ResnetBlock2D(c, c, groups, 1e-6),
                                 ResnetBlock2D(c, c, groups, 1e-6)])
    mid.attentions = nn.ModuleList([AttnBlock(c, groups)])
    return mid


def _run_mid(mid: _Block, h: torch.Tensor) -> torch.Tensor:
    h = mid.resnets[0](h)
    h = mid.attentions[0](h)
    return mid.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        c = chans[0]
        for i, ch in enumerate(chans):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(c, ch, g, 1e-6))
                c = ch
            if i < len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch, asymmetric=True)])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(c, g)
        self.conv_norm_out = nn.GroupNorm(g, c, eps=1e-6)
        self.conv_out = nn.Conv2d(c, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        chans = cfg.block_out_channels
        c = chans[-1]
        self.conv_in = QConv(cfg.latent_channels, c, 3, padding=1)
        self.mid_block = _mid_block(c, g)
        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(reversed(chans)):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(c, ch, g, 1e-6))
                c = ch
            if i < len(chans) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(g, c, eps=1e-6)
        self.conv_out = nn.Conv2d(c, cfg.in_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


    def set_int8(self, on: bool, fp_up_blocks: int = 0) -> None:
        """The int8 route for conv_in, the mid block's resnets and each up
        block i < len(up_blocks) − fp_up_blocks (its resnets and upsample)."""
        set_quant(self, False)
        if on:
            set_quant(self.conv_in, True)
            set_quant(self.mid_block, True)
            for i, blk in enumerate(self.up_blocks):
                set_quant(blk, i < len(self.up_blocks) - int(fp_up_blocks))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig | None = None, int8_decode: bool = False,
                 int8_fp_up_blocks: int = 0):
        super().__init__()
        self.cfg = cfg = cfg or VAEConfig()
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.set_int8_decode(int8_decode, int8_fp_up_blocks)

    def set_int8_decode(self, on: bool, fp_up_blocks: int = 0) -> None:
        """Move the decode between the float route and an int8 rung (the
        JAX ``AutoencoderKL(int8_decode, int8_fp_up_blocks)``)."""
        self.decoder.set_int8(on, fp_up_blocks)

    def moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x [B,3,H,W] in [-1,1] → (mean, logvar), each [B,4,H/8,W/8]."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The latent mode (MuseTalk encodes deterministically)."""
        return self.moments(x)[0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))
