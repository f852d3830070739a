"""Whisper audio encoder in PyTorch (OpenAI whisper key names).

Port of the encoder half of mere_fusion_tpu/models/whisper.py. Module and
parameter names follow OpenAI's whisper ``model.encoder`` state dict
(``conv1``, ``blocks.{i}.attn.query``, ``blocks.{i}.mlp.0``, ``ln_post``,
the ``positional_embedding`` buffer), so the ``encoder.*`` entries of a
whisper ``.pt`` load with ``load_state_dict(strict=True)``. Two properties
carried over exactly:

- the encoder can return per-layer embeddings (pre-block input + each block
  output, stacked) — MuseTalk conditions on these;
- attention scales q and k by (d/h)^-0.25 each and softmaxes in float32;
  ``key`` has no bias.

The text decoder is not ported yet (ROADMAP "Streaming ASR").
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class WhisperDims:
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4


TINY = WhisperDims()


def sinusoids(length: int, channels: int, max_timescale: float = 10000) -> np.ndarray:
    """Sinusoidal position embedding [length, channels] (float32)."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)
        b, lq, d = q.shape
        lk = k.shape[1]
        h = self.n_head
        scale = (d // h) ** -0.25
        q = (q * scale).reshape(b, lq, h, -1).transpose(1, 2)
        k = (k * scale).reshape(b, lk, h, -1).permute(0, 2, 3, 1)
        v = v.reshape(b, lk, h, -1).transpose(1, 2)
        w = torch.softmax((q @ k).float(), dim=-1).to(v.dtype)
        return self.out((w @ v).transpose(1, 2).reshape(b, lq, d))


class ResidualAttentionBlock(nn.Module):
    """Encoder block (self-attention + MLP); the decoder's cross-attention
    variant is not ported yet."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state, eps=1e-5)
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state),
                                 nn.GELU(approximate="none"),
                                 nn.Linear(4 * n_state, n_state))
        self.mlp_ln = nn.LayerNorm(n_state, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_ln(x))
        return x + self.mlp(self.mlp_ln(x))


class AudioEncoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims
        self.dims = dims
        self.conv1 = nn.Conv1d(d.n_mels, d.n_audio_state, 3, padding=1)
        self.conv2 = nn.Conv1d(d.n_audio_state, d.n_audio_state, 3, stride=2, padding=1)
        self.register_buffer(
            "positional_embedding",
            torch.from_numpy(sinusoids(d.n_audio_ctx, d.n_audio_state)))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d.n_audio_state, d.n_audio_head)
            for _ in range(d.n_audio_layer))
        self.ln_post = nn.LayerNorm(d.n_audio_state, eps=1e-5)

    def forward(self, mel: torch.Tensor, include_embeddings: bool = False):
        """mel [B, n_mels, T] with T = 2·n_audio_ctx. Returns the encoded
        audio [B, T/2, D] and, with include_embeddings, the per-layer
        embeddings [B, L+1, T/2, D]."""
        x = F.gelu(self.conv1(mel))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.positional_embedding.to(x.dtype)
        embeddings = [x]
        for block in self.blocks:
            x = block(x)
            embeddings.append(x)
        out = self.ln_post(x)
        if include_embeddings:
            return out, torch.stack(embeddings, dim=1)
        return out
