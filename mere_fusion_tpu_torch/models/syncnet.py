"""SyncNet lip-sync scorer in PyTorch.

Port of mere_fusion_tpu/models/syncnet.py, with the reference's module names
(wav2lip/models/syncnet.py SyncNet_color: ``face_encoder.{j}``,
``audio_encoder.{j}``, each a conv block as in models/wav2lip.py): a
lower-half face window of 15 channels and a mel window are embedded to
L2-normalised 512-d vectors whose cosine scores sync. The Wav2Lip training
recipe uses it frozen (hparams syncnet_wt).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mere_fusion_tpu_torch.models.wav2lip import conv_stack, mel_nchw, nhwc_to_nchw
from mere_fusion_tpu_torch.utils.torch_convert import convert_syncnet  # noqa: F401

Conv = tuple
SYNC_FACE: Sequence[Conv] = (
    ("c", 32, 7, 1, 3, False),
    ("c", 64, 5, (1, 2), 1, False), ("c", 64, 3, 1, 1, True), ("c", 64, 3, 1, 1, True),
    ("c", 128, 3, 2, 1, False), ("c", 128, 3, 1, 1, True),
    ("c", 128, 3, 1, 1, True), ("c", 128, 3, 1, 1, True),
    ("c", 256, 3, 2, 1, False), ("c", 256, 3, 1, 1, True), ("c", 256, 3, 1, 1, True),
    ("c", 512, 3, 2, 1, False), ("c", 512, 3, 1, 1, True), ("c", 512, 3, 1, 1, True),
    ("c", 512, 3, 2, 1, False), ("c", 512, 3, 1, 0, False), ("c", 512, 1, 1, 0, False),
)
SYNC_AUDIO: Sequence[Conv] = (
    ("c", 32, 3, 1, 1, False), ("c", 32, 3, 1, 1, True), ("c", 32, 3, 1, 1, True),
    ("c", 64, 3, (3, 1), 1, False), ("c", 64, 3, 1, 1, True), ("c", 64, 3, 1, 1, True),
    ("c", 128, 3, 3, 1, False), ("c", 128, 3, 1, 1, True), ("c", 128, 3, 1, 1, True),
    ("c", 256, 3, (3, 2), 1, False), ("c", 256, 3, 1, 1, True), ("c", 256, 3, 1, 1, True),
    ("c", 512, 3, 1, 0, False), ("c", 512, 1, 1, 0, False),
)


class SyncNet(nn.Module):
    """mel [B, 80, 16] (or [B, 80, 16, 1]) and faces [B, H/2, W, 15] (NHWC,
    five lower-half RGB frames along channels) → (audio_emb, face_emb), both
    L2-normalised [B, 512] in the compute dtype."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.face_encoder, _ = conv_stack(15, SYNC_FACE)
        self.audio_encoder, _ = conv_stack(1, SYNC_AUDIO)

    def forward(self, mel: torch.Tensor, faces: torch.Tensor):
        a = self.audio_encoder(mel_nchw(mel).to(self.compute_dtype))
        f = self.face_encoder(nhwc_to_nchw(faces).to(self.compute_dtype))
        # NHWC flatten order, as the JAX twin (1×1 maps at 96 px)
        a = a.permute(0, 2, 3, 1).reshape(a.shape[0], -1)
        f = f.permute(0, 2, 3, 1).reshape(f.shape[0], -1)
        a = a / torch.clamp_min(torch.linalg.vector_norm(a, dim=-1, keepdim=True), 1e-12)
        f = f / torch.clamp_min(torch.linalg.vector_norm(f, dim=-1, keepdim=True), 1e-12)
        return a, f


def cosine_sync_loss(audio_emb: torch.Tensor, face_emb: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """BCE on the cosine similarity mapped to (0, 1) (the published syncnet
    recipe)."""
    sim = (audio_emb * face_emb).sum(-1)
    prob = torch.clamp((sim + 1) / 2, 1e-7, 1 - 1e-7)
    return -(labels * torch.log(prob) + (1 - labels) * torch.log(1 - prob)).mean()
