"""Wav2Lip lip-sync generator and its quality discriminator in PyTorch.

Port of mere_fusion_tpu/models/wav2lip.py. The layer specs are copies of
the JAX package's; the modules carry the reference's names
(wav2lip/models/wav2lip.py, conv.py): ``audio_encoder.{j}``,
``face_encoder_blocks.{i}.{j}``, ``face_decoder_blocks.{i}.{j}``,
``output_block.{0,1}`` and, in the discriminator, ``binary_pred.0``, each
conv block holding ``conv_block.0`` (the conv) and ``conv_block.1`` (its
BatchNorm2d). So a reference ``wav2lip.pth`` loads with ``load_state_dict``
once its ``module.`` prefix is gone.

Inputs and outputs are NHWC as in JAX (mel [B, 80, 16], faces [B, 96, 96, 6]
in [0, 1], out [B, 96, 96, 3]); inside, the tensors are NCHW. Numerics follow
flax where they differ from torch's modules:

- a conv in the compute dtype rounds its input and kernel to it, returns that
  dtype and adds its bias, rounded to it, after (flax ``nn.Conv``);
- BatchNorm normalises in float32 (float64 for a float64 input) with the
  statistics in float32 and returns the compute dtype; in training it uses the biased batch variance
  E[x²] − E[x]² and moves the running statistics at momentum 0.9 (flax's
  convention: new = 0.9 · old + 0.1 · batch). torch's BatchNorm2d would move
  ``running_var`` by the unbiased variance at 0.1;
- the residual add and the ReLU run in the compute dtype, the final sigmoid
  in float32.

The transposed convs are torch ``ConvTranspose2d`` with the weight in
``(cin, cout, k, k)``, which the JAX package keeps as its parameter (it flips
the kernel only to build the same op from a dilated conv).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# Layer spec entries:
#   ("c", cout, kernel, stride, pad, residual)   conv + BN + relu
#   ("t", cout, kernel, stride, pad, out_pad)    convT + BN + relu
Conv = tuple
FACE_ENCODER: Sequence[Sequence[Conv]] = (
    (("c", 16, 7, 1, 3, False),),                                     # 96
    (("c", 32, 3, 2, 1, False), ("c", 32, 3, 1, 1, True), ("c", 32, 3, 1, 1, True)),   # 48
    (("c", 64, 3, 2, 1, False),) + (("c", 64, 3, 1, 1, True),) * 3,   # 24
    (("c", 128, 3, 2, 1, False),) + (("c", 128, 3, 1, 1, True),) * 2, # 12
    (("c", 256, 3, 2, 1, False),) + (("c", 256, 3, 1, 1, True),) * 2, # 6
    (("c", 512, 3, 2, 1, False), ("c", 512, 3, 1, 1, True)),          # 3
    (("c", 512, 3, 1, 0, False), ("c", 512, 1, 1, 0, False)),         # 1
)

AUDIO_ENCODER: Sequence[Conv] = (
    ("c", 32, 3, 1, 1, False), ("c", 32, 3, 1, 1, True), ("c", 32, 3, 1, 1, True),
    ("c", 64, 3, (3, 1), 1, False), ("c", 64, 3, 1, 1, True), ("c", 64, 3, 1, 1, True),
    ("c", 128, 3, 3, 1, False), ("c", 128, 3, 1, 1, True), ("c", 128, 3, 1, 1, True),
    ("c", 256, 3, (3, 2), 1, False), ("c", 256, 3, 1, 1, True),
    ("c", 512, 3, 1, 0, False), ("c", 512, 1, 1, 0, False),
)

FACE_DECODER: Sequence[Sequence[Conv]] = (
    (("c", 512, 1, 1, 0, False),),
    (("t", 512, 3, 1, 0, 0), ("c", 512, 3, 1, 1, True)),              # 3
    (("t", 512, 3, 2, 1, 1), ("c", 512, 3, 1, 1, True), ("c", 512, 3, 1, 1, True)),    # 6
    (("t", 384, 3, 2, 1, 1), ("c", 384, 3, 1, 1, True), ("c", 384, 3, 1, 1, True)),    # 12
    (("t", 256, 3, 2, 1, 1), ("c", 256, 3, 1, 1, True), ("c", 256, 3, 1, 1, True)),    # 24
    (("t", 128, 3, 2, 1, 1), ("c", 128, 3, 1, 1, True), ("c", 128, 3, 1, 1, True)),    # 48
    (("t", 64, 3, 2, 1, 1), ("c", 64, 3, 1, 1, True), ("c", 64, 3, 1, 1, True)),       # 96
)

DISC_ENCODER: Sequence[Sequence[Conv]] = (
    (("c", 32, 7, 1, 3, False),),
    (("c", 64, 5, (1, 2), 2, False), ("c", 64, 5, 1, 2, False)),
    (("c", 128, 5, 2, 2, False), ("c", 128, 5, 1, 2, False)),
    (("c", 256, 5, 2, 2, False), ("c", 256, 5, 1, 2, False)),
    (("c", 512, 3, 2, 1, False), ("c", 512, 3, 1, 1, False)),
    (("c", 512, 3, 2, 1, False), ("c", 512, 3, 1, 1, False)),
    (("c", 512, 3, 1, 0, False), ("c", 512, 1, 1, 0, False)),
)

BN_MOMENTUM = 0.9   # flax: running = 0.9 · running + 0.1 · batch
BN_EPS = 1e-5


def conv(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``layer`` (Conv2d or ConvTranspose2d) on x in x's dtype: kernel and
    bias rounded to it, the bias added to the rounded product (flax nn.Conv).
    In float32 the bias rides the conv call."""
    w = layer.weight.to(x.dtype)
    b = layer.bias.to(x.dtype)
    fused = x.dtype == torch.float32
    if isinstance(layer, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, w, b if fused else None, layer.stride, layer.padding,
                               layer.output_padding)
    else:
        y = F.conv2d(x, w, b if fused else None, layer.stride, layer.padding)
    return y if fused else y + b[:, None, None]


def batch_norm(bn: nn.BatchNorm2d, y: torch.Tensor, training: bool) -> torch.Tensor:
    """flax BatchNorm over NCHW y: statistics and normalisation in at least
    float32, the result in y's dtype. In training the batch's mean and
    biased variance (E[y²] − E[y]², clipped at 0) normalise, and the running
    statistics move to BN_MOMENTUM · running + (1 − BN_MOMENTUM) · batch."""
    yf = y.to(torch.promote_types(y.dtype, torch.float32))
    if training:
        mean = yf.mean((0, 2, 3))
        var = torch.clamp_min((yf * yf).mean((0, 2, 3)) - mean * mean, 0.0)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)
            bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + BN_EPS) * bn.weight
    out = (yf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return out.to(y.dtype)


class ConvBNRelu(nn.Module):
    """The reference's Conv2d / Conv2dTranspose block: conv → BatchNorm →
    (+ input when residual) → ReLU."""

    def __init__(self, cin: int, spec: Conv):
        super().__init__()
        kind, cout, k, s, p, extra = spec
        if kind == "c":
            layer = nn.Conv2d(cin, cout, k, s, p)
            self.residual = bool(extra)
        else:
            layer = nn.ConvTranspose2d(cin, cout, k, s, p, output_padding=extra)
            self.residual = False
        self.conv_block = nn.Sequential(layer, nn.BatchNorm2d(cout, eps=BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = batch_norm(self.conv_block[1], conv(self.conv_block[0], x), self.training)
        if self.residual:
            y = y + x
        return torch.relu(y)


class ConvLeaky(nn.Module):
    """The reference's nonorm_Conv2d: conv → LeakyReLU(0.01)."""

    def __init__(self, cin: int, spec: Conv):
        super().__init__()
        _, cout, k, s, p, _ = spec
        self.conv_block = nn.Sequential(nn.Conv2d(cin, cout, k, s, p))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(conv(self.conv_block[0], x), 0.01)


def conv_stack(cin: int, specs: Sequence[Conv], block=ConvBNRelu) -> tuple[nn.Sequential, int]:
    layers = []
    for spec in specs:
        layers.append(block(cin, spec))
        cin = spec[1]
    return nn.Sequential(*layers), cin


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def mel_nchw(mel: torch.Tensor) -> torch.Tensor:
    """[B, 80, 16] or [B, 80, 16, 1] → [B, 1, 80, 16]."""
    return mel[:, None] if mel.ndim == 3 else nhwc_to_nchw(mel)


class Wav2Lip(nn.Module):
    """mel window + masked/reference face pair → lip-synced face crop.

    mel [B, 80, 16] (or [B, 80, 16, 1]); faces [B, H, W, 6] = concat(lower
    half masked current frame, reference frame) in [0, 1]; returns
    [B, H, W, 3] in [0, 1], float32. ``compute_dtype`` is the dtype of the
    convs and activations (flax's ``dtype``)."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.audio_encoder, audio_c = conv_stack(1, AUDIO_ENCODER)
        blocks, skips, cin = [], [], 6
        for specs in FACE_ENCODER:
            block, cin = conv_stack(cin, specs)
            blocks.append(block)
            skips.append(cin)
        self.face_encoder_blocks = nn.ModuleList(blocks)
        blocks, cin = [], audio_c
        for specs in FACE_DECODER:
            block, cout = conv_stack(cin, specs)
            blocks.append(block)
            cin = cout + skips.pop()   # concat [block output, encoder feature]
        self.face_decoder_blocks = nn.ModuleList(blocks)
        self.output_block = nn.Sequential(ConvBNRelu(cin, ("c", 32, 3, 1, 1, False)),
                                          nn.Conv2d(32, 3, 1, 1, 0), nn.Sigmoid())

    def forward(self, mel: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        a = self.audio_encoder(mel_nchw(mel).to(dt))
        feats = []
        x = nhwc_to_nchw(faces).to(dt)
        for block in self.face_encoder_blocks:
            x = block(x)
            feats.append(x)
        x = a
        for block in self.face_decoder_blocks:
            x = torch.cat([block(x), feats.pop()], dim=1)
        x = conv(self.output_block[1], self.output_block[0](x))
        return torch.sigmoid(x.float()).permute(0, 2, 3, 1)


class Wav2LipDisc(nn.Module):
    """GAN quality discriminator (reference Wav2Lip_disc_qual): scores the
    lower half of [B, H, W, 3] faces, returns [B, 1] in (0, 1)."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        blocks, cin = [], 3
        for specs in DISC_ENCODER:
            block, cin = conv_stack(cin, specs, ConvLeaky)
            blocks.append(block)
        self.face_encoder_blocks = nn.ModuleList(blocks)
        self.binary_pred = nn.Sequential(nn.Conv2d(cin, 1, 1, 1, 0), nn.Sigmoid())

    def forward(self, faces: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(faces[:, faces.shape[1] // 2:]).to(self.compute_dtype)
        for block in self.face_encoder_blocks:
            x = block(x)
        x = conv(self.binary_pred[0], x)
        return torch.sigmoid(x.reshape(x.shape[0], -1).float())


def cast_convs_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store every conv's weight and bias in ``dtype`` (BatchNorm stays
    float32), so a forward in that dtype casts nothing: the values are the
    ones the forward's own rounding would make."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.data = m.weight.data.to(dtype)
            m.bias.data = m.bias.data.to(dtype)
    return module

