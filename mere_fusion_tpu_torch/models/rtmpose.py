"""RTMPose / DWPose wholebody landmarker, the MuseTalk avatar-prep keypoint
model.

Port of mere_fusion_tpu/models/rtmpose.py. The reference prepares MuseTalk
avatars with mmpose's DWPose (rtmpose-l wholebody 384x288: reference
musetalk/utils/preprocessing.py:17-18 loads
``rtmpose-l_8xb32-270e_coco-ubody-wholebody-384x288.py`` and
``models/dwpose/dw-ll_ucoco_384.pth``; musetalk/mere_musetalk.py:63-66
takes wholebody keypoints [23:91] as the 68-point face). The architecture
that config declares:

  backbone  CSPNeXt-l (arch P5, deepen 1.0, widen 1.0, expand 0.5,
            channel attention, SiLU), out stage 4 (stride 32)
  head      RTMCCHead: 7x7 conv -> per-keypoint token flatten -> ScaleNorm +
            Linear(108->256) -> one GAU block (self-attn, s=128, expansion 2)
            -> SimCC x/y classification branches (split ratio 2)

Modules carry mmpose's names (``backbone.stem.0``, ``backbone.stage1.0``,
``…blocks.0.conv2.depthwise_conv``, ``head.gau.res_scale.scale`` …), so a
``dw-ll_ucoco_384.pth`` loads through ``utils/torch_convert.convert_rtmpose``
with every key checked. BatchNorm runs in eval mode (ε 1e-5). The crop is
axis-aligned (the inference pipeline never rotates); with ``dtype``
bfloat16 the network runs in bf16 and the SimCC decode in float32, as the
JAX twin's.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mere_fusion_tpu_torch.device import random_init_, resolve_device

# CSPNeXt P5 arch rows: (in_c, out_c, num_blocks, add_identity, use_spp)
# (mmdet CSPNeXt.arch_settings['P5'], scaled by deepen/widen factors).
P5_ARCH = (
    (64, 128, 3, True, False),
    (128, 256, 6, True, False),
    (256, 512, 6, True, False),
    (512, 1024, 3, False, True),
)

INPUT_W, INPUT_H = 288, 384           # codec input_size (W, H)
SIMCC_RATIO = 2.0
NUM_KEYPOINTS = 133                    # COCO-WholeBody
FACE_SLICE = slice(23, 91)             # 68-point face (mere_musetalk.py:65)
# PoseDataPreprocessor mean/std (RGB order after bgr_to_rgb)
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


class ConvModule(nn.Module):
    """mmcv ConvModule: Conv2d(bias=False) + BN(eps 1e-5) + SiLU."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1, g: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class DepthwiseSeparable(nn.Module):
    """mmcv DepthwiseSeparableConvModule: depthwise k×k, then pointwise 1×1,
    each a ConvModule."""

    def __init__(self, c: int, k: int):
        super().__init__()
        self.depthwise_conv = ConvModule(c, c, k, g=c)
        self.pointwise_conv = ConvModule(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise_conv(self.depthwise_conv(x))


class CSPNeXtBlock(nn.Module):
    """3x3 ConvModule -> 5x5 depthwise-separable ConvModule (+identity)."""

    def __init__(self, c: int, add_identity: bool = True):
        super().__init__()
        self.add_identity = add_identity
        self.conv1 = ConvModule(c, c, 3)
        self.conv2 = DepthwiseSeparable(c, 5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return x + y if self.add_identity else y


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling over kernel sizes (5, 9, 13)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = ConvModule(c, c // 2, 1)
        self.conv2 = ConvModule(c // 2 * 4, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        ys = [y] + [F.max_pool2d(y, k, 1, k // 2) for k in (5, 9, 13)]
        return self.conv2(torch.cat(ys, dim=1))


class ChannelAttention(nn.Module):
    """mmdet ChannelAttention: GAP -> 1x1 conv (bias) -> hardsigmoid gate
    (the gate in float32)."""

    def __init__(self, c: int):
        super().__init__()
        self.fc = nn.Conv2d(c, c, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.fc(x.mean((2, 3), keepdim=True))
        return x * F.hardsigmoid(g.float()).to(x.dtype)


class CSPLayer(nn.Module):
    """mmdet CSPLayer with use_cspnext_block=True + channel attention."""

    def __init__(self, cin: int, c: int, n: int, add_identity: bool,
                 expand_ratio: float = 0.5):
        super().__init__()
        mid = int(c * expand_ratio)
        self.main_conv = ConvModule(cin, mid, 1)
        self.short_conv = ConvModule(cin, mid, 1)
        self.blocks = nn.Sequential(*[CSPNeXtBlock(mid, add_identity) for _ in range(n)])
        self.attention = ChannelAttention(2 * mid)
        self.final_conv = ConvModule(2 * mid, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.blocks(self.main_conv(x)), self.short_conv(x)], dim=1)
        return self.final_conv(self.attention(y))


class CSPNeXt(nn.Module):
    """CSPNeXt backbone (arch P5), returning the stage-4 stride-32 map."""

    def __init__(self, deepen: float = 1.0, widen: float = 1.0):
        super().__init__()
        stem_c = int(P5_ARCH[0][0] * widen)
        self.stem = nn.Sequential(ConvModule(3, stem_c // 2, 3, 2),
                                  ConvModule(stem_c // 2, stem_c // 2, 3, 1),
                                  ConvModule(stem_c // 2, stem_c, 3, 1))
        cin = stem_c
        for i, (_, out_c, n, add_id, use_spp) in enumerate(P5_ARCH):
            c = int(out_c * widen)
            n = max(round(n * deepen), 1)
            mods = [ConvModule(cin, c, 3, 2)]
            if use_spp:
                mods.append(SPPBottleneck(c))
            mods.append(CSPLayer(c, c, n, add_id))
            self.add_module(f"stage{i + 1}", nn.Sequential(*mods))
            cin = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for i in range(len(P5_ARCH)):
            x = getattr(self, f"stage{i + 1}")(x)
        return x


class ScaleNorm(nn.Module):
    """x / (||x||_2 * dim^-0.5) * g (mmpose rtmcc_block.ScaleNorm), the
    norm in float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** -0.5
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True) * self.scale
        return (x.float() / norm.clamp(min=1e-5) * self.g.float()).to(x.dtype)


class Scale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))


class GAU(nn.Module):
    """Gated Attention Unit, self-attn flavor (mmpose RTMCCBlock):

      x' = ScaleNorm(x); uv = SiLU(Linear(x'));  u, v, base = split(uv)
      q = base*gamma0+beta0; k = base*gamma1+beta1
      out = res_scale*x + Linear(u * (relu(q k^T / sqrt(s))^2 @ v))

    no relative bias, no positional encoding, bias-free linears; gamma,
    beta, res_scale, q kᵀ and the output in float32, as flax promotes them
    beside its float32 parameters."""

    def __init__(self, hidden: int = 256, s: int = 128, expansion: int = 2):
        super().__init__()
        self.s, self.e = s, hidden * expansion
        self.gamma = nn.Parameter(torch.rand(2, s))
        self.beta = nn.Parameter(torch.rand(2, s))
        self.res_scale = Scale(hidden)
        self.ln = ScaleNorm(hidden)
        self.uv = nn.Linear(hidden, 2 * self.e + s, bias=False)
        self.o = nn.Linear(self.e, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        uv = F.silu(self.uv(self.ln(x)))
        u, v, base = torch.split(uv, [self.e, self.e, self.s], dim=-1)
        q = base.float() * self.gamma[0] + self.beta[0]
        k = base.float() * self.gamma[1] + self.beta[1]
        qk = torch.bmm(q, k.transpose(1, 2))
        kernel = torch.square(F.relu(qk / math.sqrt(self.s)))
        y = self.o(u * torch.bmm(kernel.to(v.dtype), v))
        return x.float() * self.res_scale.scale + y.float()


class RTMCCHead(nn.Module):
    """7x7 conv -> token flatten -> mlp -> GAU -> SimCC x/y bins."""

    def __init__(self, cin: int, num_keypoints: int = NUM_KEYPOINTS, hidden: int = 256):
        super().__init__()
        flat = (INPUT_H // 32) * (INPUT_W // 32)
        self.final_layer = nn.Conv2d(cin, num_keypoints, 7, padding=3, bias=True)
        self.mlp = nn.Sequential(ScaleNorm(flat), nn.Linear(flat, hidden, bias=False))
        self.gau = GAU(hidden)
        self.cls_x = nn.Linear(hidden, int(INPUT_W * SIMCC_RATIO), bias=False)
        self.cls_y = nn.Linear(hidden, int(INPUT_H * SIMCC_RATIO), bias=False)

    def forward(self, feats: torch.Tensor):
        x = self.final_layer(feats).flatten(2)          # [B, K, H*W]
        x = self.gau(self.mlp(x)).to(self.cls_x.weight.dtype)
        return self.cls_x(x), self.cls_y(x)


class RTMPose(nn.Module):
    """The top-down wholebody pose network on 384x288 crops: preprocessed
    crops [B, 3, 384, 288] (RGB, mean/std-normalized) → SimCC logits
    (x [B, 133, 576], y [B, 133, 768])."""

    def __init__(self, deepen: float = 1.0, widen: float = 1.0):
        super().__init__()
        self.backbone = CSPNeXt(deepen, widen)
        self.head = RTMCCHead(int(P5_ARCH[-1][1] * widen))

    def forward(self, x: torch.Tensor):
        return self.head(self.backbone(x))


def compute_dtype_(model: nn.Module, dtype) -> nn.Module:
    """The convolutions and linears in ``dtype``, as flax's ``dtype=``
    casts their operands; BatchNorm, ScaleNorm and the GAU's vectors stay
    float32 (their flax parameters are float32, the math promoted)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype)
    return model


def simcc_decode(pred_x: torch.Tensor, pred_y: torch.Tensor):
    """mmpose get_simcc_maximum (use_dark=False) in float32: argmax over
    bins / split ratio; score = min of the two peak values."""
    px, py = pred_x.float(), pred_y.float()
    loc_x = torch.argmax(px, dim=-1).float() / SIMCC_RATIO
    loc_y = torch.argmax(py, dim=-1).float() / SIMCC_RATIO
    score = torch.minimum(px.max(-1).values, py.max(-1).values)
    return torch.stack([loc_x, loc_y], dim=-1), score


@torch.no_grad()
def init_rtmpose_(model: RTMPose, seed: int) -> RTMPose:
    """Seeded weights: ``random_init_``, then flax's initialisers where its
    ones differ (ScaleNorm g and res_scale 1, GAU gamma/beta U[0, 1))."""
    random_init_(model, seed)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, (ScaleNorm, Scale)):
            next(m.parameters()).fill_(1.0)
        if isinstance(m, GAU):
            for p in (m.gamma, m.beta):
                p.copy_(torch.rand(p.shape, generator=gen))
    return model


# ---- top-down crop pipeline --------------------------------------------------

def bbox_center_scale(boxes: np.ndarray, padding: float = 1.25) -> tuple:
    """GetBBoxCenterScale: xyxy -> (center, scale) with 1.25 padding, then
    TopdownAffine's fix_aspect_ratio to the 288/384 input box."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    center = (boxes[:, :2] + boxes[:, 2:]) * 0.5
    scale = (boxes[:, 2:] - boxes[:, :2]) * padding
    ratio = INPUT_W / INPUT_H
    w, h = scale[:, 0], scale[:, 1]
    new_w = np.where(w > h * ratio, w, h * ratio)
    return center, np.stack([new_w, new_w / ratio], axis=-1)


def crop_affine(frames: torch.Tensor, center: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Axis-aligned bilinear crop+resize of [B, H, W, 3] frames to
    [B, 384, 288, 3] float32 (TopdownAffine without rotation: the source
    box center/scale maps linearly onto the model input). Destination
    pixel centres map to src = center - scale/2 + (dst + 0.5)·scale/input -
    0.5; the four neighbours are gathered with the left/top one clamped to
    [0, size - 2] and the fractions to [0, 1], as the JAX twin samples."""
    b, h, w = frames.shape[:3]
    dev = frames.device
    dx = (torch.arange(INPUT_W, dtype=torch.float32, device=dev) + 0.5) / INPUT_W
    dy = (torch.arange(INPUT_H, dtype=torch.float32, device=dev) + 0.5) / INPUT_H
    sx = (center[:, 0, None] - scale[:, 0, None] / 2
          + dx[None] * scale[:, 0, None] - 0.5)          # [B, 288]
    sy = (center[:, 1, None] - scale[:, 1, None] / 2
          + dy[None] * scale[:, 1, None] - 0.5)          # [B, 384]
    x0 = torch.clamp(torch.floor(sx).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(sy).to(torch.int64), 0, h - 2)
    fx = torch.clamp(sx - x0, 0.0, 1.0)[:, None, :, None]
    fy = torch.clamp(sy - y0, 0.0, 1.0)[:, :, None, None]
    img = frames.float()
    bi = torch.arange(b, device=dev)[:, None, None]

    def lerp_rows(rows):                                  # rows [B, 384]
        a = img[bi, rows[:, :, None], x0[:, None, :]]     # [B, 384, 288, 3]
        bb = img[bi, rows[:, :, None], x0[:, None, :] + 1]
        return a + (bb - a) * fx

    top, bot = lerp_rows(y0), lerp_rows(y0 + 1)
    return top + (bot - top) * fy


class WholebodyLandmarker:
    """DWPose-compatible 68-point face landmarker for MuseTalk avatar prep.

    Drop-in alternative to models/fan.LandmarkDetector in
    tools/genavatar.get_landmark_and_bbox (``landmarks_from_boxes(image_rgb,
    boxes) -> list of [68, 2]``). As the reference calls
    ``inference_topdown(model, frame)`` with no detector boxes
    (musetalk/utils/preprocessing.py:56), the whole frame is the top-down
    crop; keypoints [23:91] are the 68-point face (mere_musetalk.py:63-66).
    ``state`` is the port's RTMPose state dict (``convert_rtmpose``); None
    means seeded random weights. One call: crop, normalize, the network,
    the SimCC decode and the map back to frame coordinates, on ``device``."""

    def __init__(self, state: Optional[dict] = None, dtype=torch.bfloat16, deepen: float = 1.0,
                 widen: float = 1.0, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        with torch.device("meta"):
            model = RTMPose(deepen, widen)
        if state is None:
            model.to_empty(device=self.device)
            init_rtmpose_(model, 0)
        else:
            model.load_state_dict(state, strict=True, assign=True)
        self.model = compute_dtype_(model.to(self.device), dtype).eval().requires_grad_(False)
        self.mean = torch.tensor(PIXEL_MEAN, device=self.device)
        self.std = torch.tensor(PIXEL_STD, device=self.device)

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "WholebodyLandmarker":
        """An mmpose RTMPose wholebody ``.pth`` (``dw-ll_ucoco_384.pth``)."""
        from mere_fusion_tpu_torch.utils.torch_convert import (
            convert_rtmpose,
            load_torch_checkpoint,
        )

        return cls(state=convert_rtmpose(load_torch_checkpoint(path),
                                         deepen=kw.get("deepen", 1.0),
                                         widen=kw.get("widen", 1.0)), **kw)

    @torch.no_grad()
    def run(self, frames_rgb: torch.Tensor, center: torch.Tensor, scale: torch.Tensor):
        """frames [B,H,W,3], centers and scales [B, 2] on the device →
        (keypoints [B,133,2] in frame coords, scores [B,133])."""
        crops = crop_affine(frames_rgb, center, scale)
        x = ((crops - self.mean) / self.std).permute(0, 3, 1, 2).to(self.dtype)
        kpts, score = simcc_decode(*self.model(x))
        origin = center - scale / 2.0
        factor = scale / torch.tensor([INPUT_W, INPUT_H], dtype=torch.float32,
                                      device=scale.device)
        return kpts * factor[:, None, :] + origin[:, None, :], score

    def wholebody(self, frames_rgb: np.ndarray,
                  boxes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched raw API: [B,H,W,3] frames + [B,4] xyxy crop boxes ->
        ([B,133,2] keypoints in frame coords, [B,133] scores)."""
        center, scale = bbox_center_scale(boxes)
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                         device=self.device)
        kpts, score = self.run(as_t(frames_rgb), as_t(center), as_t(scale))
        return kpts.cpu().numpy(), score.cpu().numpy()

    def landmarks_from_boxes(self, image_rgb: np.ndarray, boxes) -> list[np.ndarray]:
        h, w = image_rgb.shape[:2]
        full = np.array([[0.0, 0.0, w, h]], np.float32)
        kpts, _ = self.wholebody(image_rgb[None], full)
        return [kpts[0, FACE_SLICE].astype(np.float32)] * max(len(boxes), 1)
