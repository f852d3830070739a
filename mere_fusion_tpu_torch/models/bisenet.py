"""BiSeNet face parsing.

Port of mere_fusion_tpu/models/bisenet.py, the twin of the reference's
face-parsing network (musetalk/utils/face_parsing/model.py, resnet.py): a
ResNet-18 trunk, a context path with attention-refinement modules, feature
fusion, and three heads upsampled to the input size. Modules carry the
reference's names (``cp.resnet.layer1.0.conv1``, ``downsample.{0,1}``,
``cp.arm16``, ``ffm.convblk``, ``conv_out.conv_out`` …), so a
``79999_iter.pth`` loads with ``load_state_dict(strict=True)``. The
reference trunk fetches ImageNet weights from a URL when it is built; this
one never does: its weights are seeded or loaded. BatchNorm runs in eval
mode (ε 1e-5). Upsampling is ``F.interpolate`` itself (nearest, and bilinear
with align_corners), which the JAX package's two upsamplers copy.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mere_fusion_tpu_torch.device import random_init_, resolve_device


class ConvBNReLU(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, ks: int = 3, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_chan, out_chan, ks, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(out_chan)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chan, out_chan, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_chan)
        self.conv2 = nn.Conv2d(out_chan, out_chan, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_chan)
        self.downsample = (nn.Sequential(nn.Conv2d(in_chan, out_chan, 1, stride, bias=False),
                                         nn.BatchNorm2d(out_chan))
                           if in_chan != out_chan or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = F.relu(self.bn1(self.conv1(x)))
        r = self.bn2(self.conv2(r))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(shortcut + r)


def _layer(in_chan: int, out_chan: int, stride: int) -> nn.Sequential:
    return nn.Sequential(BasicBlock(in_chan, out_chan, stride), BasicBlock(out_chan, out_chan))


class Resnet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = _layer(64, 64, 1)
        self.layer2 = _layer(64, 128, 2)
        self.layer3 = _layer(128, 256, 2)
        self.layer4 = _layer(256, 512, 2)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer1(F.max_pool2d(x, 3, 2, 1))
        feat8 = self.layer2(x)
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


class AttentionRefinement(nn.Module):
    def __init__(self, in_chan: int, out_chan: int):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, out_chan, 3, 1, 1)
        self.conv_atten = nn.Conv2d(out_chan, out_chan, 1, bias=False)
        self.bn_atten = nn.BatchNorm2d(out_chan)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(x)
        atten = feat.mean(dim=(2, 3), keepdim=True)
        return feat * torch.sigmoid(self.bn_atten(self.conv_atten(atten)))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.arm16 = AttentionRefinement(256, 128)
        self.arm32 = AttentionRefinement(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128, 3, 1, 1)
        self.conv_head16 = ConvBNReLU(128, 128, 3, 1, 1)
        self.conv_avg = ConvBNReLU(512, 128, 1, 1, 0)

    def forward(self, x: torch.Tensor):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        avg_up = F.interpolate(avg, feat32.shape[2:], mode="nearest")
        f32 = self.arm32(feat32) + avg_up
        f32_up = self.conv_head32(F.interpolate(f32, feat16.shape[2:], mode="nearest"))
        f16 = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(F.interpolate(f16, feat8.shape[2:], mode="nearest"))
        return feat8, f16_up, f32_up


class FeatureFusion(nn.Module):
    def __init__(self, in_chan: int, out_chan: int):
        super().__init__()
        self.convblk = ConvBNReLU(in_chan, out_chan, 1, 1, 0)
        self.conv1 = nn.Conv2d(out_chan, out_chan // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(out_chan // 4, out_chan, 1, bias=False)

    def forward(self, fsp: torch.Tensor, fcp: torch.Tensor) -> torch.Tensor:
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = feat.mean(dim=(2, 3), keepdim=True)
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(atten))))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, in_chan: int, mid_chan: int, n_classes: int):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, mid_chan, 3, 1, 1)
        self.conv_out = nn.Conv2d(mid_chan, n_classes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    def __init__(self, n_classes: int = 19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusion(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)

    def forward(self, x: torch.Tensor):
        """x: [B, 3, H, W] ImageNet-normalised RGB. Returns the three class
        maps upsampled to [B, n_classes, H, W]."""
        size = x.shape[2:]
        feat_res8, feat_cp8, feat_cp16 = self.cp(x)
        out = self.conv_out(self.ffm(feat_res8, feat_cp8))
        out16 = self.conv_out16(feat_cp8)
        out32 = self.conv_out32(feat_cp16)
        return tuple(F.interpolate(o, size, mode="bilinear", align_corners=True)
                     for o in (out, out16, out32))


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class FaceParsing:
    """Face-region masks (reference face_parsing/__init__.py): a bilinear
    resize (512×512 unless given) and ImageNet normalisation on the host, as
    the JAX twin does them, the net and the argmax over classes on the
    device; classes above 13 → background, the rest → 255. ``state`` is the
    BiSeNet state dict (the reference's names); None means seeded random
    weights."""

    def __init__(self, state=None, device=None):
        self.device = resolve_device(device)
        with torch.device("meta"):
            model = BiSeNet()
        if state is None:
            model.to_empty(device=self.device)
            random_init_(model, 0)
        else:
            model.load_state_dict(state, strict=True, assign=True)
        self.model = model.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "FaceParsing":
        """A reference face-parsing ``.pth`` (``79999_iter.pth``)."""
        from mere_fusion_tpu_torch.utils.torch_convert import (
            load_torch_checkpoint,
            reference_state,
        )

        return cls(state=reference_state(load_torch_checkpoint(path), BiSeNet), **kw)

    @torch.no_grad()
    def _classes(self, image_bgr: np.ndarray, size=(512, 512)) -> np.ndarray:
        """The first head's argmax class map of the image resized to
        ``size`` (W, H), uint8 [H, W]."""
        import cv2

        img = cv2.cvtColor(image_bgr, cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
        x = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        x = torch.from_numpy(x).to(self.device).permute(2, 0, 1)[None]
        return self.model(x)[0].argmax(1)[0].to(torch.uint8).cpu().numpy()

    def __call__(self, image_bgr: np.ndarray, size=(512, 512)) -> np.ndarray:
        parsing = self._classes(image_bgr, size)
        parsing[parsing > 13] = 0
        parsing[parsing >= 1] = 255
        return parsing

    def semantic_map(self, image_bgr: np.ndarray) -> np.ndarray:
        """Colour-coded semantics at the input resolution, the ER-NeRF data
        pipeline's parsing format (reference data_utils/face_parsing/
        test.py): head (classes 1–13, 17+) BGR (255, 0, 0), neck (14–15)
        (0, 255, 0), torso (16) (0, 0, 255), background white."""
        import cv2

        h, w = image_bgr.shape[:2]
        parsing = self._classes(image_bgr)
        parsing = cv2.resize(parsing, (w, h), interpolation=cv2.INTER_NEAREST)
        out = np.full((h, w, 3), 255, np.uint8)
        head = ((parsing >= 1) & (parsing <= 13)) | (parsing >= 17)
        out[head] = (255, 0, 0)
        out[(parsing >= 14) & (parsing <= 15)] = (0, 255, 0)
        out[parsing == 16] = (0, 0, 255)
        return out
