"""FAN (Face Alignment Network), the 68-point landmark detector.

Port of mere_fusion_tpu/models/fan.py: the stacked-hourglass 2DFAN-4 of
the ``face_alignment`` package (vendored by the reference at
wav2lip/face_detection/models.py), with face_alignment's crop and heatmap
decode. Modules carry face_alignment's names (``conv1``, ``bn1``,
``conv2``…``conv4``, ``m{i}.b1_4``…, ``top_m_{i}``, ``conv_last{i}``,
``bn_end{i}``, ``l{i}``, ``bl{i}``, ``al{i}``; a ConvBlock's ``downsample``
is ``Sequential(BN, ReLU, Conv)``), so a 2DFAN4 ``.pth`` loads with
``load_state_dict(strict=True)``. BatchNorm runs in eval mode (ε 1e-5).

Pipeline (``LandmarkDetector``): S3FD box → center and scale → 256×256
crop → FAN heatmaps (64×64×68) → sub-pixel argmax → image coordinates.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mere_fusion_tpu_torch.device import random_init_, resolve_device


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1, bias=False)


class ConvBlock(nn.Module):
    """Three-branch block: concat([out/2, out/4, out/4]) plus the (1×1
    projected) input, pre-activation BN-ReLU ordering."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(in_planes)
        self.conv1 = _conv3x3(in_planes, out_planes // 2)
        self.bn2 = nn.BatchNorm2d(out_planes // 2)
        self.conv2 = _conv3x3(out_planes // 2, out_planes // 4)
        self.bn3 = nn.BatchNorm2d(out_planes // 4)
        self.conv3 = _conv3x3(out_planes // 4, out_planes // 4)
        self.downsample = (nn.Sequential(nn.BatchNorm2d(in_planes), nn.ReLU(),
                                         nn.Conv2d(in_planes, out_planes, 1, bias=False))
                           if in_planes != out_planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.cat([out1, out2, out3], dim=1) + residual


class HourGlass(nn.Module):
    """Recursive hourglass: 2×2 average pool down, ConvBlocks at every
    level, nearest ×2 up, skip add."""

    def __init__(self, depth: int = 4, features: int = 256):
        super().__init__()
        self.depth = depth
        for level in range(depth, 0, -1):
            self.add_module(f"b1_{level}", ConvBlock(features, features))
            self.add_module(f"b2_{level}", ConvBlock(features, features))
            if level == 1:
                self.add_module(f"b2_plus_{level}", ConvBlock(features, features))
            self.add_module(f"b3_{level}", ConvBlock(features, features))

    def _level(self, level: int, inp: torch.Tensor) -> torch.Tensor:
        up1 = self._modules[f"b1_{level}"](inp)
        low1 = self._modules[f"b2_{level}"](F.avg_pool2d(inp, 2, stride=2))
        low2 = (self._level(level - 1, low1) if level > 1
                else self._modules[f"b2_plus_{level}"](low1))
        low3 = self._modules[f"b3_{level}"](low2)
        return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(self.depth, x)


class FAN(nn.Module):
    """Stacked-hourglass landmark net. Input [B, 3, H, W] RGB in [0, 1];
    returns num_modules heatmap tensors [B, 68, H/4, W/4], the last one
    decoded."""

    def __init__(self, num_modules: int = 4):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(4, 256))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", nn.BatchNorm2d(256))
            self.add_module(f"l{i}", nn.Conv2d(256, 68, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{i}", nn.Conv2d(68, 256, 1))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        m = self._modules
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.avg_pool2d(self.conv2(x), 2, stride=2)
        previous = self.conv4(self.conv3(x))
        outputs = []
        for i in range(self.num_modules):
            ll = m[f"top_m_{i}"](m[f"m{i}"](previous))
            ll = F.relu(m[f"bn_end{i}"](m[f"conv_last{i}"](ll)))
            tmp_out = m[f"l{i}"](ll)
            outputs.append(tmp_out)
            if i < self.num_modules - 1:
                previous = previous + m[f"bl{i}"](ll) + m[f"al{i}"](tmp_out)
        return outputs


# ---------------------------------------------------------------------------
# face_alignment geometry (crop and heatmap decode), host-side numpy
# ---------------------------------------------------------------------------

def transform_point(point, center, scale, resolution, invert=False):
    """face_alignment's affine point transform, including its truncation of
    the result to integers."""
    h = 200.0 * scale
    t = np.eye(3)
    t[0, 0] = resolution / h
    t[1, 1] = resolution / h
    t[0, 2] = resolution * (-center[0] / h + 0.5)
    t[1, 2] = resolution * (-center[1] / h + 0.5)
    if invert:
        t = np.linalg.inv(t)
    pt = t @ np.array([point[0], point[1], 1.0])
    return pt[:2].astype(np.int64)


def crop_face(image: np.ndarray, center, scale, resolution: int = 256):
    """Center crop and resize as face_alignment's ``crop``: 1-indexed box
    arithmetic, zeros outside the frame, bilinear resize. A box wholly
    outside the frame gives a black crop, where face_alignment's (and the
    JAX twin's) slices fail to broadcast."""
    import cv2

    ul = transform_point([1, 1], center, scale, resolution, invert=True)
    br = transform_point([resolution, resolution], center, scale, resolution,
                         invert=True)
    if image.ndim > 2:
        new_img = np.zeros((br[1] - ul[1], br[0] - ul[0], image.shape[2]),
                           dtype=np.uint8)
    else:
        new_img = np.zeros((br[1] - ul[1], br[0] - ul[0]), dtype=np.uint8)
    ht, wd = image.shape[0], image.shape[1]
    new_x = [max(1, -ul[0] + 1), min(br[0], wd) - ul[0]]
    new_y = [max(1, -ul[1] + 1), min(br[1], ht) - ul[1]]
    old_x = [max(1, ul[0] + 1), min(br[0], wd)]
    old_y = [max(1, ul[1] + 1), min(br[1], ht)]
    if old_x[1] >= old_x[0] and old_y[1] >= old_y[0]:   # a box wholly outside: all zeros
        new_img[new_y[0] - 1:new_y[1], new_x[0] - 1:new_x[1]] = \
            image[old_y[0] - 1:old_y[1], old_x[0] - 1:old_x[1]]
    return cv2.resize(new_img, (resolution, resolution),
                      interpolation=cv2.INTER_LINEAR)


def heatmaps_to_landmarks(hm: np.ndarray, centers, scales) -> np.ndarray:
    """face_alignment's ``get_preds_fromhm``, vectorised: per-map argmax
    (1-indexed), a quarter-pixel shift toward the larger neighbour, −0.5,
    then back to image coordinates.

    hm: [B, H, W, N] (NHWC, as the JAX twin); centers [B, 2]; scales [B].
    Returns [B, N, 2] float pixel coordinates in the image."""
    b, h, w, n = hm.shape
    maps = np.transpose(hm, (0, 3, 1, 2))  # [B, N, H, W]
    flat = maps.reshape(b, n, h * w)
    idx = flat.argmax(-1)
    px = (idx % w).astype(np.int64)
    py = (idx // w).astype(np.int64)
    preds = np.stack([px, py], -1).astype(np.float64) + 1.0  # 1-indexed

    inner = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
    pxc = np.clip(px, 1, w - 2)
    pyc = np.clip(py, 1, h - 2)
    bi = np.arange(b)[:, None]
    ni = np.arange(n)[None, :]
    dx = maps[bi, ni, pyc, pxc + 1] - maps[bi, ni, pyc, pxc - 1]
    dy = maps[bi, ni, pyc + 1, pxc] - maps[bi, ni, pyc - 1, pxc]
    preds[..., 0] += np.sign(dx) * 0.25 * inner
    preds[..., 1] += np.sign(dy) * 0.25 * inner
    preds -= 0.5

    # inverse transform: x_orig = x * h200/res + center - h200/2
    out = np.empty_like(preds)
    for i in range(b):
        h200 = 200.0 * scales[i]
        out[i, :, 0] = preds[i, :, 0] * h200 / h + centers[i][0] - h200 / 2
        out[i, :, 1] = preds[i, :, 1] * h200 / h + centers[i][1] - h200 / 2
    return out


class LandmarkDetector:
    """face_alignment's FaceAlignment (2D): S3FD detect → center and scale
    (reference scale 195, the center moved up by 12% of the box) → 256 crop
    → FAN on the device → 68 landmarks in image coordinates. ``state`` is
    the FAN state dict (face_alignment's names); None means seeded random
    weights."""

    RESOLUTION = 256
    REFERENCE_SCALE = 195.0

    def __init__(self, state=None, face_detector=None, num_modules: int = 4,
                 device=None):
        self.device = resolve_device(device)
        with torch.device("meta"):
            model = FAN(num_modules)
        if state is None:
            model.to_empty(device=self.device)
            random_init_(model, 0)
        else:
            model.load_state_dict(state, strict=True, assign=True)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self._detector = face_detector

    @property
    def detector(self):
        """The S3FD detector of ``get_landmarks``, seeded at first use when
        none was given (``landmarks_from_boxes`` needs none)."""
        if self._detector is None:
            from mere_fusion_tpu_torch.models.s3fd import FaceDetector

            self._detector = FaceDetector(device=self.device)
        return self._detector

    @classmethod
    def from_checkpoints(cls, fan_path: str, s3fd_path: Optional[str] = None,
                         num_modules: int = 4, device=None) -> "LandmarkDetector":
        """A face_alignment 2DFAN4 ``.pth`` and, optionally, the reference
        ``s3fd.pth`` (seeded S3FD weights without it)."""
        from mere_fusion_tpu_torch.models.s3fd import FaceDetector
        from mere_fusion_tpu_torch.utils.torch_convert import (
            load_torch_checkpoint,
            reference_state,
        )

        device = resolve_device(device)
        det = FaceDetector.from_checkpoint(s3fd_path, device=device) if s3fd_path else None
        state = reference_state(load_torch_checkpoint(fan_path), lambda: FAN(num_modules))
        return cls(state=state, face_detector=det, num_modules=num_modules, device=device)

    @torch.no_grad()
    def heatmaps(self, crops01: np.ndarray) -> np.ndarray:
        """[B, 256, 256, 3] float in [0, 1] → [B, 64, 64, 68] (NHWC)."""
        x = torch.from_numpy(np.ascontiguousarray(crops01, np.float32)).to(self.device)
        hm = self.model(x.permute(0, 3, 1, 2))[-1]
        return hm.permute(0, 2, 3, 1).cpu().numpy()

    @staticmethod
    def box_to_center_scale(d) -> tuple[np.ndarray, float]:
        center = np.array([(d[0] + d[2]) / 2.0, (d[1] + d[3]) / 2.0])
        center[1] -= (d[3] - d[1]) * 0.12
        scale = (d[2] - d[0] + d[3] - d[1]) / LandmarkDetector.REFERENCE_SCALE
        return center, float(scale)

    def landmarks_from_boxes(self, image_rgb: np.ndarray,
                             boxes) -> list[np.ndarray]:
        """[68, 2] landmarks for each given (x1, y1, x2, y2) face box, with no
        detection of its own (the avatar preparation has its smoothed S3FD
        boxes already)."""
        results = []
        for d in boxes:
            d = np.clip(np.asarray(d, np.float32), 0, None)
            center, scale = self.box_to_center_scale(d)
            crop = crop_face(image_rgb, center, scale, self.RESOLUTION)
            hm = self.heatmaps(crop[None].astype(np.float32) / 255.0)
            pts = heatmaps_to_landmarks(hm, [center], [scale])
            results.append(pts[0].astype(np.float32))
        return results

    def get_landmarks(self, image_rgb: np.ndarray) -> list[np.ndarray]:
        """One RGB uint8 image → a [68, 2] array for each face found."""
        dets = self.detector.detect_batch(
            image_rgb[None, :, :, ::-1].copy()  # S3FD wants BGR
        )[0]
        return self.landmarks_from_boxes(image_rgb, dets)
