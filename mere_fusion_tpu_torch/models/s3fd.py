"""S3FD face detector.

Port of mere_fusion_tpu/models/s3fd.py, itself the twin of the reference's
VGG-based S3FD (wav2lip/face_detection/detection/sfd/net_s3fd.py): a VGG16
trunk, six detection scales with L2Norm-scaled shallow heads and max-out
background on the first. Modules carry the reference's names (``conv1_1`` …
``fc7``, ``conv6_1`` … ``conv7_2``, ``conv3_3_norm``, ``*_mbox_conf`` /
``*_mbox_loc``), so a reference ``s3fd.pth`` loads with
``load_state_dict(strict=True)``. NCHW inside, as the reference.

The box decode runs on the device over every anchor (``decode_detections``);
thresholding and NMS run on the host (``nms``, ``FaceDetector.detect_batch``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mere_fusion_tpu_torch.device import random_init_, resolve_device

# (name, out channels, name of the feature kept) in order; "pool" = 2×2 max pool
_VGG = (
    ("conv1_1", 64, None), ("conv1_2", 64, None), ("pool",),
    ("conv2_1", 128, None), ("conv2_2", 128, None), ("pool",),
    ("conv3_1", 256, None), ("conv3_2", 256, None), ("conv3_3", 256, "f3_3"), ("pool",),
    ("conv4_1", 512, None), ("conv4_2", 512, None), ("conv4_3", 512, "f4_3"), ("pool",),
    ("conv5_1", 512, None), ("conv5_2", 512, None), ("conv5_3", 512, "f5_3"), ("pool",),
)
# (feature, head base name, its channels, class channels)
_HEADS = (
    ("f3_3", "conv3_3_norm_mbox", 256, 4), ("f4_3", "conv4_3_norm_mbox", 512, 2),
    ("f5_3", "conv5_3_norm_mbox", 512, 2), ("fc7", "fc7_mbox", 1024, 2),
    ("f6_2", "conv6_2_mbox", 512, 2), ("f7_2", "conv7_2_mbox", 256, 2),
)


class L2Norm(nn.Module):
    """Channel L2 normalisation with a learned per-channel scale."""

    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.scale = scale
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = x.pow(2).sum(dim=1, keepdim=True).sqrt() + 1e-10
        return x / norm * self.weight.view(1, -1, 1, 1)


class S3FD(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for spec in _VGG:
            if spec[0] != "pool":
                setattr(self, spec[0], nn.Conv2d(cin, spec[1], 3, 1, 1))
                cin = spec[1]
        self.fc6 = nn.Conv2d(512, 1024, 3, 1, 3)
        self.fc7 = nn.Conv2d(1024, 1024, 1, 1, 0)
        self.conv6_1 = nn.Conv2d(1024, 256, 1, 1, 0)
        self.conv6_2 = nn.Conv2d(256, 512, 3, 2, 1)
        self.conv7_1 = nn.Conv2d(512, 128, 1, 1, 0)
        self.conv7_2 = nn.Conv2d(128, 256, 3, 2, 1)
        self.conv3_3_norm = L2Norm(256, 10.0)
        self.conv4_3_norm = L2Norm(512, 8.0)
        self.conv5_3_norm = L2Norm(512, 5.0)
        for _feat, base, c, ncls in _HEADS:
            setattr(self, f"{base}_conf", nn.Conv2d(c, ncls, 3, 1, 1))
            setattr(self, f"{base}_loc", nn.Conv2d(c, 4, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """x: [B, 3, H, W] BGR float, mean-subtracted (104, 117, 123).
        Returns (cls [B, 2, h, w], reg [B, 4, h, w]) for the six scales."""
        feats = {}
        h = x
        for spec in _VGG:
            if spec[0] == "pool":
                h = F.max_pool2d(h, 2, 2)
                continue
            h = F.relu(getattr(self, spec[0])(h))
            if spec[2]:
                feats[spec[2]] = h
        h = F.relu(self.fc6(h))
        feats["fc7"] = h = F.relu(self.fc7(h))
        h = F.relu(self.conv6_1(h))
        feats["f6_2"] = h = F.relu(self.conv6_2(h))
        h = F.relu(self.conv7_1(h))
        feats["f7_2"] = F.relu(self.conv7_2(h))
        feats["f3_3"] = self.conv3_3_norm(feats["f3_3"])
        feats["f4_3"] = self.conv4_3_norm(feats["f4_3"])
        feats["f5_3"] = self.conv5_3_norm(feats["f5_3"])
        out = []
        for feat, base, _c, ncls in _HEADS:
            cls = getattr(self, f"{base}_conf")(feats[feat])
            reg = getattr(self, f"{base}_loc")(feats[feat])
            if ncls == 4:   # max-out background over the first three channels
                bmax = cls[:, :3].max(dim=1, keepdim=True).values
                cls = torch.cat([bmax, cls[:, 3:]], dim=1)
            out.append((cls, reg))
        return out


@torch.no_grad()
def init_s3fd_(model: S3FD, seed: int) -> S3FD:
    """Seeded weights (``random_init_``) with each L2Norm's scale at its
    reference value (10, 8, 5), as the JAX init makes them."""
    random_init_(model, seed)
    for m in model.modules():
        if isinstance(m, L2Norm):
            m.weight.fill_(m.scale)
    return model


def decode_detections(outputs, variances=(0.1, 0.2)) -> torch.Tensor:
    """Every anchor's box → [B, A, 5] (x1, y1, x2, y2, score), anchors in
    the JAX order: scale by scale, row-major over each map."""
    rows = []
    for i, (cls, reg) in enumerate(outputs):
        b, _, fh, fw = cls.shape
        stride = 2 ** (i + 2)
        score = torch.softmax(cls, dim=1)[:, 1]                    # [B, fh, fw]
        reg = reg.permute(0, 2, 3, 1)                               # [B, fh, fw, 4]
        cx = stride / 2 + torch.arange(fw, device=cls.device, dtype=torch.float32) * stride
        cy = stride / 2 + torch.arange(fh, device=cls.device, dtype=torch.float32) * stride
        prior_xy = torch.stack(torch.meshgrid(cx, cy, indexing="xy"), dim=-1)
        prior_wh = stride * 4.0
        xy = prior_xy + reg[..., :2] * variances[0] * prior_wh
        wh = prior_wh * torch.exp(reg[..., 2:] * variances[1])
        x1y1 = xy - wh / 2
        x2y2 = x1y1 + wh
        rows.append(torch.cat([x1y1, x2y2, score[..., None]], dim=-1).reshape(b, -1, 5))
    return torch.cat(rows, dim=1)


def nms(dets: np.ndarray, thresh: float = 0.3) -> list[int]:
    """Greedy IoU NMS (reference sfd/bbox.py)."""
    if len(dets) == 0:
        return []
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return keep


class FaceDetector:
    """Batched face detection: forward and decode on the device, the score
    filter and NMS on the host. ``state`` is the S3FD state dict (reference
    names); None means seeded random weights."""

    MEAN_BGR = (104.0, 117.0, 123.0)

    def __init__(self, state=None, device=None):
        self.device = resolve_device(device)
        with torch.device("meta"):
            model = S3FD()
        if state is None:
            model.to_empty(device=self.device)
            init_s3fd_(model, 0)
        else:
            model.load_state_dict(state, strict=True, assign=True)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self._mean = torch.tensor(self.MEAN_BGR, device=self.device).view(1, 3, 1, 1)

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "FaceDetector":
        """A reference ``s3fd.pth`` (``module.`` prefix allowed)."""
        from mere_fusion_tpu_torch.utils.torch_convert import (
            load_torch_checkpoint,
            reference_state,
        )

        return cls(state=reference_state(load_torch_checkpoint(path), S3FD), **kw)

    @torch.no_grad()
    def decode_batch(self, imgs_bgr: np.ndarray) -> torch.Tensor:
        """[B, H, W, 3] uint8 → every anchor's [B, A, 5] on the device."""
        x = torch.from_numpy(np.ascontiguousarray(imgs_bgr)).to(self.device)
        x = x.permute(0, 3, 1, 2).float() - self._mean
        return decode_detections(self.model(x))

    def detect_batch(self, imgs_bgr: np.ndarray, score_thresh: float = 0.5,
                     nms_thresh: float = 0.3) -> list[np.ndarray]:
        """imgs_bgr: [B, H, W, 3] uint8. Returns per-image [K, 5] arrays."""
        dets = self.decode_batch(imgs_bgr).cpu().numpy()
        results = []
        for d in dets:
            d = d[d[:, 4] > 0.05]
            keep = nms(d, nms_thresh)
            d = d[keep] if keep else np.zeros((0, 5), np.float32)
            results.append(d[d[:, 4] > score_thresh])
        return results
