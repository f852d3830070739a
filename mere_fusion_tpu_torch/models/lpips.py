"""LPIPS perceptual distance with the AlexNet backbone, NCHW.

Port of mere_fusion_tpu/models/lpips.py, the twin of the
``lpips.LPIPS(net='alex')`` criterion that the reference ER-NeRF trainer
uses for its patch and lips fine-tuning losses: a fixed scaling layer,
torchvision's ``alexnet.features`` tapped after each of its five ReLUs,
each tap scaled to unit length over its channels, the squared difference
through a 1×1 "lin" head of non-negative weights, the spatial mean, the sum
over the five layers and the mean over the batch.

Module names follow torchvision (``net.features.{0,3,6,8,10}``) and the
lpips package (``lins.{i}.model.1``), so ``convert_lpips`` is a rename. The
reference builds its criterion in eval mode, where the lin heads' dropout is
the identity; here it is an ``nn.Identity``.

Call convention, as the JAX package keeps it from the reference: the
training losses pass [0, 1] patches as they are (no ``normalize``); the
LPIPS meter passes ``normalize=True``, which maps [0, 1] to [−1, 1] first.
Without weight files the heads are seeded random weights: a structural
check, not a perceptual metric.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from mere_fusion_tpu_torch.device import resolve_device

# lpips.ScalingLayer's fixed constants
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
ALEX_CHANNELS = (64, 192, 384, 256, 256)
# torchvision alexnet.features: the index of each conv, the ReLU after each tap
ALEX_CONVS = (0, 3, 6, 8, 10)
ALEX_TAPS = (1, 4, 7, 9, 11)


class AlexNetFeatures(nn.Module):
    """torchvision's ``alexnet.features`` up to its last ReLU; forward
    returns the five tap activations."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU())

    def forward(self, x) -> list:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in ALEX_TAPS:
                taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    """lpips' lin head: (dropout,) 1×1 conv to one channel, no bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """Perceptual distance of x and y, [B, 3, H, W] RGB with H, W ≥ 32
    (smaller inputs pool to empty maps, as in the torch original). Returns
    the mean over the batch, a scalar."""

    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        self.lins = nn.ModuleList(NetLinLayer(c) for c in ALEX_CHANNELS)
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x, y, normalize: bool = False):
        if normalize:                       # [0, 1] → [−1, 1]
            x = 2.0 * x - 1.0
            y = 2.0 * y - 1.0
        fx = self.net((x - self.shift) / self.scale)
        fy = self.net((y - self.shift) / self.scale)
        total = 0.0
        for lin, a, b in zip(self.lins, fx, fy):
            a = a / torch.sqrt((a * a).sum(1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b * b).sum(1, keepdim=True) + 1e-10)
            # lpips keeps its lin weights non-negative at run time
            d = nn.functional.conv2d((a - b) ** 2, lin.model[1].weight.abs())
            total = total + d.mean(dim=(2, 3))          # [B, 1]
        return total.mean()


@torch.no_grad()
def init_lpips_(module: LPIPS, seed: int = 0) -> LPIPS:
    """Seeded random weights as flax initialises the JAX twin: conv kernels
    N(0, 1/fan_in), biases 0, lin heads U(0, 0.1)."""
    gen = torch.Generator(device=module.shift.device).manual_seed(seed)
    for conv in (module.net.features[i] for i in ALEX_CONVS):
        conv.weight.normal_(0.0, conv.weight[0].numel() ** -0.5, generator=gen)
        conv.bias.zero_()
    for lin in module.lins:
        lin.model[1].weight.uniform_(0.0, 0.1, generator=gen)
    return module


def convert_lpips(alex_sd: Mapping[str, Any], lpips_sd: Mapping[str, Any]) -> dict:
    """The port's LPIPS state dict from torch state dicts.

    alex_sd: torchvision's alexnet state dict (``features.{0,3,6,8,10}.*``)
    or an lpips full dump (``net.slice{1..5}.M.*``). lpips_sd: the lpips
    package's lin heads (``lin{i}.model.1.weight`` or
    ``lins.{i}.model.1.weight``). A missing lin head raises KeyError."""
    out = {}
    if any(k.startswith("features.") for k in alex_sd):
        for j in ALEX_CONVS:
            out[f"net.features.{j}.weight"] = alex_sd[f"features.{j}.weight"]
            out[f"net.features.{j}.bias"] = alex_sd[f"features.{j}.bias"]
    else:
        for k in alex_sd:
            if ".weight" in k and k.startswith("net.slice"):
                s = int(k.split("slice")[1].split(".")[0])
                base = k.rsplit(".", 1)[0]
                j = ALEX_CONVS[s - 1]
                out[f"net.features.{j}.weight"] = alex_sd[f"{base}.weight"]
                out[f"net.features.{j}.bias"] = alex_sd[f"{base}.bias"]
    for i, c in enumerate(ALEX_CHANNELS):
        w = next((lpips_sd[key] for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight")
                  if key in lpips_sd), None)
        if w is None:
            raise KeyError(f"lin{i} weight not found in lpips state dict")
        out[f"lins.{i}.model.1.weight"] = w.reshape(1, c, 1, 1)
    return {k: torch.as_tensor(v).detach().float().cpu() for k, v in out.items()}


def make_lpips_fn(alex_path: str | None = None, lpips_path: str | None = None,
                  module: LPIPS | None = None, normalize: bool = False, device=None):
    """``fn(pred, gt) → scalar`` for the train step's LPIPS term and the
    LPIPS meter; pred and gt are NHWC [B, H, W, 3], as the JAX twin takes
    them. The weights: ``module``, else the two files through
    ``convert_lpips`` when both are given, else seeded random ones (seed 0).
    The module is frozen (gradients reach the inputs only) and lives on
    ``device``, None meaning the current CUDA device."""
    device = resolve_device(device)
    if module is None:
        module = LPIPS()
        if alex_path and lpips_path:
            from mere_fusion_tpu_torch.utils.torch_convert import load_torch_checkpoint

            module.load_state_dict(convert_lpips(load_torch_checkpoint(alex_path),
                                                 load_torch_checkpoint(lpips_path)), strict=True)
        else:
            init_lpips_(module, 0)
    module = module.to(device).eval().requires_grad_(False)

    def fn(pred, gt):
        return module(pred.permute(0, 3, 1, 2), gt.permute(0, 3, 1, 2), normalize=normalize)

    fn.module = module
    return fn
