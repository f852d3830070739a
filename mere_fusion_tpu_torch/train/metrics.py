"""Evaluation metrics: PSNR, SSIM, landmark distance, a running meter.

Port of mere_fusion_tpu/train/metrics.py (the reference's PSNR/LMD meters;
its LPIPS meter is ``models/lpips.make_lpips_fn(..., normalize=True)`` in a
MetricMeter). SSIM is the JAX package's global-statistics form, with
population variances as ``jnp.var`` takes them.
"""
from __future__ import annotations

import numpy as np
import torch


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Global-statistics SSIM over [H, W, C] images (no window)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x, mu_y = pred.mean(), target.mean()
    var_x, var_y = pred.var(correction=0), target.var(correction=0)
    cov = ((pred - mu_x) * (target - mu_y)).mean()
    return ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
        (mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2))


def landmark_distance(lms_pred: np.ndarray, lms_gt: np.ndarray) -> float:
    """Mean L2 distance of centred landmarks [N, K, 2] (the reference's LMD
    over the lips landmarks)."""
    lms_pred = lms_pred - lms_pred.mean(axis=1, keepdims=True)
    lms_gt = lms_gt - lms_gt.mean(axis=1, keepdims=True)
    return float(np.linalg.norm(lms_pred - lms_gt, axis=-1).mean())


class MetricMeter:
    """Running mean of ``fn(pred, target)``, the reference's measure and
    report cycle."""

    def __init__(self, fn, name: str):
        self.fn = fn
        self.name = name
        self.total = 0.0
        self.count = 0

    def update(self, pred, target) -> float:
        v = float(self.fn(pred, target))
        self.total += v
        self.count += 1
        return v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def report(self) -> str:
        return f"{self.name} = {self.mean:.4f}"
