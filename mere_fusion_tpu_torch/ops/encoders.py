"""Frequency and spherical-harmonics input encodings.

Port of mere_fusion_tpu/ops/encoders.py (same constants, sign conventions
and column order as the reference CUDA extensions freqencoder/shencoder).
Tiny elementwise polynomials in plain PyTorch: no kernel of their own.
"""
from __future__ import annotations

import torch


def freq_encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    """[N, D] → [N, D + D*2*degree]: [x, sin(2^0 x), cos(2^0 x), sin(2^1 x)...]

    Identity first, then for each (freq, phase) column all D dims together.
    """
    outs = [x]
    for k in range(degree):
        f = float(2**k)
        outs.append(torch.sin(f * x))
        outs.append(torch.cos(f * x))
    return torch.cat(outs, dim=-1)


def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real SH basis up to 4 bands over unit directions [N, 3] → [N, degree²]."""
    if not 1 <= degree <= 4:
        raise ValueError("sh_encode supports degree 1..4")
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, yz, xz = x * y, y * z, x * z
    x2, y2, z2 = x * x, y * y, z * z

    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (x2 - y2),
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)
