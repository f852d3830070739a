"""Baked triplanes: the hash encode evaluated once on a texel grid.

Port of mere_fusion_tpu/ops/triplane_bake.py (``bake_plane``,
``bake_triplanes``, ``sample_plane``, ``encode_x_baked``). At inference the
hash tables are constants, so each plane's level pyramid is baked into a
dense [R, R, L·C] texture and the serving step samples it (kernel K2, or
``encode_x_baked`` in the ``nearest``/``bilinear`` sample modes) instead of
gathering 12 levels × 4 corners per plane. Bakes in chunks on the tables'
device with the plain ``grid_encode``.
"""
from __future__ import annotations

import torch

from mere_fusion_tpu_torch.ops.hashgrid import GridSpec, grid_encode


@torch.no_grad()
def bake_plane(table: torch.Tensor, spec: GridSpec, bound: float,
               resolution: int = 512, chunk: int = 262144) -> torch.Tensor:
    """The exact hash encode on a texel-centre grid → [R, R, L·C] (row = the
    second coordinate, column = the first)."""
    r = resolution
    centers = ((torch.arange(r, dtype=torch.float32, device=table.device) + 0.5)
               / r * 2 * bound - bound)
    gy, gx = torch.meshgrid(centers, centers, indexing="ij")
    coords = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    outs = [grid_encode(table, coords[i: i + chunk], spec, bound)
            for i in range(0, r * r, chunk)]
    return torch.cat(outs).reshape(r, r, -1)


@torch.no_grad()
def bake_triplanes(planes: dict, spec: GridSpec, bound: float,
                   resolution: int = 512, dtype=None) -> dict:
    """plane_xy/plane_yz/plane_xz tables → textures, each stored flat
    [R·R, C] (the JAX package's layout); ``dtype`` (e.g. bfloat16) casts."""
    out = {}
    for name in ("plane_xy", "plane_yz", "plane_xz"):
        plane = bake_plane(planes[name], spec, bound, resolution)
        if dtype is not None:
            plane = plane.to(dtype)
        out[name] = plane.reshape(resolution * resolution, -1)
    return out


def sample_plane(plane: torch.Tensor, uv: torch.Tensor, bound: float,
                 method: str = "bilinear") -> torch.Tensor:
    """Texture sample of plane [R, R, C] (row = v, column = u) or flat [R·R,
    C] (R inferred) at uv [N, 2] in [−bound, bound] (u first) → [N, C]
    float32. ``nearest`` takes the texel whose centre is closest (ties to
    even); ``bilinear`` weighs the four around uv, clamped at the edges."""
    if plane.dim() == 3:
        r = plane.shape[0]
        flat = plane.reshape(r * r, -1)
    else:
        r = int(round(plane.shape[0] ** 0.5))
        flat = plane
    pos = (uv + bound) / (2 * bound) * r - 0.5          # texel-centre aligned
    if method == "nearest":
        xi = torch.clamp(torch.round(pos[:, 0]).to(torch.int64), 0, r - 1)
        yi = torch.clamp(torch.round(pos[:, 1]).to(torch.int64), 0, r - 1)
        return flat[yi * r + xi].float()
    if method != "bilinear":
        raise ValueError(f"sample method {method!r} is not 'nearest' or 'bilinear'")
    pf = torch.floor(pos)
    frac = pos - pf
    x0 = torch.clamp(pf[:, 0].to(torch.int64), 0, r - 1)
    y0 = torch.clamp(pf[:, 1].to(torch.int64), 0, r - 1)
    x1 = torch.clamp(x0 + 1, max=r - 1)
    y1 = torch.clamp(y0 + 1, max=r - 1)
    f00, f01 = flat[y0 * r + x0].float(), flat[y0 * r + x1].float()
    f10, f11 = flat[y1 * r + x0].float(), flat[y1 * r + x1].float()
    wx, wy = frac[:, 0:1], frac[:, 1:2]
    return (f00 * (1 - wx) + f01 * wx) * (1 - wy) + (f10 * (1 - wx) + f11 * wx) * wy


def encode_x_baked(baked: dict, xyz: torch.Tensor, bound: float,
                   method: str = "bilinear") -> torch.Tensor:
    """Triplane features from baked textures, in place of the network's
    encode_x at inference: xyz [N, 3] → [N, 3·L·C] (planes xy, yz, xz)."""
    return torch.cat([sample_plane(baked["plane_xy"], xyz[:, :2], bound, method),
                      sample_plane(baked["plane_yz"], xyz[:, 1:], bound, method),
                      sample_plane(baked["plane_xz"], xyz[:, 0::2], bound, method)], dim=-1)
