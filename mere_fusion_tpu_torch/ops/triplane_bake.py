"""Baked triplanes: the hash encode evaluated once on a texel grid.

Port of mere_fusion_tpu/ops/triplane_bake.py (``bake_plane``,
``bake_triplanes``). At inference the hash tables are constants, so each
plane's level pyramid is baked into a dense [R, R, L·C] texture and the
serving step samples it (kernel K2) instead of gathering 12 levels × 4
corners per plane. Bakes in chunks on the tables' device with the plain
``grid_encode``.
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
