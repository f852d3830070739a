"""Volume-rendering geometry for the ER-NeRF serving step.

Port of the parts of mere_fusion_tpu/models/ernerf/renderer.py the serving
step uses: the density grid, the ray/box slab test, voxel lookup, the
occupancy probe that places each ray's sample span, camera rays from a
pose, and the front-to-back composite (the tests' oracle; the step
composites inside kernel K2). Training-time grid maintenance, the plain
marcher and the torso pass are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DensityGrid:
    grid: torch.Tensor          # [G³] float32, −1 marks untrained cells
    occupancy: torch.Tensor     # [G³] bool
    mean_density: torch.Tensor  # scalar

    @classmethod
    def create(cls, grid_size: int, device=None) -> "DensityGrid":
        """A fresh grid: fully occupied (like instant-NGP before training)."""
        n = grid_size**3
        return cls(grid=torch.zeros(n, device=device),
                   occupancy=torch.ones(n, dtype=torch.bool, device=device),
                   mean_density=torch.zeros((), device=device))


def intersect_aabb(rays_o, rays_d, bound: float, min_near: float = 0.05):
    """Slab test against the [−bound, bound]³ box → (near, far, valid)."""
    safe = torch.where(rays_d.abs() < 1e-9, torch.full_like(rays_d, 1e-9), rays_d)
    inv = 1.0 / safe
    t0 = (-bound - rays_o) * inv
    t1 = (bound - rays_o) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    near = torch.clamp(tmin, min=min_near)
    far = torch.maximum(tmax, near + 1e-4)
    return near, far, tmax > tmin


def voxel_index(xyz, bound: float, grid_size: int):
    """[..., 3] position → (flat voxel id in raster order, inside)."""
    x01 = (xyz + bound) / (2 * bound)
    ijk = torch.floor(x01 * grid_size).to(torch.int64)
    inside = ((ijk >= 0) & (ijk < grid_size)).all(dim=-1)
    ijk = ijk.clamp(0, grid_size - 1)
    flat = (ijk[..., 0] * grid_size + ijk[..., 1]) * grid_size + ijk[..., 2]
    return flat, inside


def linspace01(n: int, device=None) -> torch.Tensor:
    """float32 [0, 1] in n steps with jnp.linspace's rounding: i · f32(1/(n−1))
    and an exact 1 at the end (torch.linspace rounds some steps the other
    way, which would move sample depths by an ulp against the JAX twin)."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = torch.tensor(1.0, dtype=torch.float32) / (n - 1)
    head = torch.arange(n - 1, dtype=torch.float32) * step
    return torch.cat([head, torch.ones(1)]).to(device)


def select_occupied_depths(rays_o, rays_d, near, far, density: DensityGrid,
                           bound: float, grid_size: int, n_candidates: int,
                           n_steps: int):
    """Probe n_candidates depths per ray, then sample n_steps uniformly in
    the [first, last] occupied span (±1 candidate pad).
    Returns (z [N, K], dt [N, 1], sample_valid [N, K])."""
    n = rays_o.shape[0]
    frac = linspace01(n_candidates, near.device)
    z_all = near[:, None] + (far - near)[:, None] * frac[None, :]
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]
    vox, inside = voxel_index(xyz, bound, grid_size)
    occ = density.occupancy[vox] & inside
    any_occ = occ.any(dim=-1)
    occ_i = occ.to(torch.int8)
    first = torch.argmax(occ_i, dim=-1)
    last = n_candidates - 1 - torch.argmax(occ_i.flip(-1), dim=-1)
    step = (far - near) / (n_candidates - 1)
    zmin = near + torch.clamp(first - 1, min=0) * step
    zmax = near + torch.clamp(last + 1, max=n_candidates - 1) * step
    kfrac = linspace01(n_steps, near.device)
    z = zmin[:, None] + (zmax - zmin)[:, None] * kfrac[None, :]
    dt = ((zmax - zmin) / n_steps)[:, None]
    return z, dt, any_occ[:, None].expand(n, n_steps)


def composite(sigmas, colors, z, dt, valid, bg_color, t_threshold: float = 1e-4):
    """Front-to-back alpha compositing with masked samples: sigmas [N,K],
    colors [N,K,3], z [N,K], dt [N,1], valid [N,K]."""
    alpha = 1.0 - torch.exp(-sigmas * dt)
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    weights = torch.where(trans > t_threshold, alpha * trans, torch.zeros_like(trans))
    ws = weights.sum(dim=-1, keepdim=True)
    image = (weights[..., None] * colors).sum(dim=1) + (1.0 - ws) * bg_color
    depth = (weights * z).sum(dim=-1)
    return {"image": image, "depth": depth, "weights_sum": ws[:, 0]}


def get_rays(pose: torch.Tensor, intrinsics, H: int, W: int):
    """Full-image rays from a c2w pose [4, 4] and (fx, fy, cx, cy), in the
    OpenGL convention (dirs = [(x−cx)/fx, −(y−cy)/fy, −1]).
    Returns (rays_o [H·W, 3], rays_d [H·W, 3])."""
    fx, fy, cx, cy = intrinsics
    f32 = dict(dtype=torch.float32, device=pose.device)
    j, i = torch.meshgrid(torch.arange(H, **f32), torch.arange(W, **f32), indexing="ij")
    xs = (i - cx) / fx
    ys = -(j - cy) / fy
    dirs = torch.stack([xs, ys, -torch.ones_like(i)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
