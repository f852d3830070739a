"""Volume rendering for ER-NeRF serving and training.

Port of mere_fusion_tpu/models/ernerf/renderer.py: the density grid, the
ray/box slab test, voxel lookup, the occupancy probe that places each ray's
sample span, camera rays from a pose, the front-to-back composite (the K2
serving step composites inside the kernel), the block-shared probe
(``select_depths_blocked``), and ``plan_rays`` / ``shade`` /
``render_rays`` with the static ray compaction (``max_active_rays``) and
its scatter back onto the frame: the training path and the
``nearest``/``bilinear`` serving step. The density-grid refresh is
``update_density_grid``, and the torso pass over the pixel grid is
``render_torso_background``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

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


def _occupied_span(rays_o, rays_d, near, far, density: DensityGrid, bound: float,
                   grid_size: int, n_candidates: int):
    """Probe n_candidates depths per ray → (zmin, zmax, any occupied): the
    [first, last] occupied candidate with one candidate of pad each side."""
    frac = linspace01(n_candidates, near.device)
    z_all = near[:, None] + (far - near)[:, None] * frac[None, :]
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]
    vox, inside = voxel_index(xyz, bound, grid_size)
    occ = density.occupancy[vox] & inside
    occ_i = occ.to(torch.int8)
    first = torch.argmax(occ_i, dim=-1)
    last = n_candidates - 1 - torch.argmax(occ_i.flip(-1), dim=-1)
    step = (far - near) / (n_candidates - 1)
    zmin = near + torch.clamp(first - 1, min=0) * step
    zmax = near + torch.clamp(last + 1, max=n_candidates - 1) * step
    return zmin, zmax, occ.any(dim=-1)


def _span_samples(zmin, zmax, valid, n_steps: int):
    """n_steps uniform samples in each ray's span → (z [N, K], dt [N, 1],
    sample_valid [N, K])."""
    kfrac = linspace01(n_steps, zmin.device)
    z = zmin[:, None] + (zmax - zmin)[:, None] * kfrac[None, :]
    dt = ((zmax - zmin) / n_steps)[:, None]
    return z, dt, valid[:, None].expand(zmin.shape[0], n_steps)


def select_occupied_depths(rays_o, rays_d, near, far, density: DensityGrid,
                           bound: float, grid_size: int, n_candidates: int,
                           n_steps: int):
    """Probe n_candidates depths per ray, then sample n_steps uniformly in
    the [first, last] occupied span (±1 candidate pad).
    Returns (z [N, K], dt [N, 1], sample_valid [N, K])."""
    return _span_samples(*_occupied_span(rays_o, rays_d, near, far, density, bound,
                                         grid_size, n_candidates), n_steps)


def select_depths_blocked(rays_o, rays_d, near, far, density: DensityGrid, bound: float,
                          grid_size: int, n_candidates: int, n_steps: int, block: int,
                          H: int, W: int):
    """Block-shared occupancy span: probe the central ray of each block×block
    pixel tile, and sample n_steps uniformly in its span for every ray of the
    tile (rays of a tile are near-parallel). Rays are the H×W frame's in
    raster order. Returns (z [N, K], dt [N, 1], sample_valid [N, K])."""
    hb, wb = H // block, W // block
    dev = rays_o.device
    ctr = ((torch.arange(hb, device=dev) * block + block // 2)[:, None] * W
           + (torch.arange(wb, device=dev) * block + block // 2)[None, :]).reshape(-1)
    span = _occupied_span(rays_o[ctr], rays_d[ctr], near[ctr], far[ctr], density, bound,
                          grid_size, n_candidates)

    def to_pixels(v):
        return (v.reshape(hb, wb).repeat_interleave(block, 0).repeat_interleave(block, 1)
                .reshape(-1))

    return _span_samples(*map(to_pixels, span), n_steps)


def composite(sigmas, colors, z, dt, valid, bg_color, extras: dict | None = None,
              t_threshold: float = 1e-4):
    """Front-to-back alpha compositing with masked samples: sigmas [N,K],
    colors [N,K,3], z [N,K], dt [N,1], valid [N,K]; extras: name → [N,K,Ce]
    accumulated with the same weights."""
    alpha = 1.0 - torch.exp(-sigmas * dt)
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    weights = torch.where(trans > t_threshold, alpha * trans, torch.zeros_like(trans))
    ws = weights.sum(dim=-1, keepdim=True)
    image = (weights[..., None] * colors).sum(dim=1) + (1.0 - ws) * bg_color
    depth = (weights * z).sum(dim=-1)
    out = {"image": image, "depth": depth, "weights_sum": ws[:, 0]}
    for name, v in (extras or {}).items():
        out[name] = (weights[..., None] * v).sum(dim=1)
    return out


def plan_rays(rays_o, rays_d, density: DensityGrid, bound: float, grid_size: int,
              n_candidates: int = 64, n_steps: int = 16, min_near: float = 0.05,
              max_active_rays: int = 0, probe_block: int = 0,
              image_hw: tuple | None = None) -> dict:
    """Occupancy probing, sample placement and static ray compaction, no
    network: returns xyz [M,K,3] (clipped to the box), dirs [M,3], z [M,K],
    dt [M,1], valid [M,K] and sel. The probe is block-shared
    (select_depths_blocked) when probe_block > 1 and image_hw = (H, W) is
    given, else per ray. When 0 < max_active_rays < N, the first
    max_active_rays rays in a stable order that puts the rays with a valid
    sample first are kept and sel [M] holds their indices (else None)."""
    n = rays_o.shape[0]
    near, far, ray_valid = intersect_aabb(rays_o, rays_d, bound, min_near)
    if probe_block > 1 and image_hw is not None:
        z, dt, sample_valid = select_depths_blocked(rays_o, rays_d, near, far, density, bound,
                                                    grid_size, n_candidates, n_steps,
                                                    probe_block, *image_hw)
    else:
        z, dt, sample_valid = select_occupied_depths(rays_o, rays_d, near, far, density,
                                                     bound, grid_size, n_candidates, n_steps)
    sample_valid = sample_valid & ray_valid[:, None]
    sel = None
    if 0 < max_active_rays < n:
        active = sample_valid.any(dim=-1)
        # stable, as jnp.argsort: the kept rays are the first in raster order
        sel = torch.argsort((~active).to(torch.uint8), stable=True)[:max_active_rays]
        z, dt, sample_valid = z[sel], dt[sel], sample_valid[sel]
        rays_o, rays_d = rays_o[sel], rays_d[sel]
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    xyz = torch.clamp(xyz, -bound, bound)
    return {"xyz": xyz, "dirs": rays_d, "z": z, "dt": dt, "valid": sample_valid, "sel": sel}


def shade(apply_fn: Callable, plan: dict, bg_color, training: bool = False, enc_x=None,
          n_rays: int | None = None) -> dict:
    """Network evaluation and compositing over a plan_rays() plan.

    apply_fn(pos, dirs [M·K,3], training) → (sigma, color, amb_aud,
    amb_eye, unc), a closure over the network and the frame's conditions;
    pos is enc_x [M·K, F] (features encoded apart) when given, else xyz
    [M·K, 3]. Returns composite()'s dict with ambient_aud, ambient_eye and
    uncertainty [N, 1] accumulated beside the image. A compacted plan's
    results are scattered back onto n_rays rays: the rest are background
    (bg_color [3] or per ray [n_rays, 3]) with zero depth and extras."""
    z, dt, valid, sel = plan["z"], plan["dt"], plan["valid"], plan["sel"]
    m, k = z.shape
    xyz = plan["xyz"]
    dirs = plan["dirs"][:, None, :].expand(xyz.shape)
    pos = enc_x if enc_x is not None else xyz.reshape(-1, 3)
    sigma, color, amb_aud, amb_eye, unc = apply_fn(pos, dirs.reshape(-1, 3), training)
    extras = {"ambient_aud": amb_aud.reshape(m, k, 1),
              "ambient_eye": amb_eye.reshape(m, k, 1),
              "uncertainty": unc.reshape(m, k, 1)}
    if sel is None:
        return composite(sigma.reshape(m, k), color.reshape(m, k, 3), z, dt, valid, bg_color,
                         extras=extras)
    if n_rays is None:
        raise ValueError("shade on a compacted plan needs n_rays")
    bg_s = bg_color[sel] if bg_color.dim() == 2 else bg_color
    sub = composite(sigma.reshape(m, k), color.reshape(m, k, 3), z, dt, valid, bg_s,
                    extras=extras)
    image = bg_color.expand(n_rays, 3).clone()
    image[sel] = sub["image"]
    out = {"image": image}
    for name, shape in (("depth", (n_rays,)), ("weights_sum", (n_rays,)),
                        ("ambient_aud", (n_rays, 1)), ("ambient_eye", (n_rays, 1)),
                        ("uncertainty", (n_rays, 1))):
        out[name] = torch.zeros(shape, dtype=sub[name].dtype, device=z.device)
        out[name][sel] = sub[name]
    return out


def render_rays(apply_fn: Callable, rays_o, rays_d, density: DensityGrid, bound: float,
                grid_size: int, bg_color, n_candidates: int = 64, n_steps: int = 16,
                min_near: float = 0.05, training: bool = False,
                max_active_rays: int = 0, probe_block: int = 0,
                image_hw: tuple | None = None) -> dict:
    """plan_rays + shade: the training path, where the hash encode is
    differentiable."""
    plan = plan_rays(rays_o, rays_d, density, bound, grid_size, n_candidates=n_candidates,
                     n_steps=n_steps, min_near=min_near, max_active_rays=max_active_rays,
                     probe_block=probe_block, image_hw=image_hw)
    return shade(apply_fn, plan, bg_color, training=training, n_rays=rays_o.shape[0])


def update_density_grid(density_fn: Callable, density: DensityGrid, bound: float,
                        grid_size: int, decay: float = 0.95, density_thresh: float = 10.0,
                        chunk: int = 65536) -> DensityGrid:
    """Decayed max-update over all cell centres, then the occupancy
    threshold min(mean density, density_thresh). density_fn(xyz [M,3]) →
    sigma [M]; cells marked −1 (untrained) stay −1."""
    idx = torch.arange(grid_size, device=density.grid.device)
    ijk = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), dim=-1).reshape(-1, 3)
    xyz = (ijk.to(torch.float32) + 0.5) / grid_size * 2 * bound - bound   # cell centres
    sigmas = torch.cat([density_fn(xyz[i: i + chunk]) for i in range(0, xyz.shape[0], chunk)])
    old = density.grid
    new = torch.where(old >= 0, torch.maximum(old * decay, sigmas), old)
    mean_density = torch.clamp(new, min=0).mean()
    thresh = torch.clamp(mean_density, max=density_thresh)
    return DensityGrid(grid=new, occupancy=new > thresh, mean_density=mean_density)


def render_torso_background(torso_fn: Callable, H: int, W: int, pose, bg_color):
    """The 2-D torso pass composited over the static background: evaluate
    torso_fn(x [N, 2], pose) → (alpha [N, 1], color [N, 3], dx) on the
    pixel-centre grid in [−1, 1]² (x along the width, raster order) and
    alpha-blend it onto bg_color ([3] or [H·W, 3]). Returns (the [H·W, 3]
    background the head composites over, alpha)."""
    f32 = dict(dtype=torch.float32, device=pose.device)
    ys = (torch.arange(H, **f32) + 0.5) / H * 2 - 1
    xs = (torch.arange(W, **f32) + 0.5) / W * 2 - 1
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1).reshape(-1, 2)
    alpha, color, _dx = torso_fn(grid, pose)
    return color * alpha + bg_color * (1 - alpha), alpha


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
