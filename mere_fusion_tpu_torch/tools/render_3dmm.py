"""Differentiable renderers and photometric 3DMM pose refinement.

Port of mere_fusion_tpu/tools/render_3dmm.py. The reference refines BFM
id/exp/pose by differentiable rendering: a pytorch3d mesh rasterizer with
per-vertex textures drives a photometric loss against the video frames
(reference data_utils/face_tracking/render_3dmm.py:1-25). Two renderers:

- **soft mesh rasterizer** (``render_mesh_soft`` / supersampled
  ``render_mesh_ss``): gradient-free top-K face selection
  (``rasterize_topk``, pytorch3d's faces_per_pixel), then differentiable
  shading of only the selected faces with a sigmoid boundary skirt and a
  softmax z-buffer (softmax_rgb_blend).
- **Gaussian point splat** (``render_splat``), the topology-free fallback.

``refine_photometric`` starts from the landmark fit
(tools/face_tracking.fit_landmarks). The mesh path solves per-frame
euler/trans/exp plus shared id/focal with blur-annealed
Levenberg–Marquardt; the splat path fits pose (+ albedo) with Adam.

The renderers take one frame's vertices [N, 3] or a batch [F, N, 3] (the
JAX twin vmaps over frames); every entry point runs where its tensors are.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mere_fusion_tpu_torch.device import resolve_device
from mere_fusion_tpu_torch.tools.face_tracking import (
    MorphableModel,
    euler_to_rot,
    model_tensors,
    project,
)

# the most (face, pixel) pairs that one pass of rasterize_topk tests; a
# batch of frames past it is rasterized a group of frames at a time
PAIR_BUDGET = 1 << 25


def _batched(points: torch.Tensor):
    """(points as [F, N, 3], whether the caller gave one frame)."""
    return (points[None], True) if points.ndim == 2 else (points, False)


def _pixels(hw: tuple, device) -> torch.Tensor:
    """[H·W, 2] pixel centres (x, y), row-major."""
    h, w = hw
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], -1).reshape(h * w, 2)


def render_splat(
    points_cam: torch.Tensor,   # [N, 3] or [F, N, 3] camera-space vertices (camera at -z)
    colors: torch.Tensor,       # [N, 3] per-vertex albedo in [0, 1]
    focal,
    center: tuple,
    hw: tuple,
    radius: int = 2,
    sigma: float = 1.0,
    depth_beta: float = 30.0,
):
    """Soft point-splat render → (rgb [H,W,3], coverage [H,W]) (a leading
    frame axis when the points have one).

    coverage is the accumulated splat weight; pixels with ~zero coverage
    hold the background (black) and are masked out of photometric losses
    via coverage/(coverage+eps)."""
    pts, single = _batched(points_cam)
    f = pts.shape[0]
    h, w = hw
    uv = project(pts, focal, center)                       # [F, N, 2]
    z = torch.clamp(-pts[..., 2], min=1e-4)
    zmin = z.min(-1, keepdim=True).values
    zmax = z.max(-1, keepdim=True).values
    zw = torch.exp(-depth_beta * ((z - zmin) / (zmax - zmin + 1e-6)))   # nearer ⇒ heavier

    acc_rgb = torch.zeros(f * h * w, 3, device=pts.device)
    acc_w = torch.zeros(f * h * w, device=pts.device)
    u, v = uv[..., 0], uv[..., 1]
    u0, v0 = torch.floor(u), torch.floor(v)
    base = (torch.arange(f, device=pts.device) * (h * w))[:, None]
    cols = colors.expand(f, *colors.shape[-2:])
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    for du in range(-radius, radius + 1):
        for dv in range(-radius, radius + 1):
            pu = u0 + du
            pv = v0 + dv
            d2 = (u - pu) ** 2 + (v - pv) ** 2
            wgt = torch.exp(-d2 * inv2s2) * zw
            inside = (pu >= 0) & (pu < w) & (pv >= 0) & (pv < h)
            wgt = torch.where(inside, wgt, torch.zeros_like(wgt))
            idx = (torch.clamp(pv, 0, h - 1) * w + torch.clamp(pu, 0, w - 1)).to(torch.int64)
            idx = (idx + base).reshape(-1)
            acc_rgb = acc_rgb.index_add(0, idx, (wgt[..., None] * cols).reshape(-1, 3))
            acc_w = acc_w.index_add(0, idx, wgt.reshape(-1))
    rgb = (acc_rgb / (acc_w[:, None] + 1e-6)).reshape(f, h, w, 3)
    cov = acc_w.reshape(f, h, w)
    return (rgb[0], cov[0]) if single else (rgb, cov)


def _tri_geometry(a, b, c, pix):
    """Edge values / signed boundary distance / barycentrics of pixel(s)
    ``pix`` against triangle(s) (a, b, c). Shapes broadcast: [..., 2] each.

    Returns (d, b0, b1, b2, live): d = signed pixel distance to the triangle
    boundary (positive inside, the min over edges of edge_value/edge_length);
    b* = clipped + renormalized barycentrics; live = non-degenerate mask."""

    def edge_fn(p0, p1, q):
        return ((q[..., 0] - p0[..., 0]) * (p1[..., 1] - p0[..., 1])
                - (q[..., 1] - p0[..., 1]) * (p1[..., 0] - p0[..., 0]))

    w0 = edge_fn(b, c, pix)
    w1 = edge_fn(c, a, pix)
    w2 = edge_fn(a, b, pix)
    area = edge_fn(b, c, a)                       # twice signed area
    s = torch.sign(area)
    s = torch.where(s == 0, torch.ones_like(s), s)
    area_abs = torch.abs(area)
    live = (area_abs > 1e-8).to(torch.float32)
    w0, w1, w2 = w0 * s, w1 * s, w2 * s           # now: positive inside
    area_safe = torch.clamp(area_abs, min=1e-8)

    def elen(p0, p1):
        return torch.sqrt(((p1 - p0) ** 2).sum(-1) + 1e-12)

    d = torch.minimum(
        torch.minimum(w0 / elen(b, c), w1 / elen(c, a)), w2 / elen(a, b))
    b0 = torch.clamp(w0 / area_safe, min=0.0)
    b1 = torch.clamp(w1 / area_safe, min=0.0)
    b2 = torch.clamp(w2 / area_safe, min=0.0)
    norm = b0 + b1 + b2 + 1e-8
    return d, b0 / norm, b1 / norm, b2 / norm, live


def _reach_boxes(uv: torch.Tensor, faces: torch.Tensor, hw: tuple, d_max: float):
    """Per frame and face, the pixel box [x0, x1) × [y0, y1) that holds
    every pixel whose signed boundary distance exceeds -d_max.

    That set is the triangle grown by d_max along each edge's normal: the
    triangle scaled about its incentre by 1 + d_max / r (r the inradius).
    It is computed in float64 with a pixel of margin, so the float32 test
    of ``_tri_geometry`` finds no candidate outside it; a face whose
    orientation float32 and float64 disagree on reaches the whole image, and
    one that float32 finds degenerate (never a candidate) reaches none."""
    h, w = hw
    p = uv.double()[:, faces]                         # [F, T, 3, 2]
    a, b, c = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    la = (b - c).norm(dim=-1)
    lb = (c - a).norm(dim=-1)
    lc = (a - b).norm(dim=-1)
    per = la + lb + lc
    area64 = ((a[..., 0] - b[..., 0]) * (c[..., 1] - b[..., 1])
              - (a[..., 1] - b[..., 1]) * (c[..., 0] - b[..., 0]))
    inc = (la[..., None] * a + lb[..., None] * b + lc[..., None] * c) / per[..., None]
    r = area64.abs() / per
    grow = 1.0 + (d_max + 1.0) / r
    ext = inc[..., None, :] + grow[..., None, None] * (p - inc[..., None, :])
    lo = torch.floor(ext.amin(-2)) - 1.0
    hi = torch.floor(ext.amax(-2)) + 2.0
    u32 = uv[:, faces]
    area32 = ((u32[..., 0, 0] - u32[..., 1, 0]) * (u32[..., 2, 1] - u32[..., 1, 1])
              - (u32[..., 0, 1] - u32[..., 1, 1]) * (u32[..., 2, 0] - u32[..., 1, 0]))
    live = area32.abs() > 1e-8
    whole = live & (~torch.isfinite(lo).all(-1) | ~torch.isfinite(hi).all(-1)
                    | (torch.sign(area32.double()) != torch.sign(area64)))
    lim = torch.tensor([w, h], dtype=torch.float64, device=uv.device)
    lo = torch.where(whole[..., None], torch.zeros_like(lo), lo.clamp(min=0))
    hi = torch.where(whole[..., None], lim.expand_as(hi), torch.minimum(hi, lim))
    lo = torch.where(live[..., None], lo, torch.zeros_like(lo))
    hi = torch.where(live[..., None], hi, torch.zeros_like(hi))
    return lo.long(), torch.maximum(hi, lo).long()


@torch.no_grad()
def rasterize_topk(
    uv: torch.Tensor,       # [N, 2] or [F, N, 2] projected vertices (pixels)
    z_norm: torch.Tensor,   # [N] or [F, N] normalized nearness (1 = nearest)
    faces: torch.Tensor,    # [T, 3]
    hw: tuple,
    d_max: float,
    k: int = 2,
) -> torch.Tensor:
    """Non-differentiable top-K rasterization → [P, K] face ids (-1 = none;
    [F, P, K] for a batch).

    The selection half of pytorch3d's MeshRasterizer with faces_per_pixel=K
    (reference data_utils/face_tracking/render_3dmm.py:134-139): per pixel,
    the K nearest faces whose soft boundary comes within ``d_max`` pixels.
    A candidate's rank is its barycentric nearness, +2 when the face covers
    the pixel (covering faces above skirt-only ones); equal ranks go to the
    lower face id. That is the order the JAX twin's scan over chunks of 256
    faces keeps with repeated first-index argmax, and a chunk with no
    candidate at a pixel leaves that pixel's top-K as it was; so this
    tests each face only against the pixels of its reach (``_reach_boxes``)
    and takes every pixel's first K candidates in a stable sort by rank,
    then by face id. The selection carries no gradient."""
    uvb = uv.detach()[None] if uv.ndim == 2 else uv.detach()
    znb = z_norm.detach()[None] if z_norm.ndim == 1 else z_norm.detach()
    faces = torch.as_tensor(faces, device=uvb.device).long()
    f, p = uvb.shape[0], hw[0] * hw[1]
    lo, hi = _reach_boxes(uvb, faces, hw, d_max)
    area = ((hi - lo)[..., 0] * (hi - lo)[..., 1]).reshape(-1)     # [F·T]
    out = torch.full((f * p, k), -1, dtype=torch.int32, device=uvb.device)
    t = faces.shape[0]
    # frames in groups whose pairs fit the budget
    per_frame = area.reshape(f, t).sum(-1).tolist()
    start = 0
    while start < f:
        stop, total = start + 1, per_frame[start]
        while stop < f and total + per_frame[stop] <= PAIR_BUDGET:
            total += per_frame[stop]
            stop += 1
        _topk_pairs(uvb, znb, faces, hw, d_max, k, lo, hi, area, start, stop, out)
        start = stop
    out = out.reshape(f, p, k)
    return out[0] if uv.ndim == 2 else out


def _topk_pairs(uv, z_norm, faces, hw, d_max, k, lo, hi, area, start, stop, out):
    """rasterize_topk over frames [start, stop), written into ``out``."""
    h, w = hw
    t = faces.shape[0]
    dev = uv.device
    sel = slice(start * t, stop * t)
    counts = area[sel]
    n = int(counts.sum())
    if n == 0:
        return
    ft = torch.repeat_interleave(torch.arange(start * t, stop * t, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    off = torch.arange(n, device=dev) - torch.repeat_interleave(first, counts)
    fr, face = ft // t, ft % t
    x0, y0 = lo.reshape(-1, 2)[ft].unbind(-1)
    bw = (hi - lo).reshape(-1, 2)[ft, 0]
    px = x0 + off % bw
    py = y0 + off // bw
    pix = torch.stack([px, py], -1).to(torch.float32)
    tri = faces[face]
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    a, b, c = uv[fr, v0], uv[fr, v1], uv[fr, v2]
    d, b0, b1, b2, live = _tri_geometry(a, b, c, pix)
    zp = b0 * z_norm[fr, v0] + b1 * z_norm[fr, v1] + b2 * z_norm[fr, v2]
    cand = (d > -d_max) & (live > 0)
    zc = (zp + 2.0 * (d >= 0))[cand]
    key = (fr * (h * w) + py * w + px)[cand]
    face = face[cand]
    if key.numel() == 0:
        return
    # pairs are in face order; a stable sort by rank keeps the lower face
    # first among equal ranks, a stable sort by pixel keeps the rank order
    order = torch.sort(zc, descending=True, stable=True).indices
    key, face = key[order], face[order]
    order = torch.sort(key, stable=True).indices
    key, face = key[order], face[order]
    _, cnt = torch.unique_consecutive(key, return_counts=True)
    rank = torch.arange(key.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(cnt, 0) - cnt, cnt)
    keep = rank < k
    out[key[keep], rank[keep]] = face[keep].to(torch.int32)


def render_mesh_soft(
    points_cam: torch.Tensor,   # [N, 3] or [F, N, 3] camera-space vertices (camera at -z)
    faces: torch.Tensor,        # [T, 3] int vertex indices
    colors: torch.Tensor,       # [N, 3] per-vertex albedo in [0, 1]
    focal,
    center: tuple,
    hw: tuple,
    sigma_px: float = 0.7,
    gamma: float = 0.03,
    faces_per_pixel: int = 2,
):
    """Differentiable soft triangle rasterization → (rgb [H,W,3], cov [H,W])
    (a leading frame axis when the points have one).

    The twin of the reference's pytorch3d soft renderer
    (data_utils/face_tracking/render_3dmm.py:96-160: MeshRasterizer with
    faces_per_pixel=2 + softmax_rgb_blend), in two passes:

    1. ``rasterize_topk`` picks the K nearest in-skirt faces per pixel,
       with no gradient (as in pytorch3d);
    2. each pixel shades only its K faces: contribution
       ``sigmoid(d/σ) · exp(z_norm/γ)`` with d the signed pixel distance to
       the boundary (positive inside) and z_norm ∈ [0,1] the normalized
       nearness, a softmax z-buffer. Background carries weight 1
       (pytorch3d's exp(eps/γ)); coverage = acc/(acc+1).
    """
    pts, single = _batched(points_cam)
    f = pts.shape[0]
    h, w = hw
    p = h * w
    uv = project(pts, focal, center)                        # [F, N, 2]
    z = torch.clamp(-pts[..., 2], min=1e-4)                 # positive depth
    zmin = z.min(-1, keepdim=True).values.detach()
    zmax = z.max(-1, keepdim=True).values.detach()
    z_norm = (zmax - z) / (zmax - zmin + 1e-6)              # 1 = nearest

    faces = torch.as_tensor(faces, device=pts.device).long()
    # skirt reach: beyond ~4σ the sigmoid tail is <2%, pytorch3d's
    # blur_radius plays the same cutoff role
    sel = rasterize_topk(uv, z_norm, faces, hw, d_max=4.0 * sigma_px,
                         k=faces_per_pixel).long()          # [F, P, K]

    pix = _pixels(hw, pts.device)
    inv_gamma = 1.0 / gamma
    inv_sigma = 1.0 / sigma_px
    fr = torch.arange(f, device=pts.device)[:, None]
    cols = colors.expand(f, *colors.shape[-2:])

    acc_c = torch.zeros(f, p, 3, device=pts.device)
    acc_w = torch.zeros(f, p, device=pts.device)
    for ki in range(faces_per_pixel):
        fi = sel[..., ki]                                    # [F, P]
        valid = (fi >= 0).to(torch.float32)
        tri = faces[torch.clamp(fi, min=0)]                  # [F, P, 3]
        v0, v1, v2 = tri[..., 0], tri[..., 1], tri[..., 2]
        a, b, c = uv[fr, v0], uv[fr, v1], uv[fr, v2]         # [F, P, 2]
        d, b0, b1, b2, live = _tri_geometry(a, b, c, pix)
        prob = torch.sigmoid(d * inv_sigma) * live * valid
        zp = b0 * z_norm[fr, v0] + b1 * z_norm[fr, v1] + b2 * z_norm[fr, v2]
        wgt = prob * torch.exp(zp * inv_gamma)
        col = (b0[..., None] * cols[fr, v0] + b1[..., None] * cols[fr, v1]
               + b2[..., None] * cols[fr, v2])
        acc_c = acc_c + wgt[..., None] * col
        acc_w = acc_w + wgt
    rgb = (acc_c / (acc_w[..., None] + 1.0)).reshape(f, h, w, 3)   # background weight 1
    cov = (acc_w / (acc_w + 1.0)).reshape(f, h, w)
    return (rgb[0], cov[0]) if single else (rgb, cov)


def render_mesh_ss(
    points_cam: torch.Tensor,
    faces: torch.Tensor,
    colors: torch.Tensor,
    focal,
    center: tuple,
    hw: tuple,
    ss: int = 2,
    sigma_px: float = 0.3,
):
    """Supersampled soft mesh render → (rgb [H,W,3], cov [H,W]).

    Rasterizes at ``ss``× resolution and box-downsamples: area
    anti-aliasing, the renderer's analogue of a photograph and the profile
    a photometric fit should match (the JAX twin measured pose recovery
    stalling at ~2.4° without it, <1° with it)."""
    h, w = hw
    rgb, cov = render_mesh_soft(
        points_cam, faces, colors, focal * ss,
        (center[0] * ss, center[1] * ss), (h * ss, w * ss), sigma_px=sigma_px)
    lead = rgb.shape[:-3]
    return (rgb.reshape(*lead, h, ss, w, ss, 3).mean((-4, -2)),
            cov.reshape(*lead, h, ss, w, ss).mean((-3, -1)))


def blur_hw(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur over the H, W axes of [F, H, W, C] (edge
    padding). Linear, so gradients pass straight through: blurring both the
    render and the target by the same kernel band-limits the photometric
    loss symmetrically, the coarse-to-fine device of the fit."""
    if sigma <= 0:
        return img
    rad = max(1, int(3 * sigma + 0.5))
    x = torch.arange(-rad, rad + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()

    def conv_axis(a, axis):
        n = a.shape[axis]
        idx = torch.clamp(torch.arange(-rad, n + rad, device=a.device), 0, n - 1)
        ap = a.index_select(axis, idx)
        out = k[0] * ap.narrow(axis, 0, n)
        for j in range(1, 2 * rad + 1):
            out = out + k[j] * ap.narrow(axis, j, n)
        return out

    return conv_axis(conv_axis(img, 1), 2)


def geometry_world(model: MorphableModel, id_coef, exp, euler, trans, basis=None):
    """BFM vertices under per-frame pose: [F, N, 3] camera-space points.
    ``basis`` is ``model_tensors(model, device)`` when the caller has it."""
    mean, b_id, b_exp = basis if basis is not None else model_tensors(model, euler.device)
    pts = (mean[None]
           + torch.einsum("nvk,k->nv", b_id, id_coef)[None]
           + torch.einsum("nvk,fk->fnv", b_exp, exp))
    rot = euler_to_rot(euler)
    return torch.einsum("fij,fnj->fni", rot, pts) + trans[:, None]


# columns of a Jacobian that one jacfwd call computes at most: the tangents
# of a block are [columns, residuals] arrays at every step of the render
JAC_ELEMENTS = 1 << 27


def _jacobian(resid_fn, v: torch.Tensor, args: tuple, rows: int) -> torch.Tensor:
    """d resid / d v by torch.func.jacfwd, in blocks of columns so that a
    block's tangents hold at most JAC_ELEMENTS of each intermediate."""
    from torch.func import jacfwd

    block = max(1, JAC_ELEMENTS // max(rows, 1))
    if block >= v.numel():
        return jacfwd(resid_fn)(v, *args)
    cols = []
    for a in range(0, v.numel(), block):
        b = min(v.numel(), a + block)
        head, tail = v[:a], v[b:]
        cols.append(jacfwd(lambda vb: resid_fn(torch.cat([head, vb, tail]), *args))(v[a:b]))
    return torch.cat(cols, 1)


def _lm_minimize(resid_fn, v0, iters, lam0=1e-2, retries=8, args=()):
    """Levenberg–Marquardt on a small dense parameter vector.

    The photometric pose endgame is a small smooth nonlinear least-squares
    problem (tens of parameters a frame, tens of thousands of residuals):
    Adam crawls on it, while LM solves it in ~10 Jacobian evaluations.
    Jacobian by forward mode (one tangent per parameter); Marquardt scaling
    (damping ∝ diag(JᵀJ)) keeps the step sane across the differently scaled
    pose/shape/focal axes. ``args`` are passed through to
    resid_fn(v, *args). The normal equations are solved in float32."""
    v = v0
    with torch.no_grad():
        r = resid_fn(v, *args)
    cost = float(r @ r)
    lam = lam0
    for _ in range(iters):
        jmat = _jacobian(resid_fn, v, args, r.numel())
        jtj = jmat.T @ jmat
        g = jmat.T @ r
        dj = torch.diag(torch.diag(jtj) + 1e-8)
        del jmat
        for _ in range(retries):
            delta = torch.linalg.solve(jtj + lam * dj, -g)
            v_new = v + delta
            with torch.no_grad():
                r_new = resid_fn(v_new, *args)
            c_new = float(r_new @ r_new)
            if c_new < cost:
                v, r, cost = v_new, r_new, c_new
                lam = max(lam / 3.0, 1e-7)
                break
            lam *= 4.0
        else:
            break                      # no productive step at any damping
    return v, cost


def _adam(params: dict, lrs: dict):
    """optax.adam per group (lr 0 groups left out: optax's update for them
    is zero)."""
    groups = [{"params": [params[k]], "lr": lr} for k, lr in lrs.items() if lr != 0.0]
    return torch.optim.Adam(groups, foreach=False, fused=False)


def refine_photometric(
    model: MorphableModel,
    fit: dict,                  # fit_landmarks output (numpy trees)
    frames: np.ndarray,         # [F, H, W, 3] float targets in [0, 1]
    iters: int = 400,
    lr: float = 2e-3,
    colors: Optional[np.ndarray] = None,   # [N, 3] fixed albedo; else learned
    radius: int = 2,
    sigma: float = 1.0,
    vertex_stride: int = 1,     # subsample vertices for speed at high N
    refine_pose: bool = True,
    faces: Optional[np.ndarray] = None,    # [T, 3] -> soft mesh rasterizer
    landmarks: Optional[np.ndarray] = None,       # [F, L, 2] px anchors
    lmk_vertex_idx: Optional[np.ndarray] = None,  # [L] vertex ids
    reg_id: float = 1.0,
    reg_exp: float = 5.0,
    background: Optional[np.ndarray] = None,      # [H, W, 3] plate
    ss: int = 2,
    lm_schedule: tuple = ((1.0, 0.3, 6), (0.25, 0.1, 6), (0.0, 0.02, 10)),
    lm_frame_budget: int = 200_000_000,  # max Jacobian elements per LM solve
    device=None,
) -> dict:
    """Photometric pose refinement (the reference's differentiable-render
    stage, render_3dmm.py:1-25) on top of a landmark fit.

    With ``faces`` (or a model that carries topology) the refinement runs
    the mesh path: supersampled z-buffered soft rasterization
    (``render_mesh_ss``), a two-sided full-image photometric loss, and
    Levenberg–Marquardt over per-frame pose + per-frame exp + shared id +
    shared focal with the reference's coefficient regularization. Without
    topology it falls back to the Gaussian point splat + Adam stage.
    refine_pose=False fits only the albedo (texture-solve mode).

    The design notes of the JAX twin hold here: the loss is two-sided
    (masking by rendered coverage lets the fit drift back along depth);
    id/exp/focal are free but regularized; each (beta, lan_w, iters) stage
    of ``lm_schedule`` blurs render and target by beta and weighs the
    landmark anchor by lan_w (squared pixels, the reference's units,
    face_tracker.py:351-353); past ``lm_frame_budget`` Jacobian elements
    the solve decomposes: an evenly spaced anchor subset solves the shared
    id/focal (+ albedo) jointly, then the other frames solve their pose/exp
    in fixed-size chunks against the frozen shared state."""
    dev = resolve_device(device)
    f, h, w = frames.shape[:3]
    center = (w / 2.0, h / 2.0)
    f32 = dict(dtype=torch.float32, device=dev)
    target = torch.as_tensor(np.asarray(frames), **f32)
    focal = torch.as_tensor(fit["focal"], **f32)
    id_coef = torch.as_tensor(np.asarray(fit["id"]), **f32)
    exp = torch.as_tensor(np.asarray(fit["exp"]), **f32)

    if faces is None:
        faces = getattr(model, "faces", None)
    if faces is not None and vertex_stride != 1:
        raise ValueError("vertex_stride applies to the splat fallback only; "
                         "mesh topology indexes the full vertex set")
    mesh_faces = None if faces is None else torch.as_tensor(np.asarray(faces), device=dev).long()

    if (landmarks is None) != (lmk_vertex_idx is None):
        raise ValueError("landmarks and lmk_vertex_idx go together")
    if landmarks is not None and vertex_stride != 1:
        raise ValueError("landmark anchoring indexes the full vertex set; "
                         "use vertex_stride=1")
    lmk_px = None if landmarks is None else torch.as_tensor(np.asarray(landmarks), **f32)
    lmk_idx = None if landmarks is None else torch.as_tensor(np.asarray(lmk_vertex_idx),
                                                            device=dev).long()

    sub = slice(None, None, vertex_stride)
    submodel = MorphableModel(
        mean=model.mean[sub],
        base_id=model.base_id.reshape(-1, 3, model.base_id.shape[-1])[sub]
                     .reshape(-1, model.base_id.shape[-1]),
        base_exp=model.base_exp.reshape(-1, 3, model.base_exp.shape[-1])[sub]
                      .reshape(-1, model.base_exp.shape[-1]),
    )
    basis = model_tensors(submodel, dev)
    n_sub = submodel.mean.shape[0]

    learn_colors = colors is None
    if not refine_pose and not learn_colors:
        raise ValueError("refine_pose=False requires learnable colors "
                         "(texture-solve mode)")
    bg = None if background is None else torch.as_tensor(np.asarray(background), **f32)

    def geometry(id_c, exp_c, euler, trans):
        return geometry_world(submodel, id_c, exp_c, euler, trans, basis=basis)

    # ------------------------- mesh path: LM -------------------------
    if refine_pose and mesh_faces is not None:
        ke = exp.shape[-1]
        ki = id_coef.shape[-1]

        def render_frames(pts, cols, fo):
            rgb, cov = render_mesh_ss(pts, mesh_faces, cols, fo, center, (h, w), ss=ss)
            if bg is not None:
                rgb = rgb + bg * (1.0 - cov[..., None])
            return rgb

        # the joint Jacobian is [n·h·w·3, n(6+ke)+ki+1]: cap the jointly
        # solved frame count by an element budget and decompose beyond it
        rows_pf = h * w * 3

        def cap_frames(extra_params: int) -> int:
            c = 1
            while (c < f and (c + 1) * rows_pf
                   * ((c + 1) * (6 + ke) + extra_params) <= lm_frame_budget):
                c += 1
            return c

        def joint_solve(idx: np.ndarray, cols):
            """Joint LM over frames ``idx``: per-frame pose/exp + shared
            id/focal (+ albedo cycles when learned). Returns (pose, cols)."""
            nf = len(idx)
            tidx = torch.as_tensor(idx, device=dev)
            tgt = target[tidx]
            lmk_i = None if lmk_px is None else lmk_px[tidx]

            def pack(p):
                # trans in hundreds of model units: a common scale for the
                # axes, so that Marquardt damping treats them evenly
                return torch.cat([
                    p["euler"].reshape(-1), p["trans"].reshape(-1) / 100.0,
                    p["exp"].reshape(-1), p["id"].reshape(-1), p["log_focal"][None]])

            def unpack(v):
                i = 0
                euler = v[i:i + 3 * nf].reshape(nf, 3); i += 3 * nf
                trans = v[i:i + 3 * nf].reshape(nf, 3) * 100.0; i += 3 * nf
                expc = v[i:i + ke * nf].reshape(nf, ke); i += ke * nf
                idc = v[i:i + ki]; i += ki
                return {"euler": euler, "trans": trans, "exp": expc,
                        "id": idc, "log_focal": v[i]}

            npx = float(nf * h * w * 3)

            def make_resid(beta, lan_w, cols):
                target_s = blur_hw(tgt, beta)

                def resid(v):
                    p = unpack(v)
                    fo = torch.exp(p["log_focal"])
                    pts = geometry(p["id"], p["exp"], p["euler"], p["trans"])
                    rgb = blur_hw(render_frames(pts, cols, fo), beta)
                    parts = [((rgb - target_s) * np.sqrt(0.5 * 255.0 / npx)).reshape(-1)]
                    if lmk_i is not None:
                        proj = project(pts[:, lmk_idx], fo, center)
                        parts.append(((proj - lmk_i)
                                      * np.sqrt(lan_w / lmk_i.numel())).reshape(-1))
                    parts.append(np.sqrt(reg_id) * p["id"])
                    parts.append(np.sqrt(reg_exp / nf) * p["exp"].reshape(-1))
                    return torch.cat(parts)

                return resid

            def solve_colors(pose, cols, steps):
                # albedo at the frozen pose: plain Adam, the color
                # subproblem being smooth and near-linear
                with torch.no_grad():
                    pts = geometry(pose["id"], pose["exp"], pose["euler"], pose["trans"])
                    fo = torch.exp(pose["log_focal"])
                cols = cols.clone().requires_grad_(True)
                opt = _adam({"c": cols}, {"c": lr * 15.0})
                for _ in range(steps):
                    opt.zero_grad(set_to_none=True)
                    rgb = render_frames(pts, torch.clamp(cols, 0.0, 1.0), fo)
                    ((rgb - tgt) ** 2).sum(-1).mean().backward()
                    opt.step()
                return torch.clamp(cols.detach(), 0.0, 1.0)

            pose = {
                "euler": torch.as_tensor(np.asarray(fit["euler"]), **f32)[tidx],
                "trans": torch.as_tensor(np.asarray(fit["trans"]), **f32)[tidx],
                "exp": exp[tidx],
                "id": id_coef,
                "log_focal": torch.log(focal),
            }
            cycles = 2 if learn_colors else 1
            for _ in range(cycles):
                if learn_colors:
                    cols = solve_colors(pose, cols, max(1, iters // (2 * cycles)))
                v = pack(pose)
                for beta, lan_w, nit in lm_schedule:
                    v, _ = _lm_minimize(make_resid(beta, lan_w, cols), v, nit)
                pose = unpack(v)
            return pose, cols

        cols = (torch.full((n_sub, 3), 0.5, **f32) if learn_colors
                else torch.clamp(torch.as_tensor(np.asarray(colors)[sub], **f32), 0, 1))
        c_joint = cap_frames(ki + 1)

        if f <= c_joint:
            pose, cols = joint_solve(np.arange(f), cols)
            euler_all = pose["euler"].cpu().numpy()
            trans_all = pose["trans"].cpu().numpy()
            exp_all = pose["exp"].cpu().numpy()
            id_final, logf_final = pose["id"], pose["log_focal"]
        else:
            # anchor: evenly spaced representative frames solve the shared
            # id/focal (+ albedo); the rest solve pose/exp in chunks
            anchor = np.unique(np.linspace(0, f - 1, c_joint).round().astype(int))
            pose_a, cols = joint_solve(anchor, cols)
            id_final, logf_final = pose_a["id"], pose_a["log_focal"]
            idfo = torch.cat([id_final, logf_final[None]])

            euler_all = np.asarray(fit["euler"], np.float32).copy()
            trans_all = np.asarray(fit["trans"], np.float32).copy()
            exp_all = exp.cpu().numpy().copy()
            euler_all[anchor] = pose_a["euler"].cpu().numpy()
            trans_all[anchor] = pose_a["trans"].cpu().numpy()
            exp_all[anchor] = pose_a["exp"].cpu().numpy()

            csize = cap_frames(0)

            def unpack_c(v):
                return (v[:3 * csize].reshape(csize, 3),
                        v[3 * csize:6 * csize].reshape(csize, 3) * 100.0,
                        v[6 * csize:].reshape(csize, ke))

            def make_chunk_resid(beta, lan_w):
                """One residual per blur stage; a chunk's targets and
                landmarks ride as arguments."""
                cnpx = float(csize * h * w * 3)

                def resid(v, tgt_s, lmk_c, idfo):
                    e, t, x = unpack_c(v)
                    fo = torch.exp(idfo[ki])
                    pts = geometry(idfo[:ki], x, e, t)
                    rgb = blur_hw(render_frames(pts, cols, fo), beta)
                    parts = [((rgb - tgt_s) * np.sqrt(0.5 * 255.0 / cnpx)).reshape(-1)]
                    if lmk_px is not None:
                        proj = project(pts[:, lmk_idx], fo, center)
                        parts.append(((proj - lmk_c)
                                      * np.sqrt(lan_w / lmk_c.numel())).reshape(-1))
                    parts.append(np.sqrt(reg_exp / csize) * x.reshape(-1))
                    return torch.cat(parts)

                return resid

            stages = [(s, make_chunk_resid(s[0], s[1])) for s in lm_schedule]
            rest = np.setdiff1d(np.arange(f), anchor)
            for c0 in range(0, len(rest), csize):
                chunk = rest[c0:c0 + csize]
                real = len(chunk)
                if real < csize:        # pad by repeating; results discarded
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], csize - real)])
                tch = torch.as_tensor(chunk, device=dev)
                v = torch.cat([
                    torch.as_tensor(euler_all[chunk], **f32).reshape(-1),
                    torch.as_tensor(trans_all[chunk], **f32).reshape(-1) / 100.0,
                    torch.as_tensor(exp_all[chunk], **f32).reshape(-1)])
                lmk_c = (torch.zeros(csize, 1, 2, **f32) if lmk_px is None else lmk_px[tch])
                for (beta, _lan_w, nit), resid in stages:
                    tgt_s = blur_hw(target[tch], beta)
                    v, _ = _lm_minimize(resid, v, nit, args=(tgt_s, lmk_c, idfo))
                e, t, x = unpack_c(v)
                euler_all[chunk[:real]] = e.cpu().numpy()[:real]
                trans_all[chunk[:real]] = t.cpu().numpy()[:real]
                exp_all[chunk[:real]] = x.cpu().numpy()[:real]

        # the final photometric error, accumulated over render chunks so that
        # large captures never hold an [F, H, W, 3] render at once
        fo_final = torch.exp(logf_final)
        sse, cnt = 0.0, 0
        with torch.no_grad():
            for c0 in range(0, f, max(1, c_joint)):
                sl = slice(c0, min(f, c0 + max(1, c_joint)))
                pts = geometry(id_final, torch.as_tensor(exp_all[sl], **f32),
                               torch.as_tensor(euler_all[sl], **f32),
                               torch.as_tensor(trans_all[sl], **f32))
                rgb = render_frames(pts, cols, fo_final)
                sse += float(((rgb - target[sl]) ** 2).sum(-1).sum())
                cnt += (sl.stop - sl.start) * h * w
        mse = sse / max(cnt, 1)

        out = dict(fit)
        out["euler"] = euler_all
        out["trans"] = trans_all
        out["exp"] = exp_all
        out["id"] = id_final.detach().cpu().numpy()
        out["focal"] = float(np.exp(logf_final.detach().cpu().numpy()))
        out["photo_rmse"] = float(np.sqrt(mse))
        if learn_colors:
            out["colors"] = cols.cpu().numpy()
        return out

    # --------------- splat fallback / texture-solve: Adam ---------------
    params = {
        "euler": torch.as_tensor(np.asarray(fit["euler"]), **f32).clone().requires_grad_(True),
        "trans": torch.as_tensor(np.asarray(fit["trans"]), **f32).clone().requires_grad_(True),
    }
    if learn_colors:
        params["colors"] = torch.full((n_sub, 3), 0.5, **f32).requires_grad_(True)
    fixed_colors = None if learn_colors else torch.as_tensor(np.asarray(colors)[sub], **f32)

    # parameter groups live on very different scales (radians, hundreds of
    # model units, [0,1] albedo): per-group learning rates, like the
    # reference's separate optimizer groups in its photometric stage
    lr_scale = {"euler": 1.0, "trans": 50.0, "colors": 15.0}

    def loss_fn(p, lan_w):
        cols = p["colors"] if learn_colors else fixed_colors
        cols = torch.clamp(cols, 0.0, 1.0)
        pts = geometry(id_coef, exp, p["euler"], p["trans"])

        if mesh_faces is not None:     # texture-solve over the mesh render
            rgb, cov = render_mesh_ss(pts, mesh_faces, cols, focal, center, (h, w), ss=ss)
            if bg is not None:
                rgb = rgb + bg * (1.0 - cov[..., None])
            col = ((rgb - target) ** 2).sum(-1).mean()
        else:
            rgb, cov = render_splat(pts, cols, focal, center, (h, w),
                                    radius=radius, sigma=sigma)
            mask = cov / (cov + 0.5)        # soft coverage mask
            err = ((rgb - target) ** 2).sum(-1) * mask
            col = err.sum() / (mask.sum() + 1e-6)
        loss = col
        if lmk_px is not None:
            # the reference's units: cal_lan_loss = mean squared pixel
            # residual, cal_col_loss ≈ 255 × this unit-scale masked MSE
            # (util.py:99-109; pose-stage weights face_tracker.py:351-353)
            proj = project(pts[:, lmk_idx], focal, center)
            lan = torch.mean((proj - lmk_px) ** 2)
            loss = 0.5 * 255.0 * col + lan_w * lan
        return loss, col

    def run(opt, steps, lan_w_of):
        mse = torch.tensor(float("inf"))
        for i in range(steps):
            opt.zero_grad(set_to_none=True)
            loss, mse = loss_fn(params, lan_w_of(i))
            loss.backward()
            opt.step()
            mse = mse.detach()
        return mse

    mse = torch.tensor(float("inf"))
    scales = {k: lr * s for k, s in lr_scale.items() if k in params}
    if learn_colors:
        # phase 1: the albedo with the pose frozen (a half-fit albedo
        # steering the pose corrupts it; the reference likewise solves
        # texture/light before its pose rounds)
        mse = run(_adam(params, {**scales, "euler": 0.0, "trans": 0.0}),
                  max(1, iters if not refine_pose else iters // 3), lambda i: 0.0)
    if refine_pose:
        # the reference's pose-stage schedule: lan ×8 for the first 50
        # iterations, ×1.5 after (face_tracker.py:351-353)
        mse = run(_adam(params, scales), iters, lambda i: 8.0 if i < 50 else 1.5)

    out = dict(fit)
    out["euler"] = params["euler"].detach().cpu().numpy()
    out["trans"] = params["trans"].detach().cpu().numpy()
    out["photo_rmse"] = float(np.sqrt(mse.cpu().numpy()))
    if learn_colors:
        out["colors"] = torch.clamp(params["colors"].detach(), 0.0, 1.0).cpu().numpy()
    return out


def pose_errors(euler_a, trans_a, euler_b, trans_b) -> tuple:
    """(mean rotation error in degrees, mean translation error) between two
    per-frame pose sets, the metric of synthetic pose recovery."""
    ra = euler_to_rot(torch.as_tensor(np.asarray(euler_a), dtype=torch.float32)).numpy()
    rb = euler_to_rot(torch.as_tensor(np.asarray(euler_b), dtype=torch.float32)).numpy()
    rel = np.einsum("fij,fkj->fik", ra, rb)   # Ra · Rbᵀ
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1.0, 1.0)
    rot_deg = np.degrees(np.arccos(cos)).mean()
    trans_err = np.linalg.norm(np.asarray(trans_a) - np.asarray(trans_b), axis=-1).mean()
    return float(rot_deg), float(trans_err)
