"""ER-NeRF frame step on kernel K2.

Port of mere_fusion_tpu/engines/nerf_pallas.py (``make_pallas_render_step``).
One frame: camera rays from the pose → per-ray sample spans from a
pose-keyed cache → active-tile compaction → span planning
(``ops.sampler.plan_jobs_span``) → K2 (texture sample + NeRF head +
composite, ``ops.sampler.sample_shade_comp_tiles``) → background mix →
untile → uint8 RGB.

- **Pose-keyed span cache.** Per-ray spans come from an occupancy probe of
  the density grid, which is static at inference, and the test-time pose
  track is a fixed loop: spans are probed once per pose and cached on the
  device as f16 span ends + ray validity, with the active-tile count on the
  host. The cache is dropped whenever a different occupancy tensor is
  passed (the only grid field spans depend on), is capped at
  ``nerf.span_cache_poses`` poses (over-cap poses and ``pose_key=None``
  render at full coverage with no host sync), and ``step.warmup`` prefills
  it with one batched count readback.
- **Exact tile compaction.** The JAX step compiles a ladder of tile budgets
  (``ladder_rungs``) because jit needs static shapes, and pads each frame
  up to the next rung. Eager PyTorch compacts to exactly the cached active
  tiles instead: the image is the same, since an inactive tile is pure
  background either way. A later CUDA-graph step would bring fixed rungs
  back. A frame with no active tile is the background and launches no K2.
- **Audio code EMA** (``nerf.smooth_lips``) runs in the step, as in JAX.

``impl="plain"`` renders through K2's plain version on any device (the
yardstick the kernel is held against); ``"auto"`` lets the wrapper decide by
device: the kernel on CUDA, the plain version on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetwork
from mere_fusion_tpu_torch.models.ernerf.renderer import (
    DensityGrid,
    get_rays,
    intersect_aabb,
    select_occupied_depths,
)
from mere_fusion_tpu_torch.ops import sampler
from mere_fusion_tpu_torch.ops.encoders import sh_encode
from mere_fusion_tpu_torch.ops.sampler import (
    SamplerSpec,
    from_tiles,
    pack_planes_major,
    plan_jobs_span,
    to_tiles,
)

# audio-code EMA coefficient (reference renderer.py:190-194, lambda = 0.35)
ENC_A_EMA = 0.35


def smooth_enc_a_fn(prev, enc_a):
    """One EMA step of the audio code."""
    return ENC_A_EMA * prev + (1.0 - ENC_A_EMA) * enc_a


def _expand_enc_rows(w: torch.Tensor, spec: SamplerSpec, dtype) -> torch.Tensor:
    """Lift a [3·C, n] weight block onto K2's padded plane-minor feature
    basis [3·CP, n]: row p·C + c moves to p·CP + c, pad rows are zero."""
    c, cp = spec.channels, spec.cp
    idx = torch.cat([torch.arange(c) + p * cp for p in range(3)]).to(w.device)
    out = torch.zeros(3 * cp, w.shape[-1], dtype=dtype, device=w.device)
    out[idx] = w.to(dtype)
    return out


@torch.no_grad()
def shade_weights(net: NeRFNetwork, spec: SamplerSpec, enc_a, ind, eye, dtype) -> dict:
    """The NeRF head's weights in K2's operand layout (ops.sampler.
    SHADE_WEIGHTS), with the frame's conditions folded in: enc_a into
    w_aud_sig, the eye scalar into w_sig_e, the individual code into
    col_bias."""
    c3 = 3 * spec.channels
    kern = lambda mlp, i: mlp.layer(i).weight.T           # [in, out]
    sw0 = kern(net.sigma_net, 0)
    adim = enc_a.shape[-1]
    hid = sw0.shape[1]
    dev = sw0.device
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    w = {
        "wx_aud": _expand_enc_rows(kern(net.aud_ch_att_net, 0), spec, dtype),
        "w_aud1": kern(net.aud_ch_att_net, 1).to(dtype),
        "wx_sig": _expand_enc_rows(sw0[:c3], spec, dtype),
        "w_aud_sig": (enc_a[0][:, None] * sw0[c3:c3 + adim]).to(dtype),
        "wx_eye": _expand_enc_rows(kern(net.eye_att_net, 0), spec, dtype),
        "w_eye1": zeros(16, 8),
        "w_sig1": kern(net.sigma_net, 1).to(dtype),
        "w_sig_e": zeros(8, hid),
        "w_sigcol": zeros(hid, 16),
        "w_rgb": zeros(64, 16),
        "col_bias": zeros(8, net.color_net.layer(0).weight.shape[0]),
    }
    w["w_eye1"][:, :1] = kern(net.eye_att_net, 1).to(dtype)
    if eye is not None and sw0.shape[0] > c3 + adim:
        w["w_sig_e"][0] = (eye[0, 0] * sw0[c3 + adim]).to(dtype)
    s2 = kern(net.sigma_net, 2)                            # [hid, 1 + geo]
    w["w_sigcol"][:, 0] = s2[:, 0].to(dtype)
    w["w_geo"] = s2[:, 1:65].to(dtype)
    cw0 = kern(net.color_net, 0)                           # [16 + 64 (+ ind), hid]
    w["w_col_g"] = cw0[16:80].to(dtype)
    w["w_rgb"][:, 1:4] = kern(net.color_net, 1).to(dtype)
    if ind is not None and cw0.shape[0] > 80:
        w["col_bias"][0] = (ind.to(cw0.dtype) @ cw0[80:])[0].to(dtype)
    return {name: w[name].contiguous() for name in sampler.SHADE_WEIGHTS}


def make_render_step(network: NeRFNetwork, dataset, cfg: Config, baked: dict,
                     impl: str = "auto"):
    """step(pose, auds, eye, density, bg, pose_key=None) →
    (RGB uint8 [H, W, 3], n_active, n_overflow), all on the network's
    device. pose_key: hashable id of the pose (the dataset frame index) for
    the span cache; None renders uncached at full coverage."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"render impl {impl!r} is not 'auto' or 'plain'")
    dev = network.plane_xy.device
    H, W = dataset.H, dataset.W
    intrinsics = dataset.intrinsics
    nc = cfg.nerf
    k = nc.max_steps
    first = next(iter(baked.values()))
    res = int(round(first.shape[0] ** 0.5)) if first.ndim == 2 else first.shape[0]
    channels = network.cfg.num_levels * network.cfg.plane_spec.level_dim
    tw = nc.pallas_tile_w if W % nc.pallas_tile_w == 0 else 8
    th = nc.pallas_tile_h if H % nc.pallas_tile_h == 0 else 8
    spec = SamplerSpec(resolution=res, channels=channels, tile_w=tw, tile_h=th, k=k,
                       kg=nc.pallas_depth_groups, wu=nc.pallas_window_u,
                       wv=nc.pallas_window_v)
    rpt = spec.rays_per_tile
    n = H * W
    t = n // rpt
    bound = nc.bound
    tile = lambda x: to_tiles(x, H, W, spec.tile_w, spec.tile_h)
    untile = lambda x: from_tiles(x, H, W, spec.tile_w, spec.tile_h)
    planes_major = pack_planes_major(baked, spec)
    shade_dtype = torch.bfloat16 if nc.shade_dtype == "bfloat16" else torch.float32
    k2 = (sampler.sample_shade_comp_tiles_plain if impl == "plain"
          else sampler.sample_shade_comp_tiles)

    def as_dev(a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def span_fn(pose, density: DensityGrid):
        """Everything that depends only on (pose, density): tiled f16 span
        ends, tiled ray validity and the active-tile count."""
        rays_o, rays_d = get_rays(pose, intrinsics, H, W)
        near, far, ray_valid = intersect_aabb(rays_o, rays_d, bound)
        z, _, valid = select_occupied_depths(rays_o, rays_d, near, far, density, bound,
                                             nc.grid_size, nc.n_candidates, 2)
        va = tile(valid.any(-1) & ray_valid)
        sp = tile(torch.stack([z[:, 0], z[:, -1]], -1).to(torch.float16))
        return sp, va, va.any(dim=1).sum()

    smooth_enabled = bool(nc.smooth_lips)
    smooth_state: dict = {"enc_a": None}

    def frame(pose, sp, va, b, auds, eye, bg):
        rays_o, rays_d = get_rays(pose, intrinsics, H, W)
        o_t, d_t = tile(rays_o), tile(rays_d)
        enc_a = network.encode_audio(auds)
        if smooth_enabled and smooth_state["enc_a"] is not None:
            enc_a = smooth_enc_a_fn(smooth_state["enc_a"], enc_a)
        ind = network.individual_code(0) if network.cfg.individual_dim > 0 else None
        sp = sp.float()
        active = va.any(dim=1)
        n_active = active.sum()
        bg_t = tile(bg.expand(n, 3).float())
        full = b == t
        if b == 0:
            return (untile(bg_t), enc_a, n_active,
                    torch.zeros((), dtype=torch.int64, device=dev))
        if full:
            sel = None
            va_s, sp_s, act_s, o_s, d_s = va, sp, active, o_t, d_t
        else:
            # the active tiles in raster order; b is their cached count
            sel = torch.argsort((~active).to(torch.uint8), stable=True)[:b]
            va_s, sp_s, act_s = va[sel], sp[sel], active[sel]
            o_s, d_s = o_t[sel], d_t[sel]
        zmin = sp_s[..., 0]
        span = (sp_s[..., 1] - sp_s[..., 0]) * va_s.float()
        zmax = zmin + span
        scalars, uv, overflow = plan_jobs_span(o_s, d_s, zmin, zmax, va_s, spec, bound)
        n_overflow = (overflow & act_s[:, None]).sum()
        sh_ray = sh_encode(d_s.reshape(-1, 3), 4).reshape(b, rpt, 16)
        cw0 = network.color_net.layer(0).weight.T[:16]
        # bf16 × bf16 with f32 accumulation, rounded to the shade dtype
        dproj = torch.matmul(sh_ray.to(shade_dtype).float(),
                             cw0.to(shade_dtype).float()).to(shade_dtype)
        dtv = torch.nn.functional.pad((span / k)[..., None], (0, 7))
        weights = shade_weights(network, spec, enc_a, ind, eye, shade_dtype)
        sr = k2(planes_major, scalars.reshape(-1).contiguous(),
                uv.reshape(b * 3, spec.kg, 2, spec.sg), dproj.contiguous(),
                dtv.contiguous(), weights, spec)
        bg_s = bg_t if full else bg_t[sel]
        image = sr[..., 1:4] + (1.0 - sr[..., 0])[..., None] * bg_s
        if full:
            img_t = image
        else:
            img_t = bg_t.clone()
            img_t[sel] = image
        return untile(img_t), enc_a, n_active, n_overflow

    span_cache: dict = {}
    cache_state: dict = {"occ": None}
    cache_cap = nc.span_cache_poses if nc.span_cache_poses > 0 else None

    @torch.no_grad()
    def step(pose, auds, eye, density: DensityGrid, bg, pose_key=None):
        pose = as_dev(pose)
        if density.occupancy is not cache_state["occ"]:
            span_cache.clear()
            cache_state["occ"] = density.occupancy
        active_host = None
        if pose_key is not None:
            hit = span_cache.get(pose_key)
            if hit is not None:
                sp, va, active_host = hit
            elif cache_cap is None or len(span_cache) < cache_cap:
                sp, va, n_act = span_fn(pose, density)
                # one readback per pose warmup did not prefill
                active_host = int(n_act)
                span_cache[pose_key] = (sp, va, active_host)
            else:
                sp, va, _ = span_fn(pose, density)
        else:
            sp, va, _ = span_fn(pose, density)
        b = t if active_host is None else active_host
        img, enc_a, n_active, n_overflow = frame(
            pose, sp, va, b, torch.as_tensor(auds, device=dev).float(), as_dev(eye),
            torch.as_tensor(bg, device=dev))
        if smooth_enabled:
            smooth_state["enc_a"] = enc_a
        img = torch.clamp(img.reshape(H, W, 3), 0.0, 1.0)
        return (img * 255).to(torch.uint8), n_active, n_overflow

    @torch.no_grad()
    def warmup(density: DensityGrid):
        """Prefill the span cache for the dataset's pose track (up to the
        cap) with one batched count readback, and build K2 when it will
        run, so the live loop never waits on a probe readback or nvcc."""
        span_cache.clear()
        track = dataset.poses if cache_cap is None else dataset.poses[:cache_cap]
        outs = [span_fn(as_dev(p), density) for p in track]
        counts = torch.stack([o[2] for o in outs]).cpu().tolist()
        for i, (sp, va, _) in enumerate(outs):
            span_cache[i] = (sp, va, int(counts[i]))
        cache_state["occ"] = density.occupancy
        if impl == "auto" and dev.type == "cuda":
            sampler.load()

    step.warmup = warmup
    step.span_cache = span_cache
    return step
