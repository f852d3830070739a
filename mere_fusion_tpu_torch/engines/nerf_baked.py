"""ER-NeRF frame steps without K2: the ``nearest`` and ``bilinear`` sample
modes on baked textures, and the unbaked per-frame hash-encode step.

Port of mere_fusion_tpu/engines/nerf.py's ``make_nerf_render_step``: with
baked textures (``make_baked_render_step``, the step ``NeRFReal`` serves
when ``nerf.sample_mode`` is not "pallas") and without
(``make_unbaked_render_step``, its ``baked is None`` branch, which
``NeRFReal(bake_planes=False)`` serves in every sample mode). One frame:
camera rays from the pose → occupancy probe (block-shared every
``nerf.probe_block`` pixels) and sample placement → static compaction to
the first ``nerf.max_active_rays`` rays with a valid sample, in raster
order (``models.ernerf.renderer.plan_rays``) → every sample's features:
texture samples (``ops.triplane_bake.encode_x_baked``, nearest or
bilinear), or the network's hash encode (``NeRFNetwork.encode_x``, kernel
K3 on CUDA, in float32 as the JAX package's) → the NeRF head → composite,
scattered back over the background → uint8 RGB, the clipped image times 255
truncated. With the torso net the background is the torso pass blended onto
the background colour (``nerf_step.torso_composite``), computed every frame
in float32 and not cached, as the JAX package's non-Pallas step does.

The head runs in ``nerf.shade_dtype``. In bfloat16 it rounds where the JAX
package's ``NeRFNetwork(dtype=bfloat16)`` rounds as XLA compiles it: each
Dense rounds its input and its kernel to bf16 and sums the products in f32;
its result rounds to bf16 where a bf16 operation (relu, the sigmoid's
steps, a slice read twice) consumes it, and stays f32 where the next
operation promotes it to f32 (the audio attention's product with the audio
code, σ's exp and the outputs' cast). No kernel of this repository samples
the textures: the JAX package gathers them with XLA, and the port with
PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.engines.nerf_step import smooth_enc_a_fn, torso_composite
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetwork
from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid, get_rays, plan_rays, shade
from mere_fusion_tpu_torch.ops import hash_lookup
from mere_fusion_tpu_torch.ops.encoders import sh_encode
from mere_fusion_tpu_torch.ops.triplane_bake import encode_x_baked

SAMPLE_MODES = ("nearest", "bilinear")


def _r(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16, keep as float32."""
    return x.to(torch.bfloat16).float()


# ER-NeRF's colour activation constants as bf16 scalars (1.002 rounds to 1)
_RGB_SCALE, _RGB_SHIFT = float(_r(torch.tensor(1.002))), float(_r(torch.tensor(0.001)))


@torch.no_grad()
def forward_with_enc_bf16(net: NeRFNetwork, enc_x, d, enc_a, c=None, e=None):
    """``NeRFNetwork.forward_with_enc`` at inference with bf16 Dense layers,
    rounded as the module docstring says. Returns float32 (sigma [N], color
    [N, 3], ambient_aud [N, 1], ambient_eye [N, 1], uncertainty [N, 1])."""
    def dense(x, mlp, l):
        return _r(x) @ _r(mlp.layer(l).weight.T)

    def sigmoid(x):                       # 1 / (1 + exp(-x)), each step in bf16
        return 1.0 / _r(1.0 + _r(torch.exp(-x)))

    n = enc_x.shape[0]
    aud_ch = dense(torch.relu(_r(dense(enc_x, net.aud_ch_att_net, 0))), net.aud_ch_att_net, 1)
    parts = [enc_x, enc_a.expand(n, enc_a.shape[-1]) * aud_ch]
    if e is not None:
        eye_logit = _r(dense(torch.relu(_r(dense(enc_x, net.eye_att_net, 0))),
                             net.eye_att_net, 1))
        eye_att = sigmoid(eye_logit)
        parts.append(e.expand(n, 1) * eye_att)
    else:
        eye_att = torch.zeros(n, 1, dtype=enc_x.dtype, device=enc_x.device)
    h = torch.relu(_r(dense(torch.cat(parts, dim=-1), net.sigma_net, 0)))
    h = torch.relu(_r(dense(h, net.sigma_net, 1)))
    out = _r(dense(h, net.sigma_net, 2))
    sigma = torch.exp(out[:, 0])
    parts = [sh_encode(d, 4), out[:, 1:]]
    if c is not None:
        parts.append(c.expand(n, c.shape[-1]))
    hc = torch.relu(_r(dense(torch.cat(parts, dim=-1), net.color_net, 0)))
    color = _r(sigmoid(_r(dense(hc, net.color_net, 1)))) * _RGB_SCALE - _RGB_SHIFT
    amb_aud = torch.linalg.norm(aud_ch, dim=-1, keepdim=True)
    unc = torch.log1p(torch.exp(torch.zeros_like(amb_aud)))
    return sigma, color, amb_aud, eye_att, unc


def make_baked_render_step(network: NeRFNetwork, dataset, cfg: Config, baked: dict):
    """step(pose, auds, eye, density, bg, pose_key=None) → (RGB uint8
    [H, W, 3] on the network's device, None, None): the K2 step's call and
    result, with no tile counts to report (``pose_key`` is unused) and a
    ``warmup`` that has nothing to prefill. ``baked`` holds the textures of
    bake_triplanes."""
    nc = cfg.nerf
    if nc.sample_mode not in SAMPLE_MODES:
        raise ValueError(f"nerf.sample_mode {nc.sample_mode!r} is not one of {SAMPLE_MODES}")
    render = _frame_renderer(network, dataset, cfg, lambda xyz: encode_x_baked(
        baked, xyz, nc.bound, nc.sample_mode))

    def step(pose, auds, eye, density: DensityGrid, bg, pose_key=None):
        return render(pose, auds, eye, density, bg), None, None

    step.warmup = lambda density, bg: None
    return step


def make_unbaked_render_step(network: NeRFNetwork, dataset, cfg: Config):
    """The baked step's call and result with each sample's features from the
    network's hash encode (``encode_x``: K3 on CUDA, its plain version on
    the CPU or with ``models.ernerf.network.ENCODE_IMPL = "plain"``), in every
    sample mode. ``warmup`` builds K3 on CUDA, so the live loop never waits
    on nvcc."""
    render = _frame_renderer(network, dataset, cfg, network.encode_x)

    def step(pose, auds, eye, density: DensityGrid, bg, pose_key=None):
        return render(pose, auds, eye, density, bg), None, None

    def warmup(density, bg):
        if network.plane_xy.device.type == "cuda":
            hash_lookup.load()

    step.warmup = warmup
    return step


def _frame_renderer(network: NeRFNetwork, dataset, cfg: Config, encode):
    """render(pose, auds, eye, density, bg) → RGB uint8 [H, W, 3]: one frame
    around ``encode`` (sample positions [M, 3] → features [M, F]); see the
    module docstring."""
    nc = cfg.nerf
    dev = network.plane_xy.device
    H, W = dataset.H, dataset.W
    intrinsics = dataset.intrinsics
    pb = nc.probe_block
    probe_block = pb if pb > 0 and H % pb == 0 and W % pb == 0 else 0
    plan_kw = dict(bound=nc.bound, grid_size=nc.grid_size, n_candidates=nc.n_candidates,
                   n_steps=nc.max_steps, max_active_rays=nc.max_active_rays,
                   probe_block=probe_block, image_hw=(H, W))
    bf16 = nc.shade_dtype == "bfloat16"
    smooth_state: dict = {"enc_a": None}

    def as_dev(a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    @torch.no_grad()
    def render(pose, auds, eye, density: DensityGrid, bg):
        pose, bg = as_dev(pose), as_dev(bg)
        if network.cfg.torso:
            bg = torso_composite(network, H, W, pose, bg)
        rays_o, rays_d = get_rays(pose, intrinsics, H, W)
        plan = plan_rays(rays_o, rays_d, density, **plan_kw)
        enc_x = encode(plan["xyz"].reshape(-1, 3))
        enc_a = network.encode_audio(as_dev(auds))
        if nc.smooth_lips:
            if smooth_state["enc_a"] is not None:
                enc_a = smooth_enc_a_fn(smooth_state["enc_a"], enc_a)
            smooth_state["enc_a"] = enc_a
        ind = network.individual_code(0) if network.cfg.individual_dim > 0 else None
        eye = as_dev(eye)

        def apply_fn(enc, dirs, training):
            if bf16:
                return forward_with_enc_bf16(network, enc, dirs, enc_a, ind, eye)
            return network.forward_with_enc(enc, dirs, enc_a, ind, eye, training)

        out = shade(apply_fn, plan, bg, enc_x=enc_x, n_rays=H * W)
        img = torch.clamp(out["image"].reshape(H, W, 3), 0.0, 1.0)
        return (img * 255).to(torch.uint8)

    return render
