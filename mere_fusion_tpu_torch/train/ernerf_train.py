"""ER-NeRF head training: composite loss, optimiser groups, EMA, density-grid
refresh.

Port of mere_fusion_tpu/train/ernerf_train.py (head stage; the twin of the
reference Trainer.train_step): per-ray MSE with uncertainty re-weighting,
the uncertainty NLL term on face pixels, static-uncertainty suppression
off-face, weights-sum entropy, the ambient-audio off-face and ambient-eye
cross regularizers, and the jitter regularizer. Every network call goes
through ``NeRFNetwork.encode_x``, so on the card each one launches kernel
K3 (forward in the step, backward in ``loss.backward()``).

The JAX step is one jitted pure function over a state tuple; here the state
holds the network and a ``torch.optim.AdamW`` whose three parameter groups
reproduce the optax ``multi_transform``: Adam for the hash tables, AdamW
(weight decay 1e-4, optax's default) for the MLPs, and AdamW at 5× the rate
for the audio attention net. The jitter noise comes from an explicit
``torch.Generator``, or from the caller (the tests hand over the JAX draw).

The torso stage (``init_torso_train``, ``make_torso_train_step``) trains
only the torso's parameters with Adam against torso-over-background
targets, every head parameter loaded from the head's checkpoint and frozen.

The patch and lips fine-tuning steps add an LPIPS term on the batch's
patches (``lpips_fn`` with ``patch_hw``): 0.1 × LPIPS on random patches,
0.01 × LPIPS on the lips window, whose step also drops the uncertainty loss.
Its gradient reaches the hash tables through K3's backward.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetwork, is_torso_param
from mere_fusion_tpu_torch.models.ernerf.renderer import (
    DensityGrid,
    render_rays,
    update_density_grid,
)

# the JAX step's EMA decay: a constant there too (its config's ema_decay field
# is never read, so the port's config has none)
EMA_DECAY = 0.95


@dataclass(frozen=True)
class NeRFTrainConfig:
    bound: float = 1.0
    grid_size: int = 128
    n_candidates: int = 64
    n_steps: int = 16
    iters: int = 200_000
    lr: float = 5e-3          # grid lr (reference main.py:219)
    lr_net: float = 5e-4
    unc_loss: bool = True
    amb_aud_loss: bool = True
    amb_eye_loss: bool = True
    lambda_amb: float = 1e-4
    density_thresh: float = 10.0


@dataclass
class NeRFTrainState:
    network: NeRFNetwork
    optimizer: torch.optim.Optimizer
    ema: dict = field(default_factory=dict)      # parameter name → EMA tensor
    density: DensityGrid | None = None
    step: int = 0

    def state_dict(self) -> dict:
        d = self.density
        return {"network": self.network.state_dict(), "optimizer": self.optimizer.state_dict(),
                "ema": dict(self.ema), "step": int(self.step),
                "density": {"grid": d.grid, "occupancy": d.occupancy,
                            "mean_density": d.mean_density}}

    def load_state_dict(self, sd: dict) -> None:
        self.network.load_state_dict(sd["network"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        dev = self.network.plane_xy.device
        self.ema = {k: v.to(dev) for k, v in sd["ema"].items()}
        self.density = DensityGrid(**{k: v.to(dev) for k, v in sd["density"].items()})
        self.step = int(sd["step"])


def param_group(name: str) -> str:
    """The optax label of a parameter: 'grid', 'att' or 'net'."""
    top = name.split(".")[0]
    if top.startswith("plane_") or top == "torso_grid":
        return "grid"
    return "att" if top == "audio_att_net" else "net"


def init_nerf_train(network: NeRFNetwork, tcfg: NeRFTrainConfig) -> NeRFTrainState:
    """Optimiser and state as the JAX init_nerf_train sets them: hash tables
    at lr with Adam, MLPs at lr_net and the audio attention net at 5×lr_net
    with AdamW (weight decay 1e-4); betas (0.9, 0.99), eps 1e-15."""
    groups = {"grid": [], "net": [], "att": []}
    for name, p in network.named_parameters():
        groups[param_group(name)].append(p)
    optimizer = torch.optim.AdamW(
        [{"params": groups["grid"], "lr": tcfg.lr, "weight_decay": 0.0},
         {"params": groups["net"], "lr": tcfg.lr_net, "weight_decay": 1e-4},
         {"params": groups["att"], "lr": 5 * tcfg.lr_net, "weight_decay": 1e-4}],
        betas=(0.9, 0.99), eps=1e-15)
    dev = network.plane_xy.device
    return NeRFTrainState(
        network=network, optimizer=optimizer,
        ema={n: p.detach().clone() for n, p in network.named_parameters()},
        density=DensityGrid.create(tcfg.grid_size, device=dev))


def nerf_loss(state: NeRFTrainState, batch: dict, tcfg: NeRFTrainConfig,
              noise: torch.Tensor, lpips_fn=None, patch_hw: tuple | None = None,
              lpips_weight: float = 0.1) -> tuple[torch.Tensor, dict]:
    """The head-stage loss of one batch; noise [N, 3] in [0, 1) places the
    jitter points. With ``lpips_fn`` and ``patch_hw`` = (ph, pw), the batch
    is patches of ph×pw rays, patch-major and row-major, and the loss adds
    lpips_weight × lpips_fn over them (NHWC, the [0, 1] colours as they are,
    as the reference passes them). Returns (loss, metrics) with the metrics
    detached."""
    network = state.network
    enc_a = network.encode_audio(batch["auds"])
    ind = (network.individual_code(batch["index"])
           if network.cfg.individual_dim > 0 else None)
    eye = batch["eye"]

    def apply_fn(xyz, dirs, training):
        return network(xyz, dirs, enc_a, ind, eye, training)

    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    out = render_rays(apply_fn, rays_o, rays_d, state.density, bound=tcfg.bound,
                      grid_size=tcfg.grid_size, bg_color=batch["bg_color"],
                      n_candidates=tcfg.n_candidates, n_steps=tcfg.n_steps, training=True)
    pred, rgb = out["image"], batch["rgb"]
    n = pred.shape[0]
    face = batch["face_mask"].to(torch.float32)
    off_face = (~batch["face_mask"]).to(torch.float32)
    dev = pred.device
    sf = torch.minimum(torch.tensor(np.float32(state.step) / np.float32(tcfg.iters),
                                    device=dev), torch.ones((), device=dev))

    loss = ((pred - rgb) ** 2).mean(-1)                         # [N]
    if tcfg.unc_loss:
        unc = out["uncertainty"][:, 0]
        unc_w = torch.softmax(unc, dim=0) * n
        alpha = 0.2
        w = alpha + (1 - alpha) * torch.clamp((1 - sf) + sf * unc_w.detach(), 0, 10)
        loss = loss * w
        beta = unc + 1.0
        norm_rgb = torch.linalg.norm(pred - rgb, dim=-1).detach()
        loss_u = norm_rgb / (2 * beta**2) + torch.log(beta) ** 2 / 2
        loss = loss + sf * loss_u * face
        loss = loss + 1e-3 * sf * unc * off_face
    loss = loss.mean()

    if lpips_fn is not None and patch_hw is not None:
        ph, pw = patch_hw
        loss = loss + lpips_weight * lpips_fn(pred.reshape(-1, ph, pw, 3),
                                              rgb.reshape(-1, ph, pw, 3))

    # weights-sum entropy: push rays to fully opaque or fully transparent
    ws = torch.clamp(out["weights_sum"], 1e-5, 1 - 1e-5)
    loss_ws = -(ws * torch.log2(ws) + (1 - ws) * torch.log2(1 - ws))
    loss = loss + 1e-4 * loss_ws.mean()

    lambda_amb = sf * tcfg.lambda_amb
    amb_aud = out["ambient_aud"][:, 0]
    if tcfg.amb_aud_loss:
        loss = loss + lambda_amb * (amb_aud * off_face).mean()
    if tcfg.amb_eye_loss:
        amb_eye = out["ambient_eye"][:, 0] / tcfg.n_steps
        loss = loss + lambda_amb * (amb_eye * amb_aud.detach() * face).mean()

    # jitter regularizer on points along the rays
    xyz = rays_o + rays_d
    delta = (noise * 2 - 1) * 1e-3
    _, _, aud_raw, eye_raw, _ = apply_fn(xyz.detach(), rays_d, False)
    _, _, aud_reg, eye_reg, _ = apply_fn(xyz + delta, rays_d, True)
    reg = ((aud_raw - aud_reg) ** 2).mean() + ((eye_raw - eye_reg) ** 2).mean()
    loss = loss + sf * 1e-5 * reg
    return loss, {"loss": loss.detach(), "mse": ((pred - rgb) ** 2).mean().detach(),
                  "weights_sum": ws.mean().detach()}


def compute_grads(state: NeRFTrainState, batch: dict, tcfg: NeRFTrainConfig,
                  noise: torch.Tensor, **lpips) -> dict:
    """Loss and gradients of one batch, left in every parameter's ``.grad``
    (zeros where the loss does not reach, as in the JAX step, so the
    optimiser updates every parameter). ``lpips`` holds nerf_loss's LPIPS
    arguments. Returns the metrics with grad_norm."""
    params = list(state.network.parameters())
    for p in params:
        p.grad = None
    loss, metrics = nerf_loss(state, batch, tcfg, noise, **lpips)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    metrics["grad_norm"] = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(p.grad) for p in params]))
    return metrics


def make_nerf_train_step(tcfg: NeRFTrainConfig, lpips_fn=None, patch_hw: tuple | None = None,
                         lpips_weight: float = 0.1):
    """step(state, batch, generator=None, noise=None) → metrics, updating
    the state in place: gradients, the optimiser, the EMA, the step count.
    noise [N, 3] in [0, 1) defaults to a draw from ``generator``. With
    ``lpips_fn`` and ``patch_hw`` the loss has the LPIPS patch term
    (nerf_loss); lpips_weight 0.1 for random patches, 0.01 for the lips
    window."""
    lpips = {"lpips_fn": lpips_fn, "patch_hw": patch_hw, "lpips_weight": lpips_weight}

    def train_step(state: NeRFTrainState, batch: dict, generator=None, noise=None) -> dict:
        if noise is None:
            noise = torch.rand(batch["rays_o"].shape, generator=generator,
                               device=batch["rays_o"].device)
        metrics = compute_grads(state, batch, tcfg, noise, **lpips)
        apply_update(state)
        return metrics

    return train_step


@torch.no_grad()
def apply_update(state: NeRFTrainState) -> None:
    """The optimiser's step on the gradients in each ``.grad``, the EMA of
    every parameter (frozen ones included) and the step count."""
    state.optimizer.step()
    names, params = zip(*state.network.named_parameters())
    ema = [state.ema[n] for n in names]
    torch._foreach_mul_(ema, EMA_DECAY)
    torch._foreach_add_(ema, [p.detach() for p in params], alpha=1 - EMA_DECAY)
    state.step += 1


@torch.no_grad()
def refresh_density_grid(state: NeRFTrainState, mean_auds: torch.Tensor,
                         tcfg: NeRFTrainConfig) -> NeRFTrainState:
    """Every-16-steps grid maintenance: the density of every cell centre
    under the audio window ``mean_auds`` [W, A, 16], decayed max into the
    grid, then the occupancy threshold."""
    network = state.network
    enc_a = network.encode_audio(mean_auds)
    eye = (torch.full((1, 1), 0.25, device=mean_auds.device)
           if network.cfg.exp_eye else None)
    state.density = update_density_grid(
        lambda xyz: network.density(xyz, enc_a, eye)["sigma"], state.density, tcfg.bound,
        tcfg.grid_size, density_thresh=tcfg.density_thresh)
    return state


def init_torso_train(network: NeRFNetwork, tcfg: NeRFTrainConfig,
                     head_params: dict | None = None) -> NeRFTrainState:
    """State of the torso stage. ``head_params`` (a state dict of the trained
    head stage's raw parameters) merges in non-strictly: every entry the
    network has, but the torso's. Every parameter but the torso's is then
    frozen (no gradient, no moments, no update: optax's set_to_zero), and the
    torso's train with Adam at lr, betas (0.9, 0.99), eps 1e-15. The EMA
    starts from the merged parameters."""
    if head_params is not None:
        with torch.no_grad():
            for name, p in network.named_parameters():
                if name in head_params and not is_torso_param(name):
                    p.copy_(head_params[name])
    torso = []
    for name, p in network.named_parameters():
        p.requires_grad_(is_torso_param(name))
        if is_torso_param(name):
            torso.append(p)
    optimizer = torch.optim.Adam(torso, lr=tcfg.lr, betas=(0.9, 0.99), eps=1e-15)
    return NeRFTrainState(
        network=network, optimizer=optimizer,
        ema={n: p.detach().clone() for n, p in network.named_parameters()},
        density=DensityGrid.create(tcfg.grid_size, device=network.plane_xy.device))


def compute_torso_grads(state: NeRFTrainState, batch: dict) -> dict:
    """The torso loss of one batch and its gradients, left in the torso's
    parameters' ``.grad``: the MSE of the torso composite against
    bg_torso_color, plus the anchor term (1 − the anchors' w)² and 1e-4 ×
    the alpha entropy in bits. Returns the metrics, detached."""
    network = state.network
    state.optimizer.zero_grad(set_to_none=True)
    c = (network.individual_codes_torso[batch["index"]][None]
         if network.cfg.individual_dim_torso > 0 else None)
    alpha, color, _dx = network.forward_torso(batch["coords"], batch["pose"], c)
    pred = color * alpha + batch["bg_color"] * (1 - alpha)
    mse = ((pred - batch["bg_torso_color"]) ** 2).mean()
    loss = mse + ((1 - network.anchor_points[:, 3]) ** 2).mean()
    a = torch.clamp(alpha, 1e-5, 1 - 1e-5)
    entropy = -(a * torch.log2(a) + (1 - a) * torch.log2(1 - a))
    loss = loss + 1e-4 * entropy.mean()
    loss.backward()
    return {"loss": loss.detach(), "mse": mse.detach(), "torso_alpha": alpha.mean().detach()}


def make_torso_train_step():
    """step(state, batch) → metrics, updating the state in place: the torso
    loss's gradients, one Adam update of the torso's parameters, the EMA of
    every parameter (the frozen ones unchanged), the step count."""

    def train_step(state: NeRFTrainState, batch: dict) -> dict:
        metrics = compute_torso_grads(state, batch)
        apply_update(state)
        return metrics

    return train_step
