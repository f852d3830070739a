"""Wav2Lip generator training (L1, plus the SyncNet and discriminator
terms) and the alternating generator/discriminator step, on one device.

Port of mere_fusion_tpu/train/wav2lip_train.py (the reference trains
wav2lip with torch, hparams at wav2lip/hparams.py:76-100: batch 16, Adam at
1e-4, L1 + syncnet + disc terms). BatchNorm runs in training mode as flax's
does (models/wav2lip.py: the biased batch variance, running statistics at
momentum 0.9). Adam is ``torch.optim.Adam`` at optax.adam's settings
(b1 0.9, b2 0.999, eps 1e-8 added to the bias-corrected √v̂, as optax
places it). The JAX package shards the step over a (dp, tp) mesh; here it
runs on one device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mere_fusion_tpu_torch.device import random_init_, resolve_device
from mere_fusion_tpu_torch.models.syncnet import SyncNet, cosine_sync_loss
from mere_fusion_tpu_torch.models.wav2lip import Wav2Lip, Wav2LipDisc

SYNC_GATE_THRESHOLD = 0.75  # running sync loss below this flips sync_wt on


@dataclass
class TrainState:
    model: Wav2Lip                  # float32, training mode
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclass
class GANTrainState:
    gen: TrainState
    disc: Wav2LipDisc
    disc_optimizer: torch.optim.Optimizer


def adam(params, lr: float) -> torch.optim.Adam:
    """optax.adam(lr) in torch: b1 0.9, b2 0.999, eps 1e-8 outside the root."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def init_state(seed: int = 0, lr: float = 1e-4, device=None) -> TrainState:
    """A seeded generator (models/wav2lip.py) in training mode with its Adam."""
    model = random_init_(Wav2Lip().to(resolve_device(device)), seed).train()
    return TrainState(model, adam(model.parameters(), lr))


def init_gan_state(seed: int = 0, lr: float = 1e-4, disc_lr: float = 1e-4,
                   device=None) -> GANTrainState:
    """Generator + quality-discriminator training state (the reference's hq
    recipe: Adam at 1e-4 both, hparams.py:80, 93)."""
    gen = init_state(seed, lr, device)
    disc = random_init_(Wav2LipDisc().to(resolve_device(device)), seed + 1).train()
    return GANTrainState(gen, disc, adam(disc.parameters(), disc_lr))


def frozen(module: torch.nn.Module) -> torch.nn.Module:
    """A scorer used inside a step: eval mode, no parameter gradients
    (gradients still flow through it to its input)."""
    return module.eval().requires_grad_(False)


def sync_loss(syncnet: SyncNet, mel: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The frozen SyncNet's cosine loss on the lower half of generated faces.
    The face window is the half tiled 5 times along channels ([B, S/2, S, 15],
    jnp.tile), the 5-frame window of a batch that carries one frame a
    sample."""
    half = out[:, out.shape[1] // 2:]
    a_emb, f_emb = syncnet(mel, half.repeat(1, 1, 1, 5))
    return cosine_sync_loss(a_emb, f_emb, torch.ones(out.shape[0], device=out.device))


def bce(pred: torch.Tensor, target: float) -> torch.Tensor:
    p = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    return -(target * torch.log(p) + (1 - target) * torch.log(1 - p)).mean()


def _named_grads(loss: torch.Tensor, module: torch.nn.Module) -> dict[str, torch.Tensor]:
    names, params = zip(*module.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def _apply(optimizer: torch.optim.Optimizer, module: torch.nn.Module,
           grads: dict[str, torch.Tensor]) -> None:
    for name, p in module.named_parameters():
        p.grad = grads[name]
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def make_train_step(syncnet: SyncNet | None = None, disc: Wav2LipDisc | None = None,
                    syncnet_wt: float = 0.03, disc_wt: float = 0.07):
    """(grads, step). batch: {mel [B,80,16], faces [B,S,S,6], target
    [B,S,S,3]} on the state's device.

    loss = L1(G, target) + syncnet_wt · sync + disc_wt · (−log D(G)) with a
    frozen SyncNet and discriminator when given (reference hparams.py:76-100).
    ``grads(state, batch)`` → (loss, {name: gradient}), moving the BatchNorm
    running statistics as the forward does; ``step(state, batch)`` → {loss}
    also takes one Adam update."""
    if syncnet is not None:
        frozen(syncnet)
    if disc is not None:
        frozen(disc)

    def grads(state: TrainState, batch: dict):
        out = state.model(batch["mel"], batch["faces"])
        loss = torch.mean(torch.abs(out - batch["target"]))
        if syncnet is not None:
            loss = loss + syncnet_wt * sync_loss(syncnet, batch["mel"], out)
        if disc is not None:
            loss = loss - disc_wt * torch.log(torch.clamp(disc(out), 1e-7, 1.0)).mean()
        return loss.detach(), _named_grads(loss, state.model)

    def step(state: TrainState, batch: dict) -> dict:
        loss, g = grads(state, batch)
        _apply(state.optimizer, state.model, g)
        state.step += 1
        return {"loss": loss}

    return grads, step


def make_gan_train_step(syncnet: SyncNet | None = None, disc_wt: float = 0.07):
    """(grads, step): the alternating generator/discriminator step of the
    reference hq recipe (wav2lip/models/wav2lip.py:127-184, hparams.py:76-100):

      gen loss  = sync_wt·sync + disc_wt·perceptual + (1−sync_wt−disc_wt)·L1
        where perceptual = BCE(D(lower half of G), 1)
      disc loss = BCE(D(lower half of gt), 1) + BCE(D(lower half of Ĝ), 0)
        on the generator's output detached

    Both gradients are taken at the parameters before either update.
    ``sync_wt`` is a runtime scalar: the reference starts at 0.0 and flips to
    0.03 once the running sync loss crosses SYNC_GATE_THRESHOLD; the caller
    keeps that decision. ``grads(state, batch, sync_wt)`` → (metrics,
    generator gradients, discriminator gradients); ``step(state, batch,
    sync_wt)`` → metrics {loss, l1, sync, perceptual, disc_real, disc_fake}
    after both Adam updates."""
    if syncnet is not None:
        frozen(syncnet)

    def grads(state: GANTrainState, batch: dict, sync_wt: float):
        model, disc = state.gen.model, state.disc
        out = model(batch["mel"], batch["faces"])
        l1 = torch.mean(torch.abs(out - batch["target"]))
        sync = (sync_loss(syncnet, batch["mel"], out) if syncnet is not None
                else torch.zeros((), device=out.device))
        perc = bce(disc(out), 1.0)
        loss = sync_wt * sync + disc_wt * perc + (1.0 - sync_wt - disc_wt) * l1
        gen_grads = _named_grads(loss, model)
        d_real = bce(disc(batch["target"]), 1.0)
        d_fake = bce(disc(out.detach()), 0.0)
        disc_grads = _named_grads(d_real + d_fake, disc)
        metrics = {"loss": loss, "l1": l1, "sync": sync, "perceptual": perc,
                   "disc_real": d_real, "disc_fake": d_fake}
        return {k: v.detach() for k, v in metrics.items()}, gen_grads, disc_grads

    def step(state: GANTrainState, batch: dict, sync_wt: float) -> dict:
        metrics, gen_grads, disc_grads = grads(state, batch, sync_wt)
        _apply(state.gen.optimizer, state.gen.model, gen_grads)
        _apply(state.disc_optimizer, state.disc, disc_grads)
        state.gen.step += 1
        return metrics

    return grads, step
