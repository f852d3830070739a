"""MuseTalk's int8 serving tier: the load-time gate's outcome and each
tier's generate time.

Twin of scripts/prof_r5_int8.py. Run on a machine with an NVIDIA GPU:

    python -m mere_fusion_tpu_torch.scripts.prof_r5_int8

It builds one full-width bf16 ``MuseModels(vae_int8="auto")`` from seeded
weights and prints the tier the gate kept, each probed rung's PSNR and the
gate's seconds; then ``<tier> ms/batch16`` for the kept tier, "full" (the
int8 VAE decode, ``vae_int8="on"``) and "off" (float): the p50 of
``generate`` at batch 16 between two CUDA events, each tier switched on the
same weights (the JAX twin builds a model per tier; the port's tiers only
switch the convolutions' arithmetic). Without CUDA it raises.
"""
from __future__ import annotations

import numpy as np
import torch

from mere_fusion_tpu_torch.engines.muse import MuseModels
from mere_fusion_tpu_torch.scripts.prof_r5k import cuda_device

BATCH = 16
ITERS = 20


def generate_ms(models: MuseModels, batch: int = BATCH, iters: int = ITERS) -> float:
    """p50 ms of ``models.generate`` on seeded [batch, h, w, 8] latents and
    [batch, 50, 384] features, each call between two CUDA events."""
    rng = np.random.default_rng(0)
    ls, dev = models.latent_size, models.device
    lat = torch.from_numpy(rng.standard_normal((batch, ls, ls, 8)).astype(np.float32)).to(dev)
    feats = torch.from_numpy(rng.standard_normal(
        (batch, 50, models.unet_cfg.cross_attention_dim)).astype(np.float32)).to(dev)
    for _ in range(3):
        models.generate(lat, feats)
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        models.generate(lat, feats)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[iters // 2]


def main(device=None) -> dict:
    """The reference's run; returns {"tier", "probes", "gate_s", "<tier>_ms"...}."""
    dev = cuda_device(device)
    m = MuseModels(dtype=torch.bfloat16, device=dev, vae_int8="auto")
    out = {"tier": m.int8_tier, "probes": dict(m.int8_gate_probes),
           "gate_s": m.int8_gate_seconds}
    psnr = "none" if m.int8_gate_psnr is None else f"{m.int8_gate_psnr:.2f}"
    print(f"auto tier={m.int8_tier} gate_psnr={psnr} enabled={m.int8_enabled} "
          f"gate_s={m.int8_gate_seconds:.2f}", flush=True)
    for name, value in m.int8_gate_probes.items():
        print(f"   probe {name}: {value:.2f} dB", flush=True)
    chosen = m.int8_tier
    for tier in (chosen, "full", "off"):
        m.set_int8_tier(tier)
        out[f"{tier}_ms"] = generate_ms(m)
        print(f"{tier} ms/batch16 {out[f'{tier}_ms']:.2f}", flush=True)
    m.set_int8_tier(chosen)
    return out


if __name__ == "__main__":
    main()
