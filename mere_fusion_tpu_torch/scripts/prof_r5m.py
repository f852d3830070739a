"""Split K2's time into its stages: S1 (the u interpolation of the window
fetch alone) and S2 (K2 stopped after its fetch or its head; ``full`` is
K2 itself), on prof_r5k's operands.

Twin of scripts/prof_r5m.py. Run on a machine with an NVIDIA GPU:

    python -m mere_fusion_tpu_torch.scripts.prof_r5m

It prints ``16x8 wv32 m1-only`` and ``16x8 wv32 section=win|shade|full``,
each the best of 3 rounds of 10 launches timed with CUDA events. K2's
fetch is ``win`` and its head at most ``full − win``; ``shade`` also
computes every column of the head's last two products for the rows it
returns, so ``shade − win`` overstates the head and ``full − shade`` does
not resolve the composite. Without CUDA it raises.
"""
from __future__ import annotations

import torch

from mere_fusion_tpu_torch.ops import sampler_stages
from mere_fusion_tpu_torch.ops.sampler import SHADE_WEIGHTS, SamplerSpec
from mere_fusion_tpu_torch.scripts.prof_r5k import C, N_RAYS, R, best_ms, cuda_device, make_inputs


def bench(name: str, go, *args) -> float:
    """Time go(*args) (prof_r5k.best_ms); prints ``name  ms``, returns ms."""
    best, _ = best_ms(lambda: go(*args))
    print(f"{name:44s} {best:8.2f} ms", flush=True)
    return best


def m1_only(spec: SamplerSpec, blockdiag: bool):
    """S1 as the reference's call: call(jobs, uv, planes) → [T, sg, 128]
    float32 ([T, kg·sg, 128] with blockdiag)."""
    def call(scal, uvr, planes):
        return sampler_stages.m1_only(planes, scal, uvr, spec, blockdiag)
    return call


def sections(spec: SamplerSpec, mode: str):
    """S2 at ``mode`` ("win", "shade" or "full") as the reference's call:
    call(jobs, uv, dproj, dtv, *weights in SHADE_WEIGHTS order, planes) →
    [T, rpt, 16] float32."""
    if mode not in sampler_stages.SECTION_MODES:
        raise ValueError(f"section mode {mode!r} is not one of {sampler_stages.SECTION_MODES}")

    def call(scal, uvr, dproj, dtv, *refs):
        *wl, planes = refs
        return sampler_stages.sections(planes, scal, uvr, dproj, dtv,
                                       dict(zip(SHADE_WEIGHTS, wl)), spec, mode)
    return call


def main(device=None, seed: int = 0) -> dict:
    """The reference's runs; returns {line name: ms}."""
    dev = cuda_device(device)
    times = {}
    for tw, wv in ((16, 32),):
        spec = SamplerSpec(resolution=R, channels=C, tile_w=tw, tile_h=8, k=16, kg=4, wu=64,
                           wv=wv)
        t = N_RAYS // spec.rays_per_tile
        gen = torch.Generator(device=dev).manual_seed(seed)
        scal, uv, dproj, dtv, weights, planes = make_inputs(spec, t, gen, dev)
        uvr = uv.reshape(t * 3, spec.kg, 2, spec.sg)
        name = f"{tw}x8 wv{wv} m1-only"
        times[name] = bench(name, m1_only(spec, False), scal, uvr, planes)
        wl = [weights[k] for k in SHADE_WEIGHTS]
        for mode in sampler_stages.SECTION_MODES:
            name = f"{tw}x8 wv{wv} section={mode}"
            times[name] = bench(name, sections(spec, mode), scal, uvr, dproj, dtv, *wl, planes)
    return times


if __name__ == "__main__":
    main()
