"""Time K2 (the fused sample + shade + composite kernel) on dense-512²-shaped
operands made on the card, for four tile shapes and window widths.

Twin of scripts/prof_r5k.py. Run on a machine with an NVIDIA GPU:

    python -m mere_fusion_tpu_torch.scripts.prof_r5k

It prints one line per spec, ``<name>  <ms> ms``: the best of 3 rounds of
10 launches, each timed with CUDA events. Without CUDA it raises.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from mere_fusion_tpu_torch.device import resolve_device
from mere_fusion_tpu_torch.ops import sampler
from mere_fusion_tpu_torch.ops.sampler import SHADE_WEIGHTS, WEIGHT_SHAPES, SamplerSpec

R = 1024
C = 12
N_RAYS = 512 * 512


def cuda_device(device=None) -> torch.device:
    """``device`` (None: the current CUDA device), which must be a CUDA
    device: these scripts time with CUDA events."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the profiling scripts time kernels on a CUDA device, not {dev}")
    return dev


def make_weights(device) -> dict:
    """The 13 head weights, 0.1·N(0, 1) from ``np.random.default_rng(0)`` in
    SHADE_WEIGHTS order, rounded to bf16: bit for bit the reference's."""
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(0.1 * rng.standard_normal(WEIGHT_SHAPES[k]).astype(np.float32))
            .to(device=device, dtype=torch.bfloat16) for k in SHADE_WEIGHTS}


def make_inputs(spec: SamplerSpec, t: int, generator: torch.Generator, device):
    """K2's operands for t tiles, made on ``device`` from ``generator`` (a
    torch.Generator on that device), with the reference's distributions:

    - jobs int32 [3t·(1 + 2kg)]: plane 0, then per group (ou, ov), each a
      multiple of 8 in [0, R − wu) and [0, R − wv);
    - uv f32 [3t, kg, 2, sg]: u = ou + U(0, wu − 1.01), absolute; v = U(0,
      wv − 1.01), window-local (not offset by ov, as the reference draws
      it: most samples clamp to their window's first column);
    - dproj bf16 N(0, 1) [t, rpt, 64]; dtv f32 [t, rpt, 8], lane 0 = 0.01;
    - planes bf16 N(0, 1) [3, mip_rows[-1], R·16], all 16 lanes of every
      texel (the padding too);
    - the head weights of ``make_weights``.

    Returns (jobs, uv, dproj, dtv, weights, planes), the reference's order."""
    j, kg, sg = 3 * t, spec.kg, spec.sg
    kw = dict(generator=generator, device=device)
    ou = torch.randint(0, max(1, R - spec.wu), (j, kg), **kw) // 8 * 8
    ov = torch.randint(0, max(1, R - spec.wv), (j, kg), **kw) // 8 * 8
    scal = torch.zeros(j, 1 + 2 * kg, dtype=torch.int32, device=device)
    scal[:, 1::2] = ou.to(torch.int32)
    scal[:, 2::2] = ov.to(torch.int32)
    u = ou[:, :, None].float() + torch.rand(j, kg, sg, **kw) * (spec.wu - 1.01)
    v = torch.rand(j, kg, sg, **kw) * (spec.wv - 1.01)
    uv = torch.stack([u, v], dim=2)                                  # [j, kg, 2, sg]
    planes = torch.randn(3, spec.mip_rows[-1], R * spec.cp, dtype=torch.bfloat16, **kw)
    dproj = torch.randn(t, spec.rays_per_tile, 64, dtype=torch.bfloat16, **kw)
    dtv = torch.zeros(t, spec.rays_per_tile, 8, device=device)
    dtv[..., 0] = 0.01
    return scal.reshape(-1), uv, dproj, dtv, make_weights(device), planes


def best_ms(fn, rounds: int = 3, iters: int = 10):
    """The best of ``rounds`` rounds of ``iters`` calls of fn, each round
    timed with CUDA events, in ms per call, after one warm-up call: 1 +
    rounds·iters calls in all. Returns (ms, the last call's result)."""
    out = fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best, out


def run(name: str, spec: SamplerSpec, device=None, seed: int = 0):
    """Time K2 on ``make_inputs``' operands; prints ``name  ms`` and returns
    (best ms, K2's output)."""
    dev = cuda_device(device)
    t = N_RAYS // spec.rays_per_tile
    gen = torch.Generator(device=dev).manual_seed(seed)
    scal, uv, dproj, dtv, weights, planes = make_inputs(spec, t, gen, dev)
    uvr = uv.reshape(t * 3, spec.kg, 2, spec.sg)

    def go():
        return sampler.sample_shade_comp_tiles(planes, scal, uvr, dproj, dtv, weights, spec)

    best, out = best_ms(go)
    print(f"{name:40s} {best:8.2f} ms", flush=True)
    return best, out


def main(device=None) -> None:
    base = SamplerSpec(resolution=R, channels=C, tile_w=16, tile_h=8, k=16, kg=4, wu=64, wv=32)
    run("16x8 wv32 merged-shade", base, device)
    run("32x8 wv32 merged-shade", replace(base, tile_w=32), device)
    run("16x8 wv16 merged-shade", replace(base, wv=16), device)
    run("32x8 wv16 merged-shade", replace(base, tile_w=32, wv=16), device)


if __name__ == "__main__":
    main()
