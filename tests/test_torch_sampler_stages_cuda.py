"""S1 and S2's CUDA kernels (csrc/sampler_stages.cu) against their plain
PyTorch versions, S2 full as K2's own launch, and the wrappers' refusals.

Needs an NVIDIA GPU (marker ``cuda``; skipped without one) and imports no
JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_sampler_stages_cuda.py

Operands are prof_r5k.make_inputs' at the profiling size (R = 1024, 512²
rays in 16×8 tiles, k = 16, kg = 4, wu = 64, wv = 32) and at a small one
(R = 128, 8×8 tiles, k = 8, kg = 2, wu = 32, wv = 16). Tolerances: S1 1e-6
of its largest value (the same exact bf16 products summed in the same
order: 0 expected); win 1e-5 of its largest value (f32 sums of the features
in another order); shade 1e-5 relative above 1 and full 1e-5 (the head's
f32 sums in another order, K2b's and K2's limits); S2 full against K2 on
the same operands: equal (it launches K2, counted as K2).
"""
from __future__ import annotations

import pytest
import torch

from mere_fusion_tpu_torch.ops import sampler, sampler_stages
from mere_fusion_tpu_torch.scripts import prof_r5k

SIZES = {
    "profiling": dict(r=1024, rays=512 * 512, spec=dict(tile_w=16, tile_h=8, k=16, kg=4,
                                                         wu=64, wv=32)),
    "small": dict(r=128, rays=64 * 64, spec=dict(tile_w=8, tile_h=8, k=8, kg=2, wu=32, wv=16)),
}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def operands(dev, size, monkeypatch, wdtype=torch.bfloat16):
    """(spec, planes, jobs, uv, dproj, dtv, weights) from make_inputs."""
    cfg = SIZES[size]
    monkeypatch.setattr(prof_r5k, "R", cfg["r"])
    spec = sampler.SamplerSpec(resolution=cfg["r"], channels=12, **cfg["spec"])
    t = cfg["rays"] // spec.rays_per_tile
    gen = torch.Generator(device=dev).manual_seed(0)
    jobs, uv, dproj, dtv, weights, planes = prof_r5k.make_inputs(spec, t, gen, dev)
    weights = {k: w.to(wdtype) for k, w in weights.items()}
    return spec, planes, jobs, uv.reshape(3 * t, spec.kg, 2, spec.sg), dproj.to(wdtype), dtv, \
        weights


@pytest.mark.cuda
@pytest.mark.parametrize("blockdiag", [False, True])
@pytest.mark.parametrize("size", ["profiling", "small"])
def test_m1_only_matches_plain(cuda_device, monkeypatch, size, blockdiag):
    spec, planes, jobs, uv, *_ = operands(cuda_device, size, monkeypatch)
    before = sampler_stages.m1_launches
    out = sampler_stages.m1_only(planes, jobs, uv, spec, blockdiag)
    torch.cuda.synchronize()
    assert sampler_stages.m1_launches == before + 1
    ref = sampler_stages.m1_only_plain(planes, jobs, uv, spec, blockdiag)
    assert out.shape == ref.shape
    scale = ref.abs().max().item()
    assert scale > 1.0 and (out - ref).abs().max().item() <= 1e-6 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["win", "shade", "full"])
@pytest.mark.parametrize("size", ["profiling", "small"])
def test_sections_match_plain(cuda_device, monkeypatch, size, mode, wdtype):
    spec, planes, jobs, uv, dproj, dtv, weights = operands(cuda_device, size, monkeypatch,
                                                           wdtype)
    before = (sampler_stages.section_launches, sampler.launches)
    out = sampler_stages.sections(planes, jobs, uv, dproj, dtv, weights, spec, mode)
    torch.cuda.synchronize()
    launched = (1, 0) if mode != "full" else (0, 1)   # full is K2's launch
    assert (sampler_stages.section_launches, sampler.launches) == tuple(
        b + n for b, n in zip(before, launched))
    ref = sampler_stages.sections_plain(planes, jobs, uv, dproj, dtv, weights, spec, mode)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    diff = (out - ref).abs()
    if mode == "win":
        assert diff.max().item() <= 1e-5 * ref.abs().max().item()
    elif mode == "shade":
        assert (diff / ref.abs().clamp_min(1.0)).max().item() <= 1e-5
    else:
        assert diff.max().item() <= 1e-5 and ref[..., 0].max().item() > 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size", ["profiling", "small"])
def test_sections_full_equals_k2(cuda_device, monkeypatch, size, wdtype):
    spec, *ops = operands(cuda_device, size, monkeypatch, wdtype)
    before = (sampler_stages.section_launches, sampler.launches)
    full = sampler_stages.sections(*ops, spec, "full")
    torch.cuda.synchronize()
    assert (sampler_stages.section_launches, sampler.launches) == (before[0], before[1] + 1)
    k2 = sampler.sample_shade_comp_tiles(*ops, spec)
    torch.cuda.synchronize()
    assert torch.equal(full, k2)


@pytest.mark.cuda
def test_wrappers_raise(cuda_device, monkeypatch):
    spec, planes, jobs, uv, dproj, dtv, weights = operands(cuda_device, "small", monkeypatch)
    with pytest.raises(ValueError, match="CUDA"):
        sampler_stages.m1_only_cuda(planes.cpu(), jobs.cpu(), uv.cpu(), spec)
    with pytest.raises(ValueError, match="CUDA"):
        sampler_stages.sections_cuda(planes, jobs, uv.cpu(), dproj, dtv, weights, spec, "win")
    with pytest.raises(ValueError, match="CUDA"):
        sampler_stages.sections_cuda(planes, jobs, uv.cpu(), dproj, dtv, weights, spec, "full")
    with pytest.raises(ValueError, match="shape"):
        sampler_stages.m1_only(planes, jobs, uv[:-3], spec)
    with pytest.raises(TypeError, match="dtype"):
        sampler_stages.sections(planes, jobs, uv, dproj.float(), dtv, weights, spec, "shade")
    with pytest.raises(ValueError, match="mode"):
        sampler_stages.sections(planes, jobs, uv, dproj, dtv, weights, spec, "head")
