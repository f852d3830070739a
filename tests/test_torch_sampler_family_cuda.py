"""K2b, K2c and K2d's CUDA kernels (csrc/sampler.cu) against their plain
PyTorch versions, K2b and K2c against K2, and the wrappers' refusals.

Needs an NVIDIA GPU (marker ``cuda``; skipped without one) and imports no
JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_sampler_family_cuda.py

Operands are chip_smoke's dense frame (``k2_operands``, ``family_operands``)
at the serving size (512², 1024² planes, 16×8 tiles, k = 16) and a small one.
Tolerances: K2d 1e-6 (kernel and plain version round the same f32 products
and sums to bf16: equal but for values under 2^-17); K2b and K2c 1e-5
against their plain versions (f32 sums of the head in another order), the
limit K2 is held to, for K2b's per-sample σ = exp(logit) relative to values
above 1; K2b followed by the grouped composite within 2e-5 of K2
and K2c within 1e-4 of K2, the JAX package's own limits
(tests/test_pallas_sampler.py).
"""
from __future__ import annotations

import pytest
import torch

from chip_smoke import family_operands, k2_operands
from mere_fusion_tpu_torch.engines.nerf_step import composite_grouped
from mere_fusion_tpu_torch.ops import sampler


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


SPECS = {
    "serving": dict(hw=512, spec=dict(resolution=1024, channels=12, tile_w=16, tile_h=8,
                                      k=16, kg=4, wu=64, wv=16)),
    "small": dict(hw=64, spec=dict(resolution=128, channels=4, tile_w=8, tile_h=8,
                                   k=8, kg=2, wu=32, wv=16)),
}


def operands(dev, size, wdtype):
    spec = sampler.SamplerSpec(**SPECS[size]["spec"])
    ops = k2_operands(dev, SPECS[size]["hw"], spec, wdtype)
    return spec, ops, family_operands(dev, SPECS[size]["hw"], spec, ops)


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["serving", "small"])
def test_k2d_matches_plain(cuda_device, size):
    spec, (planes, jobs, uv, *_), _ = operands(cuda_device, size, torch.bfloat16)
    before = sampler.sample_launches
    out = sampler.sample_tiles(planes, jobs, uv, spec)
    torch.cuda.synchronize()
    assert sampler.sample_launches == before + 1
    ref = sampler.sample_tiles_plain(planes, jobs, uv, spec)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert (out.float() - ref.float()).abs().max().item() <= 1e-6
    assert float(ref.float().abs().max()) > 0.1
    # the pad lanes of every plane sample the planes' zero pad
    pad = out.reshape(*out.shape[:3], 3, sampler.CP)[..., spec.channels:]
    assert bool((pad == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", ["serving", "small"])
def test_k2b_matches_plain_and_composites_to_k2(cuda_device, size, wdtype):
    spec, ops, fam = operands(cuda_device, size, wdtype)
    planes, jobs, uv, _, dtv, weights = ops
    before = sampler.shade_launches
    out = sampler.sample_shade_tiles(planes, jobs, uv, fam["dproj128"], weights, spec)
    torch.cuda.synchronize()
    assert sampler.shade_launches == before + 1
    ref = sampler.sample_shade_tiles_plain(planes, jobs, uv, fam["dproj128"], weights, spec)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    # σ = exp(logit) is not bounded by 1: 1e-5 of each value above 1
    assert ((out - ref).abs() / ref.abs().clamp_min(1.0)).max().item() <= 1e-5
    assert bool((out[..., 4:] == 0).all())
    t, rpt, kg = out.shape[0], spec.rays_per_tile, spec.kg
    ks = spec.k // kg
    valid = (dtv[..., 0] > 0)[:, None, :, None].expand(t, kg, rpt, ks)
    image, ws = composite_grouped(out[..., 0].reshape(t, kg, rpt, ks),
                                  out[..., 1:4].reshape(t, kg, rpt, ks, 3), dtv[..., 0],
                                  valid, torch.zeros(t, rpt, 3, device=cuda_device))
    k2 = sampler.sample_shade_comp_tiles(*ops, spec)
    assert (ws - k2[..., 0]).abs().max().item() <= 2e-5
    assert (image - k2[..., 1:4]).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", ["serving", "small"])
def test_k2c_matches_plain_and_k2(cuda_device, size, wdtype):
    spec, ops, fam = operands(cuda_device, size, wdtype)
    planes, _, _, dproj, _, weights = ops
    before = sampler.rays_launches
    out = sampler.render_rays_tiles(planes, fam["jobs_rays"], fam["rays"], dproj, weights,
                                    spec, 1.0)
    torch.cuda.synchronize()
    assert sampler.rays_launches == before + 1
    ref = sampler.render_rays_tiles_plain(planes, fam["jobs_rays"], fam["rays"], dproj,
                                          weights, spec, 1.0)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert float(ref[..., 0].max()) > 0.5, "the rays must be well occupied"
    assert (out - ref).abs().max().item() <= 1e-5
    k2 = sampler.sample_shade_comp_tiles(*ops, spec)
    assert (out - k2).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_family_rejects_what_it_cannot_take(cuda_device):
    spec, ops, fam = operands(cuda_device, "small", torch.bfloat16)
    planes, jobs, uv, dproj, _, weights = ops
    with pytest.raises(ValueError, match="shape"):
        sampler.sample_tiles(planes, jobs, uv[:-3], spec)
    with pytest.raises(TypeError):
        sampler.sample_tiles(planes.float(), jobs, uv, spec)
    with pytest.raises(ValueError, match="CUDA"):
        sampler.sample_tiles_cuda(planes, jobs.cpu(), uv, spec)
    with pytest.raises(ValueError, match="shape"):
        sampler.sample_shade_tiles(planes, jobs, uv, dproj, weights, spec)   # 64 lanes, not 128
    with pytest.raises(TypeError, match="one dtype"):
        sampler.sample_shade_tiles(planes, jobs, uv, fam["dproj128"].float(), weights, spec)
    with pytest.raises(ValueError, match="CUDA"):
        sampler.sample_shade_tiles_cuda(planes.cpu(), jobs.cpu(), uv.cpu(),
                                        fam["dproj128"].cpu(), weights, spec)
    with pytest.raises(ValueError, match="shape"):
        sampler.render_rays_tiles(planes, jobs, fam["rays"], dproj, weights, spec, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        sampler.render_rays_tiles(planes, fam["jobs_rays"], fam["rays"].transpose(0, 1)
                                  .contiguous().transpose(0, 1), dproj, weights, spec, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        sampler.render_rays_tiles_cuda(planes, fam["jobs_rays"], fam["rays"].cpu(), dproj,
                                       weights, spec, 1.0)
