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

K2b and K2c are instances of K2's two tensor-core kernels (bf16 weights:
``sample_shade_comp_wgmma_kernel``, 64-sample row blocks; f32 weights:
``sample_shade_comp_tf32_kernel``, 32-sample row blocks a warp), so they are
held at the geometries tests/test_torch_sampler_cuda.py holds K2 at: both
tile shapes and every depth grouping of k 16 on a 256² frame (the resident
grid's last round partly filled, a third of the tiles with half their rays
empty), and tiles whose last row block is partly filled; a tile too large
for the block's shared memory raises before the launch.

K2d's resident-grid kernel is held bit-equal to its plain version at the
fetch-only kernels' geometries (``test_torch_sampler_stages_cuda.
FETCH_GEOMETRIES``: kg 1, 2, 4 and 8, partial tiles, sg not a multiple of 4)
on job tables whose windows cross the planes' edges, and a tile whose block
does not fit the shared memory raises before the launch.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from chip_smoke import family_operands, k2_operands
from mere_fusion_tpu_torch.engines.nerf_step import composite_grouped
from mere_fusion_tpu_torch.ops import sampler
from tests.test_torch_sampler_stages_cuda import FETCH_GEOMETRIES, fetch_operands, fetch_spec


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


def check_k2b_k2c(dev, spec, hw, wdtype, empty_rays=False):
    """One launch each of K2b and K2c on a dense frame of hw² rays at spec,
    against their plain versions: 1e-5, K2b's relative to values above 1.
    empty_rays: a third of the tiles with half their rays empty (zmax ==
    zmin, so K2c composites nothing there)."""
    ops = k2_operands(dev, hw, spec, wdtype)
    fam = family_operands(dev, hw, spec, ops)
    planes, jobs, uv, dproj, _, weights = ops
    rays, half = fam["rays"], spec.rays_per_tile // 2
    if empty_rays:
        rays[::3, :half, 7] = rays[::3, :half, 6]
    before = (sampler.shade_launches, sampler.rays_launches)
    rows = sampler.sample_shade_tiles(planes, jobs, uv, fam["dproj128"], weights, spec)
    comp = sampler.render_rays_tiles(planes, fam["jobs_rays"], rays, dproj, weights, spec, 1.0)
    torch.cuda.synchronize()
    assert (sampler.shade_launches, sampler.rays_launches) == (before[0] + 1, before[1] + 1)
    ref_rows = sampler.sample_shade_tiles_plain(planes, jobs, uv, fam["dproj128"], weights, spec)
    ref_comp = sampler.render_rays_tiles_plain(planes, fam["jobs_rays"], rays, dproj, weights,
                                               spec, 1.0)
    assert bool(torch.isfinite(rows).all()) and bool(torch.isfinite(comp).all())
    assert bool((rows[..., 4:] == 0).all()) and float(ref_comp[..., 0].max()) > 0.1
    if empty_rays:
        assert bool((comp[::3, :half] == 0).all())
    err_rows = ((rows - ref_rows).abs() / ref_rows.abs().clamp_min(1.0)).max().item()
    err_comp = (comp - ref_comp).abs().max().item()
    print(f"K2b {err_rows:.3e}, K2c {err_comp:.3e} ({wdtype}, {spec})")
    assert err_rows <= 1e-5 and err_comp <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kg", [1, 2, 4])
@pytest.mark.parametrize("tile", [(16, 8), (32, 8)])
def test_k2b_k2c_geometries(cuda_device, tile, kg, wdtype):
    """512 (16×8) or 256 (32×8) tiles of a 256² frame, k 16 in kg groups,
    as tests/test_torch_sampler_cuda.py holds K2 with either weight dtype."""
    spec = sampler.SamplerSpec(resolution=1024, channels=12, tile_w=tile[0], tile_h=tile[1],
                               k=16, kg=kg, wu=64, wv=32)
    check_k2b_k2c(cuda_device, spec, 256, wdtype, empty_rays=True)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile,k,kg", [((4, 4), 5, 1), ((8, 4), 5, 1), ((8, 4), 6, 3)])
def test_k2b_k2c_partial_row_block(cuda_device, tile, k, kg, wdtype):
    """Tiles of 80, 160 and 192 samples: the bf16 kernel's 64-sample row
    blocks (160: 64, 64 and a padded 32; 192: one for each warpgroup) and the
    f32 kernel's 32-sample ones (80: a padded 16), as K2 is held."""
    spec = sampler.SamplerSpec(resolution=128, channels=12, tile_w=tile[0], tile_h=tile[1],
                               k=k, kg=kg, wu=32, wv=16)
    check_k2b_k2c(cuda_device, spec, 64, wdtype)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_k2b_k2c_refuse_a_tile_too_large_for_the_block(cuda_device, wdtype):
    """K2b and K2c need K2's block: a tile of 256 rays × 32 samples does not
    fit its shared memory with either weight dtype and raises before the
    launch."""
    spec = sampler.SamplerSpec(**SPECS["small"]["spec"])
    weights = k2_operands(cuda_device, 64, spec, wdtype)[5]
    big = dataclasses.replace(spec, tile_w=32, tile_h=8, k=32, kg=2)
    assert sampler.block_smem_bytes(big, wdtype) > sampler.SMEM_LIMIT
    t, rpt, dev = 2, big.rays_per_tile, cuda_device
    planes = torch.zeros(3, 256, 128 * 16, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        sampler.sample_shade_tiles(
            planes, torch.zeros(t * 3 * (1 + 2 * big.kg), dtype=torch.int32, device=dev),
            torch.zeros(3 * t, big.kg, 2, big.sg, device=dev),
            torch.zeros(t, rpt, 128, dtype=wdtype, device=dev), weights, big)
    with pytest.raises(ValueError, match="shared memory"):
        sampler.render_rays_tiles(
            planes, torch.zeros(t * 3 * (1 + 4 * big.kg), dtype=torch.int32, device=dev),
            torch.zeros(t, rpt, 8, device=dev), torch.zeros(t, rpt, 64, dtype=wdtype, device=dev),
            weights, big, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", FETCH_GEOMETRIES)
def test_k2d_geometries_and_clamps(cuda_device, geometry):
    """300 tiles (more than one round of the resident grid) at each geometry,
    bit-equal to the plain version with the windows' clamps taken."""
    spec = fetch_spec(*geometry)
    planes, jobs, uv = fetch_operands(cuda_device, spec, 300)
    before = sampler.sample_launches
    out = sampler.sample_tiles(planes, jobs, uv, spec)
    torch.cuda.synchronize()
    assert sampler.sample_launches == before + 1
    ref = sampler.sample_tiles_plain(planes, jobs, uv, spec)
    assert out.shape == ref.shape and float(ref.float().abs().max()) > 1.0
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_k2d_refuses_a_block_that_does_not_fit(cuda_device):
    """512 rays × 32 samples in 2 groups: a group's uv rows of 8,196 floats,
    6 of them twice over, more than a block's shared memory; raises before
    the launch."""
    spec = fetch_spec(32, 16, 32, 2)
    assert sampler.k2d_smem_bytes(spec) > sampler.SMEM_LIMIT
    planes, jobs, uv = fetch_operands(cuda_device, spec, 2)
    before = sampler.sample_launches
    with pytest.raises(ValueError, match="shared memory"):
        sampler.sample_tiles(planes, jobs, uv, spec)
    assert sampler.sample_launches == before
