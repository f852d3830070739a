"""K2's CUDA kernel (csrc/sampler.cu) against its plain PyTorch version, and
the ER-NeRF frame step through it against the plain step.

Needs an NVIDIA GPU (marker ``cuda``; skipped without one) and imports no
JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_sampler_cuda.py

Tolerances: 1e-5 for both dtypes of shade weights. The kernel and the
plain version differ only in the order of the head's f32 sums, which read
3e-7 on the dense serving job set; with bfloat16 weights the plain version
without the bf16 rounding of activations must fail the same limit, so the
limit catches a kernel that drops that rounding. Frames within 1 LSB (the
ROADMAP rule). With bfloat16 weights K2's head runs on the tensor cores
(``sample_shade_comp_wgmma_kernel``, a grid of resident blocks looping over
tiles): it is held at both tile shapes, every depth grouping, a tile count
that leaves the last round of resident blocks partly filled, a sample count
that leaves the last 64-sample row block partly filled, and tiles with
empty rays. With float32 weights the head runs on the tensor cores as three
TF32 products a term (``sample_shade_comp_tf32_kernel``, 32-sample row
blocks): it is held at both tile shapes, every depth grouping, sample counts
that leave the last row block partly filled, and on the dense job set
against the same limit, which the plain version with single TF32 products
(``allow_tf32``) must fail.
"""
from __future__ import annotations

import os

import pytest
import torch

from chip_smoke import k2_operands, load_k2_dump   # chip_smoke's K2 operands
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.engines.nerf_step import make_render_step
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork, init_ernerf_
from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
from mere_fusion_tpu_torch.ops import sampler


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


SPECS = {
    "serving": dict(hw=512, spec=dict(resolution=1024, channels=12, tile_w=16, tile_h=8,
                                      k=16, kg=4, wu=64, wv=16)),
    "small": dict(hw=64, spec=dict(resolution=128, channels=4, tile_w=8, tile_h=8,
                                   k=8, kg=2, wu=32, wv=16)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("size", ["serving", "small"])
def test_kernel_matches_plain_on_gpu(cuda_device, wdtype, tol, size):
    spec = sampler.SamplerSpec(**SPECS[size]["spec"])
    ops = k2_operands(cuda_device, SPECS[size]["hw"], spec, wdtype)
    before = sampler.launches
    out = sampler.sample_shade_comp_tiles(*ops, spec)
    torch.cuda.synchronize()
    assert sampler.launches == before + 1
    ref = sampler.sample_shade_comp_tiles_plain(*ops, spec)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert float(ref[..., 0].max()) > 0.5, "the rays must be well occupied"
    assert (out - ref).abs().max().item() <= tol
    assert bool((out[..., 4:] == 0).all())
    if wdtype == torch.bfloat16:
        unrounded = sampler.sample_shade_comp_tiles_plain(
            *ops[:5], {k: w.float() for k, w in ops[5].items()}, spec)
        assert (unrounded - ref).abs().max().item() > tol


def kernel_names(fn) -> set:
    """Names of the CUDA kernels that fn launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.cuda
@pytest.mark.parametrize("kg", [1, 2, 4])
@pytest.mark.parametrize("tile", [(16, 8), (32, 8)])
def test_wgmma_head_geometries(cuda_device, tile, kg):
    """512 (16×8) or 256 (32×8) tiles of a 256² frame, k 16 in kg groups:
    the tile count is no multiple of the resident blocks (132 SMs, one
    block each), so the grid's last round is partly filled; a third of the
    tiles have half their rays empty (dt 0)."""
    spec = sampler.SamplerSpec(resolution=1024, channels=12, tile_w=tile[0], tile_h=tile[1],
                               k=16, kg=kg, wu=64, wv=32)
    planes, jobs, uv, dproj, dtv, weights = k2_operands(cuda_device, 256, spec, torch.bfloat16)
    dtv[::3, : spec.rays_per_tile // 2] = 0
    before = sampler.launches
    out = sampler.sample_shade_comp_tiles(planes, jobs, uv, dproj, dtv, weights, spec)
    torch.cuda.synchronize()
    assert sampler.launches == before + 1
    ref = sampler.sample_shade_comp_tiles_plain(planes, jobs, uv, dproj, dtv, weights, spec)
    assert bool(torch.isfinite(out).all()) and float(ref[..., 0].max()) > 0.5
    assert bool((out[::3, : spec.rays_per_tile // 2] == 0).all())
    err = (out - ref).abs().max().item()
    print(f"K2 bf16 {tile} kg {kg}: max abs err {err:.3e}")
    assert err <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k,kg", [(5, 1), (6, 3)])
def test_wgmma_head_partial_row_block(cuda_device, k, kg):
    """8×4 tiles of 32 rays: 160 samples a tile (k 5: row blocks of 64, 64
    and 32, the last padded) or 192 (k 6 in 3 groups: three row blocks, one
    for each warpgroup of a block)."""
    spec = sampler.SamplerSpec(resolution=128, channels=12, tile_w=8, tile_h=4, k=k, kg=kg,
                               wu=32, wv=16)
    ops = k2_operands(cuda_device, 64, spec, torch.bfloat16)
    out = sampler.sample_shade_comp_tiles(*ops, spec)
    ref = sampler.sample_shade_comp_tiles_plain(*ops, spec)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and float(ref[..., 0].max()) > 0.1
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kg", [1, 2, 4])
@pytest.mark.parametrize("tile", [(16, 8), (32, 8)])
def test_tf32_head_geometries(cuda_device, tile, kg):
    """K2 with f32 weights at both tile shapes and every depth grouping of
    k 16, as test_wgmma_head_geometries holds the bf16 kernel: the resident
    grid's last round partly filled, a third of the tiles with half their
    rays empty."""
    spec = sampler.SamplerSpec(resolution=1024, channels=12, tile_w=tile[0], tile_h=tile[1],
                               k=16, kg=kg, wu=64, wv=32)
    planes, jobs, uv, dproj, dtv, weights = k2_operands(cuda_device, 256, spec, torch.float32)
    dtv[::3, : spec.rays_per_tile // 2] = 0
    before = sampler.launches
    out = sampler.sample_shade_comp_tiles(planes, jobs, uv, dproj, dtv, weights, spec)
    torch.cuda.synchronize()
    assert sampler.launches == before + 1
    ref = sampler.sample_shade_comp_tiles_plain(planes, jobs, uv, dproj, dtv, weights, spec)
    assert bool(torch.isfinite(out).all()) and float(ref[..., 0].max()) > 0.5
    assert bool((out[::3, : spec.rays_per_tile // 2] == 0).all())
    err = (out - ref).abs().max().item()
    print(f"K2 f32 {tile} kg {kg}: max abs err {err:.3e}")
    assert err <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("tile,k,kg", [((4, 4), 5, 1), ((8, 4), 5, 1), ((8, 4), 6, 3)])
def test_tf32_head_partial_row_block(cuda_device, tile, k, kg):
    """Tiles of 80 samples (16 rays × 5: row blocks of 32, 32 and 16, the last
    padded), 160 and 192: the f32 head's 32-sample row blocks, a warp's
    second row tile partly or wholly empty."""
    spec = sampler.SamplerSpec(resolution=128, channels=12, tile_w=tile[0], tile_h=tile[1],
                               k=k, kg=kg, wu=32, wv=16)
    ops = k2_operands(cuda_device, 64, spec, torch.float32)
    out = sampler.sample_shade_comp_tiles(*ops, spec)
    ref = sampler.sample_shade_comp_tiles_plain(*ops, spec)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and float(ref[..., 0].max()) > 0.1
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["serving", "small"])
def test_f32_limit_fails_single_tf32_products(cuda_device, size):
    """The f32 kernel's limit of 1e-5 tells three TF32 products a term from
    one: the plain version with TF32 matmuls (single TF32 products) fails it
    on the same operands."""
    spec = sampler.SamplerSpec(**SPECS[size]["spec"])
    ops = k2_operands(cuda_device, SPECS[size]["hw"], spec, torch.float32)
    ref = sampler.sample_shade_comp_tiles_plain(*ops, spec)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        single = sampler.sample_shade_comp_tiles_plain(*ops, spec)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    got = sampler.sample_shade_comp_tiles(*ops, spec)
    assert (got - ref).abs().max().item() <= 1e-5 < (single - ref).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype,name", [(torch.bfloat16, "sample_shade_comp_wgmma_kernel"),
                                         (torch.float32, "sample_shade_comp_tf32_kernel")])
def test_weights_dtype_picks_the_kernel(cuda_device, wdtype, name):
    """bf16 weights take the wgmma kernel, f32 weights the 3×TF32 one."""
    spec = sampler.SamplerSpec(**SPECS["small"]["spec"])
    ops = k2_operands(cuda_device, 64, spec, wdtype)
    names = kernel_names(lambda: sampler.sample_shade_comp_tiles(*ops, spec))
    assert [n for n in names if "sample_shade_comp" in n] and all(
        name in n for n in names if "sample_shade_comp" in n), names


@pytest.mark.cuda
def test_tf32_head_refusals(cuda_device):
    """A tile whose samples do not fit the f32 block's shared memory raises
    before the launch."""
    spec = sampler.SamplerSpec(**SPECS["small"]["spec"])
    _, _, _, _, _, weights = k2_operands(cuda_device, 64, spec, torch.float32)
    planes = torch.zeros(3, 256, 128 * 16, dtype=torch.bfloat16, device=cuda_device)
    big = sampler.SamplerSpec(resolution=128, channels=4, tile_w=32, tile_h=8, k=32, kg=2,
                              wu=32, wv=16)
    assert sampler.tf32_smem_bytes(big) > sampler.SMEM_LIMIT
    t = 2
    with pytest.raises(ValueError, match="shared memory"):
        sampler.sample_shade_comp_tiles(
            planes, torch.zeros(t * 3 * (1 + 2 * big.kg), dtype=torch.int32, device=cuda_device),
            torch.zeros(3 * t, big.kg, 2, big.sg, device=cuda_device),
            torch.zeros(t, big.rays_per_tile, 64, device=cuda_device),
            torch.zeros(t, big.rays_per_tile, 8, device=cuda_device), weights, big)


@pytest.mark.cuda
def test_wgmma_head_refusals(cuda_device):
    """A tile whose samples do not fit the block's shared memory, and a
    dproj that is not 16-byte aligned, raise before the launch."""
    spec = sampler.SamplerSpec(**SPECS["small"]["spec"])
    planes, jobs, uv, dproj, dtv, weights = k2_operands(cuda_device, 64, spec, torch.bfloat16)
    big = sampler.SamplerSpec(resolution=128, channels=4, tile_w=32, tile_h=8, k=32, kg=2,
                              wu=32, wv=16)
    assert sampler.head_smem_bytes(big) > sampler.SMEM_LIMIT
    t = 64 * 64 // big.rays_per_tile
    with pytest.raises(ValueError, match="shared memory"):
        sampler.sample_shade_comp_tiles(
            planes, torch.zeros(t * 3 * (1 + 2 * big.kg), dtype=torch.int32, device=cuda_device),
            torch.zeros(3 * t, big.kg, 2, big.sg, device=cuda_device),
            torch.zeros(t, big.rays_per_tile, 64, dtype=torch.bfloat16, device=cuda_device),
            torch.zeros(t, big.rays_per_tile, 8, device=cuda_device), weights, big)
    shifted = torch.zeros(dproj.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:]
    shifted = shifted.view(dproj.shape).copy_(dproj)
    with pytest.raises(ValueError, match="16-byte aligned"):
        sampler.sample_shade_comp_tiles(planes, jobs, uv, shifted, dtv, weights, spec)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    spec = sampler.SamplerSpec(**SPECS["small"]["spec"])
    planes, jobs, uv, dproj, dtv, weights = k2_operands(cuda_device, 64, spec, torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        sampler.sample_shade_comp_tiles(planes, jobs, uv[:-3], dproj, dtv, weights, spec)
    with pytest.raises(TypeError):
        sampler.sample_shade_comp_tiles(planes.float(), jobs, uv, dproj, dtv, weights, spec)
    with pytest.raises(TypeError, match="one dtype"):
        sampler.sample_shade_comp_tiles(planes, jobs, uv, dproj.float(), dtv, weights, spec)
    with pytest.raises(ValueError, match="contiguous"):
        sampler.sample_shade_comp_tiles(planes, jobs, uv.transpose(2, 3).contiguous()
                                        .transpose(2, 3), dproj, dtv, weights, spec)
    with pytest.raises(ValueError, match="CUDA"):
        sampler.sample_shade_comp_tiles(planes, jobs.cpu(), uv, dproj, dtv, weights, spec)


@pytest.mark.cuda
def test_frame_step_matches_plain_on_gpu(cuda_device, tmp_path):
    from mere_fusion_tpu_torch.data.provider import NeRFTestDataset, synthesize_nerf_dataset
    from mere_fusion_tpu_torch.ops.triplane_bake import bake_triplanes

    d = synthesize_nerf_dataset(str(tmp_path), hw=128)
    ds = NeRFTestDataset.load(f"{d}/transforms.json", f"{d}/au.csv", scale=1.0)
    cfg = Config().override(**{"nerf.num_levels": 4, "nerf.base_resolution": 16,
                               "nerf.desired_resolution": 64, "nerf.grid_size": 16})
    net = init_ernerf_(NeRFNetwork(NeRFNetConfig(num_levels=4, base_resolution=16,
                                                 desired_resolution=64)).to(cuda_device), 0)
    with torch.no_grad():
        for n in ("plane_xy", "plane_yz", "plane_xz"):
            getattr(net, n).uniform_(-1, 1)
    baked = bake_triplanes({n: getattr(net, n) for n in ("plane_xy", "plane_yz", "plane_xz")},
                           net.cfg.plane_spec, 1.0, resolution=128, dtype=torch.bfloat16)
    steps = {impl: make_render_step(net, ds, cfg, baked, impl=impl) for impl in ("plain", "auto")}
    dens = DensityGrid.create(16, device=cuda_device)
    bg = torch.ones(128 * 128, 3, device=cuda_device)
    auds = torch.randn(8, 44, 16, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    frames, counts = {}, {}
    for impl, step in steps.items():
        before = sampler.launches
        frames[impl], _, _ = step(ds.poses[0], auds, ds.collate(0)["eye"], dens, bg, pose_key=0)
        torch.cuda.synchronize()
        counts[impl] = sampler.launches - before
    assert counts == {"plain": 0, "auto": 1}
    lsb = (frames["auto"].int() - frames["plain"].int()).abs().max().item()
    assert lsb <= 1 and float(frames["auto"].float().std()) > 2


@pytest.mark.cuda
def test_kernel_on_a_trained_avatars_miss(cuda_device):
    """The tile on which K2 once read 1.4e-5 against the plain version
    (tests/fixtures_torch, chip_smoke.dump_k2's file), within the limit since
    the plain version sums the eye logit in the kernel's order."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures_torch",
                        "k2_avatar_miss.pt")
    args, _, _ = load_k2_dump(path, cuda_device)
    got = sampler.sample_shade_comp_tiles(*args)
    torch.cuda.synchronize()
    assert (got - sampler.sample_shade_comp_tiles_plain(*args)).abs().max().item() <= 1e-5
