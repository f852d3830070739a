"""The rest of the triplane sampler family in the PyTorch port against the
JAX package, on the CPU at the JAX tests' toy spec (R = 128, C = 4, 4×4
tiles, k = 8, kg = 2, wu = 32, wv = 16): the planners ``plan_jobs``,
``plan_jobs_grouped`` and ``plan_jobs_rays``, ``enc_selector`` and
``regroup_features``; the plain versions of K2d (``sample_tiles``), K2b
(``sample_shade_tiles``) and K2c (``render_rays_tiles``) against the Pallas
kernels in interpret mode (as tests/test_pallas_sampler.py runs them); K2b
through the grouped composite and K2c against K2; K2d against the bilinear
``encode_x_baked``. K2b and K2c run on K2's tensor-core kernels: their
block's shared memory at ``Config()``'s spec, and the Stage tags that pick
their kernel instances apart.

Inputs come from numpy seeds. Tolerances, with their reasons:
- planner job tables: bit-equal against eager JAX (``jax.disable_jit``:
  under jit XLA divides by a reciprocal, ROADMAP §3); their coordinates as
  test_torch_nerf_ops.py::test_plan_jobs_span_matches_jax holds them
  (bit-equal);
- K2d: one bf16 rounding (2^-8 of the value): the same f32 features, summed
  in another order by the TPU kernel's lane fold, rounded to bf16;
- K2b and K2c against Pallas: 1e-4 (the JAX package's limit for K2c; the
  head's f32 sums in another order), for K2b's per-sample σ = exp(logit),
  which reaches ~1e6 on random weights, 1e-4 of each value;
- K2b + grouped composite against K2: 2e-5; K2c against K2 on the span
  plan: 1e-4 (the JAX package's own limits, tests/test_pallas_sampler.py);
- K2d against ``encode_x_baked`` bilinear: 0.06 (the JAX test's: bf16
  planes of values up to ~4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.engines.nerf_pallas import _composite_grouped as j_composite_grouped
from mere_fusion_tpu.ops import pallas_sampler as jsamp
from mere_fusion_tpu.ops.triplane_bake import encode_x_baked as j_encode_x_baked
from mere_fusion_tpu_torch.engines.nerf_step import composite_grouped
from mere_fusion_tpu_torch.ops import sampler as psamp
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

SAMPLER = dict(resolution=128, channels=4, tile_w=4, tile_h=4, k=8, kg=2, wu=32, wv=16)
JSPEC, PSPEC = jsamp.SamplerSpec(**SAMPLER), psamp.SamplerSpec(**SAMPLER)
BOUND = 1.0
SHAPES = {"wx_aud": (48, 64), "w_aud1": (64, 32), "wx_sig": (48, 64),
          "w_aud_sig": (32, 64), "wx_eye": (48, 16), "w_eye1": (16, 8),
          "w_sig_e": (8, 64), "w_sig1": (64, 64), "w_sigcol": (64, 16),
          "w_geo": (64, 64), "w_col_g": (64, 64), "w_rgb": (64, 16),
          "col_bias": (8, 64)}


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def sample_geometry(seed: int = 0, t: int = 6):
    """Planes and tile-major sample positions marching forward in z, whose
    depth groups fit the windows (tests/test_pallas_sampler.py's make_setup)."""
    rng = np.random.default_rng(seed)
    r, c = SAMPLER["resolution"], SAMPLER["channels"]
    planes = {n: rng.standard_normal((r, r, c)).astype(np.float32)
              for n in ("plane_xy", "plane_yz", "plane_xz")}
    rpt, k, tw = PSPEC.rays_per_tile, PSPEC.k, PSPEC.tile_w
    xyz = np.empty((t, rpt, k, 3), np.float32)
    for i in range(t):
        ox, oy = rng.uniform(-0.7, 0.5, 2)
        oz = rng.uniform(-0.7, 0.2)
        for rix in range(rpt):
            jx, jy = rix % tw, rix // tw
            x0 = ox + 0.02 * jx + rng.uniform(0, 0.01)
            y0 = oy + 0.02 * jy + rng.uniform(0, 0.01)
            zs = oz + np.linspace(0, 0.45, k) + rng.uniform(0, 0.01)
            xyz[i, rix, :, 0] = x0 + 0.05 * (zs - oz)
            xyz[i, rix, :, 1] = y0 + 0.03 * (zs - oz)
            xyz[i, rix, :, 2] = zs
    valid = rng.random((t, rpt, k)) < 0.9
    valid[0] = True
    return planes, xyz, valid


def ray_geometry(seed: int = 1, t: int = 6):
    """Per-ray (o, d, zmin, zmax, valid) of tiles marching into the box
    (tests/test_pallas_sampler.py's rays test), one tile with wide spans."""
    rpt, tw = PSPEC.rays_per_tile, PSPEC.tile_w
    rng = np.random.default_rng(seed)
    o = np.empty((t, rpt, 3), np.float32)
    d = np.empty((t, rpt, 3), np.float32)
    for i in range(t):
        ox, oy = rng.uniform(-0.6, 0.4, 2)
        for r_ in range(rpt):
            jx, jy = r_ % tw, r_ // tw
            o[i, r_] = [ox + 0.02 * jx, oy + 0.02 * jy, rng.uniform(-0.7, -0.3)]
            v = np.array([0.05 + 0.002 * jx, 0.03, 1.0])
            d[i, r_] = v / np.linalg.norm(v)
    zmin = rng.uniform(0.05, 0.15, (t, rpt)).astype(np.float32)
    va = rng.random((t, rpt)) < 0.85
    span = rng.uniform(0.3, 0.5, (t, rpt)).astype(np.float32) * va
    span[0, :4] = 1.6 * va[0, :4]        # a wide group: a coarser mip
    return o, d, zmin, (zmin + span).astype(np.float32), va


def shade_inputs(seed: int, t: int):
    """Seeded bf16 mip-stack planes, shade weights and direction projections."""
    rng = np.random.default_rng(seed)
    planes = np.asarray(jnp.asarray(rng.standard_normal(
        (3, PSPEC.mip_rows[-1], PSPEC.resolution * 16)), jnp.bfloat16).astype(jnp.float32))
    weights = {k: (0.3 * rng.standard_normal(SHAPES[k])).astype(np.float32)
               for k in psamp.SHADE_WEIGHTS}
    proj = rng.standard_normal((t, PSPEC.rays_per_tile, 64)).astype(np.float32)
    return planes, weights, proj


def random_jobs(rng, t: int):
    """Random in-range (ou, ov) jobs and texel coordinates, as
    tests/test_pallas_sampler.py makes them for the shade kernels."""
    j, kg = 3 * t, PSPEC.kg
    scal = np.zeros((j, 1 + 2 * kg), np.int32)
    scal[:, 0] = np.tile(np.arange(3), t)
    for g in range(kg):
        scal[:, 1 + 2 * g] = rng.integers(0, 64, j) & ~7
        scal[:, 2 + 2 * g] = rng.integers(0, 64, j) & ~7
    uv = rng.uniform(8, 100, (j, kg, 2, PSPEC.sg)).astype(np.float32)
    return scal.reshape(-1), uv


def weights_of(weights, dtype):
    return ({k: jnp.asarray(v, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
             for k, v in weights.items()},
            {k: t_(v).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
             for k, v in weights.items()})


def test_classic_planners_match_eager_jax():
    _, xyz, valid = sample_geometry()
    t = xyz.shape[0]
    with jax.disable_jit():
        sj, uj, aj, oj = jsamp.plan_jobs(jnp.asarray(xyz.reshape(t, -1, 3)),
                                         jnp.asarray(valid), JSPEC, BOUND)
    sp, up, ap, op = psamp.plan_jobs(t_(xyz.reshape(t, -1, 3)), t_(valid), PSPEC, BOUND)
    assert sp.dtype == torch.int32 and tuple(sp.shape) == (t, 3, 1 + 2 * PSPEC.kg)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(up.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
    # the grouped planner on a wide footprint (coarser mips) and a sparse tile
    xyz_g = xyz.reshape(t, PSPEC.rays_per_tile, PSPEC.kg, -1, 3).transpose(0, 2, 1, 3, 4)
    xyz_g = np.ascontiguousarray(xyz_g.reshape(t, PSPEC.kg, PSPEC.sg, 3))
    xyz_g[2, 0, -1, 2] = 0.9
    valid_g = np.ones((t, PSPEC.kg, PSPEC.sg), bool)
    valid_g[3] = False
    with jax.disable_jit():
        ref = jsamp.plan_jobs_grouped(jnp.asarray(xyz_g), jnp.asarray(valid_g), JSPEC, BOUND)
    got = psamp.plan_jobs_grouped(t_(xyz_g), t_(valid_g), PSPEC, BOUND)
    assert int(np.asarray(ref[0])[2, :, 1::2].max()) >= PSPEC.mip_rows[1]   # a coarser mip
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert not bool(got[2][3])


def test_plan_jobs_rays_matches_eager_jax():
    o, d, zmin, zmax, va = ray_geometry()
    with jax.disable_jit():
        sj, oj = jsamp.plan_jobs_rays(*map(jnp.asarray, (o, d, zmin, zmax, va)), JSPEC, BOUND)
    sp, op = psamp.plan_jobs_rays(*map(t_, (o, d, zmin, zmax, va)), PSPEC, BOUND)
    assert sp.dtype == torch.int32 and tuple(sp.shape) == (6, 3, 1 + 4 * PSPEC.kg)
    assert len(set(sp[..., 3::4].reshape(-1).tolist())) > 1          # several mip levels
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
    # its windows are plan_jobs_span's
    ss, _, _ = psamp.plan_jobs_span(*map(t_, (o, d, zmin, zmax, va)), PSPEC, BOUND)
    np.testing.assert_array_equal(sp[..., 1::4].numpy(), ss[..., 1::2].numpy())


def test_enc_selector_and_regroup_match_jax():
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((3, PSPEC.kg, PSPEC.sg, 3 * 16)).astype(np.float32)
    np.testing.assert_array_equal(psamp.enc_selector(PSPEC, torch.float32).numpy(),
                                  np.asarray(jsamp.enc_selector(JSPEC, jnp.float32)))
    np.testing.assert_array_equal(psamp.regroup_features(t_(feats), PSPEC).numpy(),
                                  np.asarray(jsamp.regroup_features(jnp.asarray(feats), JSPEC)))


@pytest.fixture(scope="module")
def k2d_pair():
    """K2d's plain version and the Pallas kernel on the planned sample geometry."""
    planes, xyz, valid = sample_geometry()
    t = xyz.shape[0]
    scal, uv, _, overflow = psamp.plan_jobs(t_(xyz.reshape(t, -1, 3)), t_(valid), PSPEC, BOUND)
    assert not bool(overflow.any()), "the geometry must fit the windows"
    jobs, uv = scal.reshape(-1), uv.reshape(3 * t, PSPEC.kg, 2, PSPEC.sg)
    packed = psamp.pack_planes_major({k: t_(v) for k, v in planes.items()}, PSPEC)
    ref = jsamp.sample_tiles(jnp.asarray(packed.float().numpy(), jnp.bfloat16),
                             jnp.asarray(jobs.numpy()), jnp.asarray(uv.numpy()), JSPEC,
                             interpret=True)
    before = psamp.sample_launches
    got = psamp.sample_tiles(packed, jobs, uv, PSPEC)
    assert psamp.sample_launches == before, "a CPU tensor must take the plain version"
    return planes, xyz, valid, got, np.asarray(ref.astype(jnp.float32))


def test_k2d_plain_matches_pallas_interpret(k2d_pair):
    *_, got, ref = k2d_pair
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = np.abs(got.float().numpy() - ref)
    assert (err <= 2.0 ** -8 * np.abs(ref)).all(), err.max()
    assert np.abs(ref).max() > 1


def test_k2d_plain_matches_bilinear_encode(k2d_pair):
    planes, xyz, valid, got, _ = k2d_pair
    t = xyz.shape[0]
    enc = psamp.regroup_features(got.float(), PSPEC).numpy()
    ref = np.asarray(j_encode_x_baked({k: jnp.asarray(v) for k, v in planes.items()},
                                      jnp.asarray(xyz.reshape(-1, 3)), BOUND, "bilinear"))
    ref = ref.reshape(t, PSPEC.rays_per_tile, PSPEC.k, 3 * PSPEC.channels)
    err = np.abs(enc - ref) * valid[..., None]
    assert err.max() < 0.06, err.max()


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_k2b_plain_matches_pallas_and_composites_to_k2(wdtype):
    t = 5
    rng = np.random.default_rng(0)
    jobs, uv = random_jobs(rng, t)
    planes, weights, proj = shade_inputs(3, t)
    jw, pw = weights_of(weights, wdtype)
    dproj = np.concatenate([proj, np.zeros_like(proj)], axis=-1)
    ref = np.asarray(jsamp.sample_shade_tiles(
        jnp.asarray(planes, jnp.bfloat16), jnp.asarray(jobs), jnp.asarray(uv),
        jnp.asarray(dproj), jw, JSPEC, interpret=True))
    pl_ = t_(planes).to(torch.bfloat16)
    before = psamp.shade_launches
    got = psamp.sample_shade_tiles(pl_, t_(jobs), t_(uv), t_(dproj), pw, PSPEC)
    assert psamp.shade_launches == before, "a CPU tensor must take the plain version"
    assert got.shape == ref.shape == (t, PSPEC.kg * PSPEC.sg, 16)
    # σ = exp(logit) reaches ~1e6 on these inputs: 1e-4 of each value
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert (got[..., 4:] == 0).all()
    # through the grouped composite, against K2 on the same operands
    rpt, kg = PSPEC.rays_per_tile, PSPEC.kg
    ks = PSPEC.k // kg
    dt = rng.uniform(0.05, 0.4, (t, rpt)).astype(np.float32)
    va = rng.random((t, rpt)) < 0.85
    dtv = np.pad((dt * va)[..., None], ((0, 0), (0, 0), (0, 7))).astype(np.float32)
    valid_g = t_(va)[:, None, :, None].expand(t, kg, rpt, ks)
    sig, col = got[..., 0].reshape(t, kg, rpt, ks), got[..., 1:4].reshape(t, kg, rpt, ks, 3)
    image, ws = composite_grouped(sig, col, t_(dt), valid_g, torch.zeros(t, rpt, 3))
    j_image, j_ws = j_composite_grouped(jnp.asarray(sig.numpy()), jnp.asarray(col.numpy()),
                                        jnp.asarray(dt), jnp.asarray(valid_g.numpy()),
                                        jnp.zeros((t, rpt, 3)))
    np.testing.assert_allclose(ws.numpy(), np.asarray(j_ws), rtol=0, atol=1e-6)
    np.testing.assert_allclose(image.numpy(), np.asarray(j_image), rtol=0, atol=1e-6)
    k2 = psamp.sample_shade_comp_tiles(pl_, t_(jobs), t_(uv), t_(proj), t_(dtv), pw, PSPEC)
    assert float(k2[..., 0].max()) > 0.5, "the rays must be well occupied"
    np.testing.assert_allclose(ws.numpy(), k2[..., 0].numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(image.numpy(), k2[..., 1:4].numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_k2c_plain_matches_pallas_and_k2(wdtype):
    o, d, zmin, zmax, va = ray_geometry()
    t = o.shape[0]
    planes, weights, proj = shade_inputs(4, t)
    jw, pw = weights_of(weights, wdtype)
    rays = np.concatenate([o, d, zmin[..., None], zmax[..., None]], -1)
    with jax.disable_jit():
        sj, _ = jsamp.plan_jobs_rays(*map(jnp.asarray, (o, d, zmin, zmax, va)), JSPEC, BOUND)
    ref = np.asarray(jsamp.render_rays_tiles(
        jnp.asarray(planes, jnp.bfloat16), sj.reshape(-1), jnp.asarray(rays),
        jnp.asarray(proj), jw, JSPEC, BOUND, interpret=True))
    pl_ = t_(planes).to(torch.bfloat16)
    jobs, _ = psamp.plan_jobs_rays(*map(t_, (o, d, zmin, zmax, va)), PSPEC, BOUND)
    before = psamp.rays_launches
    got = psamp.render_rays_tiles(pl_, jobs.reshape(-1), t_(rays), t_(proj), pw, PSPEC, BOUND)
    assert psamp.rays_launches == before, "a CPU tensor must take the plain version"
    assert got.shape == ref.shape == (t, PSPEC.rays_per_tile, 16)
    assert ref[..., 0].max() > 0.5, "the rays must be well occupied"
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    # against K2 on the span plan over the same rays
    scal, uv, _ = psamp.plan_jobs_span(*map(t_, (o, d, zmin, zmax, va)), PSPEC, BOUND)
    dtv = torch.nn.functional.pad(((t_(zmax) - t_(zmin)) / PSPEC.k)[..., None], (0, 7))
    k2 = psamp.sample_shade_comp_tiles(pl_, scal.reshape(-1), uv.reshape(3 * t, PSPEC.kg, 2,
                                                                          PSPEC.sg),
                                       t_(proj), dtv, pw, PSPEC)
    np.testing.assert_allclose(got.numpy(), k2.numpy(), rtol=0, atol=1e-4)


def test_family_cuda_paths_refuse_cpu_operands():
    t = 2
    jobs, uv = random_jobs(np.random.default_rng(5), t)
    planes, weights, proj = shade_inputs(5, t)
    pl_, pw = t_(planes).to(torch.bfloat16), weights_of(weights, "bfloat16")[1]
    with pytest.raises(ValueError, match="CUDA"):
        psamp.sample_tiles_cuda(pl_, t_(jobs), t_(uv), PSPEC)
    with pytest.raises(ValueError, match="CUDA"):
        psamp.sample_shade_tiles_cuda(pl_, t_(jobs), t_(uv), t_(np.pad(proj, ((0, 0), (0, 0),
                                                                                 (0, 64)))),
                                      pw, PSPEC)
    rays = torch.zeros(t, PSPEC.rays_per_tile, 8)
    with pytest.raises(ValueError, match="CUDA"):
        psamp.render_rays_tiles_cuda(pl_, torch.zeros(t * 3 * (1 + 4 * PSPEC.kg),
                                                      dtype=torch.int32),
                                     rays, t_(proj).to(torch.bfloat16), pw, PSPEC, BOUND)


def config_spec() -> psamp.SamplerSpec:
    """The sampler spec of ``Config()``'s ER-NeRF frame (as chip_smoke's k2_spec)."""
    from mere_fusion_tpu_torch.config import Config

    nc = Config().nerf
    return psamp.SamplerSpec(resolution=min(1024, 2 * nc.desired_resolution),
                             channels=nc.num_levels * nc.level_dim, tile_w=nc.pallas_tile_w,
                             tile_h=nc.pallas_tile_h, k=nc.max_steps,
                             kg=nc.pallas_depth_groups, wu=nc.pallas_window_u,
                             wv=nc.pallas_window_v)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_k2b_k2c_blocks_fit_shared_memory(wdtype):
    """K2b and K2c run on K2's block (its tensor-core kernels' shared memory:
    bf16 weights 156,928 B, f32 199,232 B at the default 16×8 tiles of 16
    samples), which fits a block's 232,448 B; a tile of 256 rays × 32 samples
    does not, and the wrappers refuse it before a launch."""
    import dataclasses

    spec = config_spec()
    want = {torch.bfloat16: 156928, torch.float32: 199232}[wdtype]
    assert psamp.block_smem_bytes(spec, wdtype) == want <= psamp.SMEM_LIMIT
    big = dataclasses.replace(spec, tile_w=32, tile_h=8, k=32)
    assert psamp.block_smem_bytes(big, wdtype) > psamp.SMEM_LIMIT


def test_k2d_block_fits_shared_memory():
    """K2d's block (csrc/sampler.cu k2d_smem: two buffers of a tile's job
    table and one depth group's uv rows) takes 25,280 B at the default 16×8
    tiles of 16 samples in 4 groups, so two blocks and most of L1 share an
    SM; 512 rays × 32 samples in 2 groups do not fit a block's 232,448 B,
    and the wrapper refuses them before a launch, before it even looks at
    the operands."""
    import dataclasses

    spec = config_spec()
    assert psamp.k2d_smem_bytes(spec) == 25280 <= psamp.SMEM_LIMIT
    big = dataclasses.replace(spec, tile_w=32, tile_h=16, k=32, kg=2)
    assert psamp.k2d_smem_bytes(big) > psamp.SMEM_LIMIT
    jobs, uv = random_jobs(np.random.default_rng(5), 2)
    planes = t_(shade_inputs(5, 2)[0]).to(torch.bfloat16)
    before = psamp.sample_launches
    with pytest.raises(ValueError, match="shared memory"):
        psamp.sample_tiles_cuda(planes, t_(jobs), t_(uv), big)
    assert psamp.sample_launches == before


def test_instance_tags_name_the_stages_of_the_kernels():
    """K2, K2b and K2c's instances of K2's kernels are told apart by their
    template argument, csrc/sampler_core.cuh's Stage, in the mangled name:
    ops/sampler.py STAGES follows the enum's order."""
    import re

    with open(psamp.CORE_HEADER) as f:
        enum = re.search(r"enum Stage \{([^}]*)\}", f.read()).group(1)
    order = [v.strip() for v in enum.split(",")]
    for kernel, stage in (("K2", "STAGE_FULL"), ("K2b", "STAGE_ROWS"), ("K2c", "STAGE_RAYS")):
        assert psamp.STAGES[kernel] == order.index(stage)
    assert psamp.instance_tag("K2b", "bfloat16") == "sample_shade_comp_wgmma_kernelILi3E"
    assert psamp.instance_tag("K2c", "float32") == "sample_shade_comp_tf32_kernelILi4E"
    assert len({psamp.instance_tag(k, d) for k in psamp.STAGES
                for d in psamp.KERNEL_NAMES}) == 6
