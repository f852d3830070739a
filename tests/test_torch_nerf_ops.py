"""The ER-NeRF serving slice's modules in the PyTorch port against their JAX
twins, on the CPU at toy sizes: encoders, hash grid, the network, the
converter, baking, the renderer's geometry, the tile/planning helpers, the
shade-weight packing and kernel K2's plain version against the Pallas
kernel in interpret mode (as tests/test_pallas_sampler.py runs it).

Inputs come from numpy seeds; weights from the JAX init through
``convert.ernerf_from_flax``. Tolerances, with their reasons:
- elementwise encoders, geometry, gathers, planning: exact or a few f32
  ulps (the same ops in the same order);
- MLP heads: 2e-5 (ROADMAP rule; matmul summation order differs);
- K2 with float32 weights: 2e-5 (summation order of the head's products);
  with bfloat16 weights 1e-5, which the plain version without the bf16
  rounding of activations fails on the same inputs; a model of the
  tensor-core head's order (f32 sums in k16 chunks) within the same 1e-5.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.models.ernerf import renderer as jrend
from mere_fusion_tpu.models.ernerf.network import NeRFNetConfig as JNetConfig
from mere_fusion_tpu.models.ernerf.network import NeRFNetwork as JNetwork
from mere_fusion_tpu.ops import encoders as jenc
from mere_fusion_tpu.ops import hashgrid as jhash
from mere_fusion_tpu.ops import pallas_sampler as jsamp
from mere_fusion_tpu.ops import triplane_bake as jbake
from mere_fusion_tpu_torch.convert import density_from_flax, ernerf_from_flax
from mere_fusion_tpu_torch.models.ernerf import renderer as prend
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork
from mere_fusion_tpu_torch.ops import encoders as penc
from mere_fusion_tpu_torch.ops import hashgrid as phash
from mere_fusion_tpu_torch.ops import sampler as psamp
from mere_fusion_tpu_torch.ops import triplane_bake as pbake
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

NET = dict(num_levels=4, base_resolution=16, desired_resolution=64, log2_hashmap_size=10)
SAMPLER = dict(resolution=128, channels=4, tile_w=4, tile_h=4, k=8, kg=2, wu=32, wv=16)
BOUND = 1.0


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def nets():
    """(JAX network, its variables, the port's network with those weights)."""
    jnet = JNetwork(JNetConfig(**NET))
    variables = jax.jit(jnet.init, static_argnames="method")(
        jax.random.key(0), jnp.zeros((8, 44, 16)), jnp.zeros((4, 3)),
        jnp.ones((4, 3)) / np.sqrt(3.0), jnp.zeros((1, 4)), jnp.zeros((1, 1)),
        method=JNetwork.full_init)
    # hash tables at init are ±1e-4; widen them so feature errors show
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    for name in ("plane_xy", "plane_yz", "plane_xz"):
        params[name] = rng.uniform(-1, 1, params[name].shape).astype(np.float32)
    variables = {"params": params}
    cfg = NeRFNetConfig(**NET)
    pnet = NeRFNetwork(cfg)
    pnet.load_state_dict(ernerf_from_flax(variables, cfg), strict=True)
    return jnet, variables, pnet.eval()


def test_sh_and_freq_encode_match_jax():
    d = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for deg in (1, 2, 3, 4):
        np.testing.assert_allclose(penc.sh_encode(t_(d), deg).numpy(),
                                   np.asarray(jenc.sh_encode(jnp.asarray(d), deg)),
                                   rtol=0, atol=2e-7)
    np.testing.assert_allclose(penc.freq_encode(t_(d), 4).numpy(),
                               np.asarray(jenc.freq_encode(jnp.asarray(d), 4)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("gridtype", ["hash", "tiled"])
def test_grid_encode_matches_jax(gridtype):
    kw = dict(input_dim=2, num_levels=6, level_dim=2, base_resolution=8,
              log2_hashmap_size=8, desired_resolution=256, gridtype=gridtype)
    jspec, pspec = jhash.GridSpec(**kw), phash.GridSpec(**kw)
    assert pspec.level_params() == jspec.level_params()
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (500, 2)).astype(np.float32)
    table = rng.standard_normal((pspec.total_params, 2)).astype(np.float32)
    ji, jw = jhash.corner_indices_weights(jnp.asarray(x), jspec, BOUND)
    pi, pw = phash.corner_indices_weights(t_(x), pspec, BOUND)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji).astype(np.int64))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(
        phash.grid_encode(t_(table), t_(x), pspec, BOUND).numpy(),
        np.asarray(jhash.grid_encode(jnp.asarray(table), jnp.asarray(x), jspec, BOUND)),
        rtol=0, atol=2e-6)


def test_network_matches_jax(nets):
    jnet, variables, pnet = nets
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
    d = rng.standard_normal((128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    auds = rng.standard_normal((8, 44, 16)).astype(np.float32)
    c = rng.standard_normal((1, 4)).astype(np.float32)
    e = np.asarray([[0.3]], np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            pnet.encode_x(t_(x)).numpy(),
            np.asarray(jnet.apply(variables, jnp.asarray(x), method=JNetwork.encode_x)),
            rtol=0, atol=2e-6)
        enc_a_p = pnet.encode_audio(t_(auds))
        enc_a_j = jnet.apply(variables, jnp.asarray(auds), method=JNetwork.encode_audio)
        np.testing.assert_allclose(enc_a_p.numpy(), np.asarray(enc_a_j), rtol=0, atol=2e-5)
        np.testing.assert_array_equal(
            pnet.individual_code(0).numpy(),
            np.asarray(jnet.apply(variables, 0, method=JNetwork.individual_code)))
        for training in (False, True):
            got = pnet(t_(x), t_(d), t_(np.asarray(enc_a_j)), t_(c), t_(e), training)
            ref = jnet.apply(variables, jnp.asarray(x), jnp.asarray(d), enc_a_j,
                             jnp.asarray(c), jnp.asarray(e), training)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=2e-5)


def test_converter_is_strict_and_converts_density(nets):
    _, variables, _ = nets
    bad = {"params": dict(variables["params"], stray=np.zeros(3, np.float32))}
    with pytest.raises(KeyError, match="stray"):
        ernerf_from_flax(bad, NeRFNetConfig(**NET))
    dense = jrend.DensityGrid.create(8)
    got = density_from_flax(dense)
    assert got.occupancy.dtype == torch.bool and bool(got.occupancy.all())
    assert got.grid.shape == (512,) and float(got.mean_density) == 0.0


def test_bake_triplanes_matches_jax(nets):
    _, variables, pnet = nets
    spec = JNetConfig(**NET).plane_spec
    ref = jbake.bake_triplanes(variables["params"], spec, BOUND, resolution=32)
    tables = {n: getattr(pnet, n).detach() for n in ("plane_xy", "plane_yz", "plane_xz")}
    got = pbake.bake_triplanes(tables, pnet.cfg.plane_spec, BOUND, resolution=32)
    for name in ref:
        assert got[name].shape == tuple(ref[name].shape)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=0, atol=2e-6)
    bf = pbake.bake_triplanes(tables, pnet.cfg.plane_spec, BOUND, resolution=32,
                              dtype=torch.bfloat16)
    assert bf["plane_xy"].dtype == torch.bfloat16


def test_renderer_geometry_matches_jax():
    rng = np.random.default_rng(3)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.2, 1.6]
    intr = (40.0, 40.0, 16.0, 16.0)
    ro_j, rd_j = jrend.get_rays(jnp.asarray(pose), intr, 32, 32)
    ro_p, rd_p = prend.get_rays(t_(pose), intr, 32, 32)
    np.testing.assert_allclose(rd_p.numpy(), np.asarray(rd_j), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(ro_p.numpy(), np.asarray(ro_j))
    near_j, far_j, val_j = jrend.intersect_aabb(ro_j, rd_j, BOUND)
    near_p, far_p, val_p = prend.intersect_aabb(ro_p, rd_p, BOUND)
    np.testing.assert_allclose(near_p.numpy(), np.asarray(near_j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(far_p.numpy(), np.asarray(far_j), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(val_p.numpy(), np.asarray(val_j))
    g = 16
    occ = rng.random(g**3) < 0.3
    dj = jrend.DensityGrid(grid=jnp.zeros(g**3), occupancy=jnp.asarray(occ),
                           mean_density=jnp.zeros(()))
    dp = prend.DensityGrid(grid=torch.zeros(g**3), occupancy=t_(occ),
                           mean_density=torch.zeros(()))
    zj, dtj, vj = jrend.select_occupied_depths(ro_j, rd_j, near_j, far_j, dj, BOUND, g, 32, 8)
    zp, dtp, vp = prend.select_occupied_depths(ro_p, rd_p, near_p, far_p, dp, BOUND, g, 32, 8)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), rtol=2e-6, atol=0)
    np.testing.assert_allclose(dtp.numpy(), np.asarray(dtj), rtol=2e-6, atol=0)
    sig = rng.uniform(0, 5, zj.shape).astype(np.float32)
    col = rng.uniform(0, 1, zj.shape + (3,)).astype(np.float32)
    bg = rng.uniform(0, 1, (zj.shape[0], 3)).astype(np.float32)
    cj = jrend.composite(jnp.asarray(sig), jnp.asarray(col), zj, dtj, vj, jnp.asarray(bg))
    cp = prend.composite(t_(sig), t_(col), zp, dtp, vp, t_(bg))
    for key in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(cp[key].numpy(), np.asarray(cj[key]), rtol=0, atol=1e-5)


def test_tiles_and_packing_match_jax():
    jspec, pspec = jsamp.SamplerSpec(**SAMPLER), psamp.SamplerSpec(**SAMPLER)
    assert pspec.mip_rows == jspec.mip_rows and pspec.sg == jspec.sg
    np.testing.assert_array_equal(psamp.tile_permutation(16, 32, 8, 4),
                                  jsamp.tile_permutation(16, 32, 8, 4))
    x = np.arange(16 * 32 * 3, dtype=np.float32).reshape(16 * 32, 3)
    tj = np.asarray(jsamp.to_tiles(jnp.asarray(x), 16, 32, 8, 4))
    tp = psamp.to_tiles(t_(x), 16, 32, 8, 4)
    np.testing.assert_array_equal(tp.numpy(), tj)
    np.testing.assert_array_equal(psamp.from_tiles(tp, 16, 32, 8, 4).numpy(), x)
    rng = np.random.default_rng(4)
    r, c = SAMPLER["resolution"], SAMPLER["channels"]
    planes = {n: rng.standard_normal((r * r, c)).astype(np.float32)
              for n in ("plane_xy", "plane_yz", "plane_xz")}
    ref = jsamp.pack_planes_major({k: jnp.asarray(v) for k, v in planes.items()}, jspec)
    got = psamp.pack_planes_major({k: t_(v) for k, v in planes.items()}, pspec)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(ref.shape)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def span_geometry(seed: int, t: int = 6):
    """Per-ray (o, d, zmin, zmax, valid) of tiles marching into the box, as
    tests/test_pallas_sampler.py builds them."""
    rpt, tw = SAMPLER["tile_w"] * SAMPLER["tile_h"], SAMPLER["tile_w"]
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


def test_plan_jobs_span_matches_jax():
    jspec, pspec = jsamp.SamplerSpec(**SAMPLER), psamp.SamplerSpec(**SAMPLER)
    o, d, zmin, zmax, va = span_geometry(1)
    sj, uj, ovj = jsamp.plan_jobs_span(*map(jnp.asarray, (o, d, zmin, zmax, va)),
                                       jspec, BOUND)
    sp, up, ovp = psamp.plan_jobs_span(*map(t_, (o, d, zmin, zmax, va)), pspec, BOUND)
    assert sp.dtype == torch.int32 and up.dtype == torch.float32
    assert len(set(np.asarray(sj)[:, :, 1::2].ravel().tolist())) > 3   # several mips
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(up.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(ovp.numpy(), np.asarray(ovj))


SHAPES = {"wx_aud": (48, 64), "w_aud1": (64, 32), "wx_sig": (48, 64),
          "w_aud_sig": (32, 64), "wx_eye": (48, 16), "w_eye1": (16, 8),
          "w_sig_e": (8, 64), "w_sig1": (64, 64), "w_sigcol": (64, 16),
          "w_geo": (64, 64), "w_col_g": (64, 64), "w_rgb": (64, 16),
          "col_bias": (8, 64)}


def k2_inputs(seed: int, wdtype: str, t: int = 5):
    """Random K2 operands (numpy) of the toy spec, with random in-range
    window origins, as tests/test_pallas_sampler.py makes them."""
    spec = jsamp.SamplerSpec(**SAMPLER)
    rpt, kg, sg = spec.rays_per_tile, spec.kg, spec.sg
    rng = np.random.default_rng(seed)
    j = t * 3
    scal = np.zeros((j, 1 + 2 * kg), np.int32)
    scal[:, 0] = np.tile(np.arange(3), t)
    for g in range(kg):
        scal[:, 1 + 2 * g] = rng.integers(0, 64, j) & ~7
        scal[:, 2 + 2 * g] = rng.integers(0, 64, j) & ~7
    uv = rng.uniform(8, 100, (j, kg, 2, sg)).astype(np.float32)
    planes = np.asarray(jnp.asarray(rng.standard_normal(
        (3, spec.mip_rows[-1], spec.resolution * 16)), jnp.bfloat16).astype(jnp.float32))
    weights = {k: (0.3 * rng.standard_normal(SHAPES[k])).astype(np.float32)
               for k in jsamp.SHADE_WEIGHTS}
    dt = rng.uniform(0.05, 0.4, (t, rpt)).astype(np.float32)
    va = rng.random((t, rpt)) < 0.85
    proj = rng.standard_normal((t, rpt, 64)).astype(np.float32)
    dtv = np.pad((dt * va)[..., None], ((0, 0), (0, 0), (0, 7))).astype(np.float32)
    return scal.reshape(-1), uv, planes, weights, proj, dtv


def k2_torch(scal, uv, planes, weights, proj, dtv, wdtype):
    dt = torch.bfloat16 if wdtype == "bfloat16" else torch.float32
    return (t_(planes).to(torch.bfloat16), t_(scal), t_(uv), t_(proj), t_(dtv),
            {k: t_(v).to(dt) for k, v in weights.items()})


@pytest.mark.parametrize("wdtype,tol", [("float32", 2e-5), ("bfloat16", 1e-5)])
def test_k2_plain_matches_pallas_interpret(wdtype, tol):
    scal, uv, planes, weights, proj, dtv = k2_inputs(0, wdtype)
    jdt = jnp.bfloat16 if wdtype == "bfloat16" else jnp.float32
    ref = np.asarray(jsamp.sample_shade_comp_tiles(
        jnp.asarray(planes, jnp.bfloat16), jnp.asarray(scal), jnp.asarray(uv),
        jnp.asarray(proj), jnp.asarray(dtv),
        {k: jnp.asarray(v, jdt) for k, v in weights.items()},
        jsamp.SamplerSpec(**SAMPLER), interpret=True))
    args = k2_torch(scal, uv, planes, weights, proj, dtv, wdtype)
    before = psamp.launches
    got = psamp.sample_shade_comp_tiles(*args, psamp.SamplerSpec(**SAMPLER))
    assert psamp.launches == before, "a CPU tensor must take the plain version"
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert np.abs(ref[..., 0]).max() > 0.5, "the test tiles must be well occupied"
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)
    # chunking over tiles does not change the result
    np.testing.assert_array_equal(
        psamp.sample_shade_comp_tiles_plain(*args, psamp.SamplerSpec(**SAMPLER),
                                            chunk=2).numpy(), got.numpy())
    if wdtype == "bfloat16":   # the limit catches a dropped bf16 rounding
        unrounded = psamp.sample_shade_comp_tiles_plain(
            *args[:5], {k: w.float() for k, w in args[5].items()}, psamp.SamplerSpec(**SAMPLER))
        assert np.abs(unrounded.numpy() - ref).max() > tol


def chunked_mm(a, b, dtype, chunk: int = 16):
    """_mm with its f32 sum taken in k16 chunks, one after another: a
    stand-in for the order of wgmma's k16 steps (each chunk summed by
    torch.matmul, the chunks' partial sums added in order)."""
    a = a.to(dtype).to(torch.float32)
    b = b.to(torch.float32)
    acc = a[..., :chunk] @ b[:chunk]
    for k0 in range(chunk, a.shape[-1], chunk):
        acc = acc + a[..., k0:k0 + chunk] @ b[k0:k0 + chunk]
    return acc


def test_k2_head_in_k16_chunks_matches_pallas_interpret(monkeypatch):
    """With bf16 weights K2's head runs as wgmma products, summing each
    layer in k16 steps: the plain version with that order of f32 sums holds
    K2's limit of 1e-5 against the JAX K2 in interpret mode, as the plain
    version does (bf16 roundings of hidden activations may flip with the
    order; at this size they do not move the output past the limit)."""
    scal, uv, planes, weights, proj, dtv = k2_inputs(0, "bfloat16")
    ref = np.asarray(jsamp.sample_shade_comp_tiles(
        jnp.asarray(planes, jnp.bfloat16), jnp.asarray(scal), jnp.asarray(uv),
        jnp.asarray(proj), jnp.asarray(dtv),
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in weights.items()},
        jsamp.SamplerSpec(**SAMPLER), interpret=True))
    args = k2_torch(scal, uv, planes, weights, proj, dtv, "bfloat16")
    plain = psamp.sample_shade_comp_tiles_plain(*args, psamp.SamplerSpec(**SAMPLER))
    monkeypatch.setattr(psamp, "_mm", chunked_mm)
    got = psamp.sample_shade_comp_tiles_plain(*args, psamp.SamplerSpec(**SAMPLER))
    err = float(np.abs(got.numpy() - ref).max())
    print(f"K2 bf16 head in k16 chunks: max abs err {err:.3e} against the JAX K2, "
          f"{(got - plain).abs().max().item():.3e} against the plain version")
    assert np.abs(ref[..., 0]).max() > 0.5
    assert err <= 1e-5


K2_MISS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures_torch",
                       "k2_avatar_miss.pt")


def test_k2_plain_sums_the_eye_logit_as_the_kernel_does():
    """The tile of a trained avatar's frame on which the card's K2 read
    1.4e-5 against the plain version (chip_smoke.dump_k2's file): the plain
    version took the eye logit's 16 -> 1 product from torch.matmul, whose
    order moved one logit by an ulp and flipped bf16 roundings downstream.
    Summed in the kernel's order, the plain version is within K2's limit of
    the kernel's recorded output; the plain output recorded with it is not."""
    from chip_smoke import load_k2_dump

    args, got, ref = load_k2_dump(K2_MISS, torch.device("cpu"))
    plain = psamp.sample_shade_comp_tiles_plain(*args)
    assert (plain - got).abs().max().item() <= 1e-5
    assert (ref - got).abs().max().item() > 1e-5


def test_k2_recorded_miss_against_the_jax_k2():
    """The same tile through the JAX K2 in interpret mode (its _shade_core
    summing each product in XLA's order): the reference sides with neither
    the kernel's order nor torch.matmul's. The three outputs lie within
    1.5e-5 of one another, each more than K2's limit of 1e-5 from JAX's but
    the kernel's and the plain version's within it of each other: on this
    trained avatar's tile the bf16 roundings of the hidden values flip with
    the order of the f32 sums, whichever order is taken."""
    import dataclasses

    from chip_smoke import load_k2_dump

    args, got, ref = load_k2_dump(K2_MISS, torch.device("cpu"))
    planes, jobs, uv, dproj, dtv, weights, spec = args
    jspec = jsamp.SamplerSpec(**{f.name: getattr(spec, f.name)
                                 for f in dataclasses.fields(jsamp.SamplerSpec)
                                 if hasattr(spec, f.name)})

    def j_(x):
        return (jnp.asarray(x.float().numpy(), jnp.bfloat16) if x.dtype == torch.bfloat16
                else jnp.asarray(x.numpy()))

    jx = np.asarray(jsamp.sample_shade_comp_tiles(
        j_(planes), j_(jobs), j_(uv), j_(dproj), j_(dtv), {k: j_(v) for k, v in weights.items()},
        jspec, interpret=True))
    plain = psamp.sample_shade_comp_tiles_plain(*args).numpy()
    err = {name: float(np.abs(a - jx).max())
           for name, a in (("kernel", got.numpy()), ("plain, the kernel's order", plain),
                           ("plain, torch.matmul's order", ref.numpy()))}
    print(f"K2's recorded miss against the JAX K2: {err}")
    assert all(1e-5 < e <= 1.5e-5 for e in err.values())
    assert np.abs(plain - got.numpy()).max() <= 1e-5


def test_k2_cuda_path_refuses_cpu_operands():
    scal, uv, planes, weights, proj, dtv = k2_inputs(1, "bfloat16", t=2)
    args = k2_torch(scal, uv, planes, weights, proj, dtv, "bfloat16")
    with pytest.raises(ValueError, match="CUDA"):
        psamp.sample_shade_comp_tiles_cuda(*args, psamp.SamplerSpec(**SAMPLER))
