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


U32 = 2.0 ** -24     # the f32 unit roundoff


def _gamma(n: int) -> float:
    """γₙ = n·u / (1 − n·u): a bound on the relative error of any order of
    summing n f32 terms, of Σ|terms|."""
    return n * U32 / (1 - n * U32)


def k2_head_flips(path: str) -> dict:
    """The witness of K2's recorded miss (ROADMAP §3): on a dump_k2 tile, the
    head's hidden values whose bf16 rounding differs between JAX's K2
    arithmetic (``_shade_core``'s products, XLA's order) and the port's
    plain version in the kernel's order (``sampler._mm``, ``_dot_seq``),
    each layer fed the same operands: JAX's own rounded values from the
    layer before. For each value that rounds apart, the distance of each
    side's f32 pre-rounding sum from the bf16 rounding midpoint between
    them, over the order-error bound of that sum, γₙ·Σ|aₖ·wₖ| over its n
    terms (h1 also carries the eye logit's bound through the sigmoid, whose
    slope is at most 1/4). A ratio ≤ 1 is a tie that no fixed summation
    order decides. Returns {layer: [ratio of each flip]}."""
    from chip_smoke import load_k2_dump

    args, _, _ = load_k2_dump(path, torch.device("cpu"))
    planes, jobs, uv, dproj, _, w, spec = args
    t = uv.shape[0] // 3
    x = psamp._tile_features(planes, jobs.reshape(t, 3, -1),
                             uv.reshape(t, 3, spec.kg, 2, spec.sg), spec).reshape(t * spec.kg * spec.sg, -1)
    ds = psamp._sample_rows(dproj, spec).reshape(x.shape[0], -1)
    bf, f32 = torch.bfloat16, jnp.float32
    jw = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) for k, v in w.items()}
    pw = {k: v.float().numpy() for k, v in w.items()}          # bf16 values, exactly
    na, ne = w["wx_aud"].shape[1], w["wx_eye"].shape[1]

    def rb(a):                                                 # round to bf16
        return torch.tensor(np.asarray(a, np.float32)).to(bf).float().numpy()

    def jmm(a, b):                                             # _shade_core's mm
        return jnp.dot(jnp.asarray(a).astype(jnp.bfloat16), b, preferred_element_type=f32)

    def pmm(a, name):                                          # the plain version's
        return psamp._mm(torch.from_numpy(np.ascontiguousarray(a)), w[name], bf).numpy()

    def bound(n, *pairs):
        return _gamma(n) * sum(np.abs(a) @ np.abs(b) for a, b in pairs)

    # JAX's chain, as _shade_core computes it: its outputs must be _shade_core's
    jx, jds = jnp.asarray(x.numpy()), jnp.asarray(ds.numpy())
    w_x = jnp.concatenate([jw["wx_aud"], jw["wx_sig"], jw["wx_eye"]], axis=1)
    hx = np.asarray(jmm(jx, w_x))
    aud_h, h0, eye_h = np.maximum(hx[:, :na], 0), hx[:, na:-ne], np.maximum(hx[:, -ne:], 0)
    aud_ch = np.asarray(jmm(aud_h, jw["w_aud1"]))
    eye_att = jax.nn.sigmoid(jmm(eye_h, jw["w_eye1"])[:, :1])
    pre1 = np.asarray(h0 + jmm(aud_ch, jw["w_aud_sig"]) + eye_att * jw["w_sig_e"][:1].astype(f32))
    h1 = np.maximum(pre1, 0)
    h2 = np.asarray(jax.nn.relu(jmm(h1, jw["w_sig1"])))
    hs = np.asarray(jmm(h2, jnp.concatenate([jw["w_sigcol"], jw["w_geo"]], axis=1)))
    nc = w["w_sigcol"].shape[1]
    geo = hs[:, nc:]
    rch = np.asarray(jax.nn.relu(jmm(geo, jw["w_col_g"]) + jds
                                 + jw["col_bias"][:1].astype(f32)))
    rgb = np.asarray(jmm(rch, jw["w_rgb"]))
    sig_ref, rgb_ref = jsamp._shade_core(spec, jw, jx, jds)
    assert np.array_equal(hs[:, :nc], np.asarray(sig_ref))
    assert np.array_equal(rgb, np.asarray(rgb_ref))

    # each rounded hidden value: (JAX's, the port's on JAX's operands, its bound)
    xb, ab, eb = rb(x.numpy()), rb(aud_h), rb(eye_h)
    cb, h1b, h2b, gb = rb(aud_ch), rb(h1), rb(h2), rb(geo)
    x_ae = np.concatenate([pw["wx_aud"], pw["wx_eye"]], axis=1)
    # the plain version's first product: x by the three weights side by side
    p_hx = psamp._mm(x, torch.cat([w["wx_aud"], w["wx_sig"], w["wx_eye"]], dim=1), bf).numpy()
    eye_logit = psamp._dot_seq(torch.from_numpy(eb), w["w_eye1"][:, 0], bf)[:, None]
    p_pre1 = (torch.from_numpy(p_hx[:, na:-ne]) + psamp._mm(torch.from_numpy(cb), w["w_aud_sig"], bf)
              + torch.sigmoid(eye_logit) * w["w_sig_e"][0].float()).numpy()
    w_se = np.abs(pw["w_sig_e"][:1])
    layers = {
        "projection": (np.concatenate([aud_h, eye_h], axis=1),
                       np.maximum(np.concatenate([p_hx[:, :na], p_hx[:, -ne:]], axis=1), 0),
                       bound(xb.shape[1], (xb, x_ae))),
        "audio": (aud_ch, pmm(ab, "w_aud1"), bound(ab.shape[1], (ab, pw["w_aud1"]))),
        "sigma_in": (h1, np.maximum(p_pre1, 0),
                     bound(xb.shape[1] + cb.shape[1] + 1, (xb, pw["wx_sig"]),
                           (cb, pw["w_aud_sig"]), (np.ones((len(xb), 1)), w_se))
                     + w_se * 0.25 * bound(ne, (eb, pw["w_eye1"][:, :1]))),
        "sigma": (h2, np.maximum(pmm(h1b, "w_sig1"), 0), bound(h1b.shape[1], (h1b, pw["w_sig1"]))),
        "geometry": (geo, pmm(h2b, "w_geo"), bound(h2b.shape[1], (h2b, pw["w_geo"]))),
        "colour": (rch, np.maximum(pmm(gb, "w_col_g") + ds.numpy() + pw["col_bias"][:1], 0),
                   bound(gb.shape[1] + 2, (gb, pw["w_col_g"]))
                   + _gamma(gb.shape[1] + 2) * (np.abs(ds.numpy()) + np.abs(pw["col_bias"][:1]))),
    }
    flips = {}
    for name, (vj, vp, b) in layers.items():
        bj, bp = rb(vj), rb(vp)
        apart = np.nonzero(bj != bp)
        mid = (bj[apart].astype(np.float64) + bp[apart]) / 2
        flips[name] = (np.maximum(np.abs(vj[apart] - mid), np.abs(vp[apart] - mid))
                       / b[apart]).tolist()
    return flips


# the worst tile (against the plain version) of an avatar trained with
# `chip_smoke.py --seed 3`: its kernel output is 6.6e-5 from JAX's K2 in
# interpret mode, 3.0e-7 from the plain version in the kernel's order
K2_SEED3 = os.path.join(os.path.dirname(K2_MISS), "k2_avatar_seed3.pt")


@pytest.mark.parametrize("dump", [K2_MISS, K2_SEED3], ids=["recorded_miss", "seed3_worst"])
def test_k2_recorded_miss_flips_are_ties(dump):
    """ROADMAP §3's K2 fault, settled on trained avatars' tiles: every hidden
    value of the head whose bf16 rounding differs between JAX's K2
    arithmetic and the port's plain version in the kernel's order, each
    layer fed JAX's own operands, is a tie: both f32 sums lie within the
    summation-order error bound of the bf16 midpoint between them, so no
    fixed order decides it (k2_head_flips). The flips that remain
    downstream in the whole chain follow from these. The kernel stays
    within K2's limit of the plain version in its order."""
    from chip_smoke import load_k2_dump

    flips = k2_head_flips(dump)
    print(f"K2 on {os.path.basename(dump)}, bf16 roundings apart by layer:",
          {k: len(v) for k, v in flips.items()},
          "largest distance from the midpoint / bound:",
          max((r for v in flips.values() for r in v), default=0.0))
    assert sum(map(len, flips.values())) > 0, "the tile must show its flips"
    assert all(r <= 1.0 for v in flips.values() for r in v)
    args, got, _ = load_k2_dump(dump, torch.device("cpu"))
    assert (psamp.sample_shade_comp_tiles_plain(*args) - got).abs().max().item() <= 1e-5


def _k2_ray_head(x, ds, w, flip=None):
    """The plain version's head (``psamp.head_hidden`` and the two last
    products) on one ray's samples, every left operand's bf16 rounding
    recorded as {name: (f32 value, order-error bound γₙ·Σ|aₖ·wₖ| of its
    sum)}. ``flip`` = (name, index): that value takes its other bf16
    neighbour. Returns (σ logits, rgb logits, the record)."""
    bf, f32 = torch.bfloat16, torch.float32
    rec = {}

    def rnd(name, v, b):
        rec[name] = (v, b)
        r = v.to(bf).float()
        if flip is not None and flip[0] == name:
            o = torch.nextafter(r[flip[1]].to(bf), (v[flip[1]] - r[flip[1]]).sign().to(bf)
                                * torch.tensor(float("inf"), dtype=bf))
            r = r.clone()
            r[flip[1]] = o.float()
        return r

    def mm(a, name):                            # (a @ w, Σ|aₖ·wₖ|)
        wt = w[name].float()
        return a @ wt, a.abs() @ wt.abs()

    na, ns_ = w["wx_aud"].shape[1], w["wx_sig"].shape[1]
    xr = x.to(bf).float()
    nx = xr.shape[-1]
    wx = torch.cat([w["wx_aud"], w["wx_sig"], w["wx_eye"]], dim=1).float()
    hx, hb = xr @ wx, xr.abs() @ wx.abs()
    aud_h = rnd("aud_h", torch.relu(hx[:, :na]), _gamma(nx) * hb[:, :na])
    eye_h = rnd("eye_h", torch.relu(hx[:, na + ns_:]), _gamma(nx) * hb[:, na + ns_:])
    c, cb = mm(aud_h, "w_aud1")
    aud_ch = rnd("aud_ch", c, _gamma(na) * cb)
    s2, s2b = mm(aud_ch, "w_aud_sig")
    eye1 = w["w_eye1"][:, :1].float()
    logit = psamp._dot_seq(eye_h, eye1[:, 0], f32)[:, None]
    w_se = w["w_sig_e"][0].float()
    pre1 = hx[:, na:na + ns_] + s2 + torch.sigmoid(logit) * w_se
    b1 = (_gamma(nx + aud_ch.shape[-1] + 1) * (hb[:, na:na + ns_] + s2b + w_se.abs())
          + w_se.abs() * 0.25 * _gamma(eye_h.shape[-1]) * (eye_h.abs() @ eye1.abs()))
    h1 = rnd("h1", torch.relu(pre1), b1)
    v, vb = mm(h1, "w_sig1")
    h2 = rnd("h2", torch.relu(v), _gamma(h1.shape[-1]) * vb)
    g, gb = mm(h2, "w_geo")
    geo = rnd("geo", g, _gamma(h2.shape[-1]) * gb)
    c, cb = mm(geo, "w_col_g")
    bias = w["col_bias"][0].float()
    rch = rnd("rch", torch.relu(c + ds + bias),
              _gamma(geo.shape[-1] + 2) * (cb + ds.abs() + bias.abs()))
    return (h2 @ w["w_sigcol"][:, :1].float())[:, 0], rch @ w["w_rgb"][:, 1:4].float(), rec


def k2_tie_witness(path: str, side: str = "ref", tol: float = 1e-5) -> list:
    """The witness of a K2 miss on the card (ROADMAP §3): for each ray of a
    dump_k2 file whose kernel output (``got``) and the card's plain output
    (``ref``) differ by more than ``tol``, the ties of the plain version's
    head on the CPU (values within the order-error bound of a bf16 rounding
    midpoint, zeros of the relu aside) and the one tie whose other rounding
    brings the CPU's output for that ray closest to the card's ``side``.
    Returns [(tile, ray, error before, error after, (layer, index), its
    distance from the midpoint / bound)]."""
    from chip_smoke import load_k2_dump

    args, got, ref = load_k2_dump(path, torch.device("cpu"))
    planes, jobs, uv, dproj, dtv, w, spec = args
    t, ks, rpt = uv.shape[0] // 3, spec.k // spec.kg, spec.rays_per_tile
    target = {"ref": ref, "got": got}[side]
    out = []
    for ti, r in torch.nonzero((got - ref).abs().amax(-1) > tol).tolist():
        x = psamp._tile_features(planes, jobs.reshape(t, 3, -1)[ti:ti + 1],
                                 uv.reshape(t, 3, spec.kg, 2, spec.sg)[ti:ti + 1], spec)[0]
        ds = psamp._sample_rows(dproj[ti:ti + 1], spec)[0]
        rows = [g * rpt * ks + r * ks + j for g in range(spec.kg) for j in range(ks)]
        x, ds = x[rows], ds[rows]                       # the ray's samples in depth order

        def ray(flip=None):
            sig, rgb, rec = _k2_ray_head(x, ds, w, flip)
            comp = psamp._composite(sig.reshape(1, spec.kg, 1, ks).expand(1, spec.kg, rpt, ks)
                                    .reshape(1, -1), rgb.reshape(1, spec.kg, 1, ks, 3)
                                    .expand(1, spec.kg, rpt, ks, 3).reshape(1, -1, 3),
                                    dtv[ti:ti + 1, :, 0], spec)[0, r]
            return (comp - target[ti, r]).abs().max().item(), rec

        before, rec = ray()
        ties = []
        for name, (v, b) in rec.items():
            near = v.to(torch.bfloat16).float()
            other = torch.nextafter(near.to(torch.bfloat16), ((v - near).sign() * float("inf"))
                                    .to(torch.bfloat16)).float()
            ratio = (v - (near + other) / 2).abs() / b
            ties += [((name, tuple(i)), ratio[tuple(i)].item())
                     for i in torch.nonzero((v != 0) & (v != near) & (ratio <= 1)).tolist()]
        after, tie, q = min((ray(f)[0], f, q) for f, q in ties)
        out.append((ti, r, before, after, tie, q))
    return out


def test_k2_recorded_miss_is_one_tie_of_the_plain_version():
    """The recorded miss on the card (K2_MISS), the kernel against the
    card's plain version (1.4e-5 on one ray): on the CPU the plain version gives the
    kernel's output for that ray, and rounding one tie of its head the other
    way (h1, a sum 0.5% of its order-error bound from the bf16 midpoint)
    gives the card's plain output, bit for bit. The card's torch.matmul
    summed that value in another order; neither the kernel nor the plain
    version is at fault."""
    (tile, ray, before, after, tie, q), = k2_tie_witness(K2_MISS, "ref")
    print(f"K2's recorded miss, ray {ray}: the CPU's plain output {before:.3e} from the "
          f"card's; {tie} rounded the other way: {after:.3e} (distance / bound {q:.4f})")
    assert before > 1e-5 and after == 0.0 and q <= 1.0 and tie[0] == "h1"
    (_, _, before, _, _, _), = k2_tie_witness(K2_MISS, "got")
    assert before <= 2.4e-7                    # the kernel's output: the CPU's, unflipped


def test_k2_cuda_path_refuses_cpu_operands():
    scal, uv, planes, weights, proj, dtv = k2_inputs(1, "bfloat16", t=2)
    args = k2_torch(scal, uv, planes, weights, proj, dtv, "bfloat16")
    with pytest.raises(ValueError, match="CUDA"):
        psamp.sample_shade_comp_tiles_cuda(*args, psamp.SamplerSpec(**SAMPLER))
