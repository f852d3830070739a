"""The ER-NeRF ``nearest``/``bilinear`` sample modes in the PyTorch port
against the JAX package, on the CPU at toy sizes (64² frames, 4 hash
levels, 8 samples per ray): the baked-texture sampling
(``sample_plane``, ``encode_x_baked``), the block-shared probe and the
static ray compaction of ``plan_rays``, the bf16 head's roundings, and the
whole frame step against ``make_nerf_render_step`` with baked textures.
(NeRFReal serving a loopback session in these modes is in
test_torch_nerf_engine.py.)

Inputs come from numpy seeds; weights from the JAX init through
``convert.ernerf_from_flax``. Tolerances, with their reasons:
- texture sampling: 1e-6 (the same f32 ops; bf16 texels widen exactly);
- probe and compaction: z and dt within 1e-6, valid and sel equal (eager
  JAX, whose divisions by a constant are true divisions);
- the bf16 head: each colour and each σ logit within one bf16 step and
  all but 0.1% of them equal (σ to 1e-6 relative): f32 sums in another
  order can cross a bf16 rounding boundary;
- frames: 1 LSB (the ROADMAP rule: the jitted JAX step divides by
  reciprocals and sums in another order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.config import Config as JConfig
from mere_fusion_tpu.data.provider import NeRFTestDataset as JDataset
from mere_fusion_tpu.engines.nerf import make_nerf_render_step
from mere_fusion_tpu.models.ernerf import renderer as jrend
from mere_fusion_tpu.models.ernerf.network import NeRFNetConfig as JNetConfig
from mere_fusion_tpu.models.ernerf.network import NeRFNetwork as JNetwork
from mere_fusion_tpu.ops import triplane_bake as jbake
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.convert import density_from_flax, ernerf_from_flax
from mere_fusion_tpu_torch.data.provider import NeRFTestDataset, synthesize_nerf_dataset
from mere_fusion_tpu_torch.engines.nerf_baked import (
    forward_with_enc_bf16,
    make_baked_render_step,
)
from mere_fusion_tpu_torch.models.ernerf import renderer as prend
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork
from mere_fusion_tpu_torch.ops import triplane_bake as pbake
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

NET = dict(num_levels=4, base_resolution=16, desired_resolution=64, log2_hashmap_size=10)
OVERRIDES = {
    "nerf.grid_size": 16,
    "nerf.num_levels": 4,
    "nerf.base_resolution": 16,
    "nerf.desired_resolution": 64,
    "nerf.log2_hashmap_size": 10,
    "nerf.max_steps": 8,
}


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_texture_sampling_matches_jax(method):
    rng = np.random.default_rng(0)
    r = 32
    plane = rng.standard_normal((r, r, 5)).astype(np.float32)
    uv = rng.uniform(-1.05, 1.05, (500, 2)).astype(np.float32)
    uv[:4] = [[-1, -1], [1, 1], [-1, 1], [0, 0]]                      # edges and a tie
    ref = np.asarray(jbake.sample_plane(jnp.asarray(plane), jnp.asarray(uv), 1.0, method))
    got = pbake.sample_plane(t_(plane), t_(uv), 1.0, method)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # flat bf16 textures, as bake_triplanes stores them, through encode_x_baked
    baked = {n: jnp.asarray(rng.standard_normal((r * r, 4)), jnp.bfloat16)
             for n in ("plane_xy", "plane_yz", "plane_xz")}
    xyz = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    ref = np.asarray(jbake.encode_x_baked(baked, jnp.asarray(xyz), 1.0, method))
    pb = {k: t_(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16) for k, v in baked.items()}
    got = pbake.encode_x_baked(pb, t_(xyz), 1.0, method)
    assert got.dtype == torch.float32 and got.shape == (300, 12)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_blocked_probe_and_compaction_match_jax():
    rng = np.random.default_rng(1)
    h = w = 16
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 1.6
    rays_o, rays_d = jrend.get_rays(jnp.asarray(pose), (19.0, 19.0, 8.0, 8.0), h, w)
    rays_o, rays_d = np.asarray(rays_o), np.asarray(rays_d)
    g = 16
    occ = rng.random(g**3) < 0.02
    dj = jrend.DensityGrid(grid=jnp.zeros(g**3), occupancy=jnp.asarray(occ),
                           mean_density=jnp.zeros(()))
    dp = density_from_flax(dj)
    kw = dict(n_candidates=32, n_steps=8, probe_block=4, image_hw=(h, w))
    ref = jrend.plan_rays(jnp.asarray(rays_o), jnp.asarray(rays_d), dj, 1.0, g,
                          max_active_rays=100, **kw)
    got = prend.plan_rays(t_(rays_o), t_(rays_d), dp, 1.0, g, max_active_rays=100, **kw)
    active = np.asarray(jrend.plan_rays(jnp.asarray(rays_o), jnp.asarray(rays_d), dj, 1.0, g,
                                        **kw)["valid"]).any(-1)
    assert 0 < active.sum() < 100 and not active[:100].all()   # compaction reorders
    np.testing.assert_array_equal(got["sel"].numpy(), np.asarray(ref["sel"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))
    for key in ("z", "dt", "xyz"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=0, atol=1e-6,
                                   err_msg=key)
    # the probe alone, on every ray
    near, far, _ = jrend.intersect_aabb(jnp.asarray(rays_o), jnp.asarray(rays_d), 1.0)
    zj, dtj, vj = jrend.select_depths_blocked(jnp.asarray(rays_o), jnp.asarray(rays_d), near,
                                              far, dj, 1.0, g, 32, 8, 4, h, w)
    zp, dtp, vp = prend.select_depths_blocked(t_(rays_o), t_(rays_d), t_(near), t_(far), dp,
                                              1.0, g, 32, 8, 4, h, w)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dtp.numpy(), np.asarray(dtj), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def nets():
    """(JAX network, its variables with U(−1, 1) tables, the port's network)."""
    jnet = JNetwork(JNetConfig(**NET))
    variables = jax.jit(jnet.init, static_argnames="method")(
        jax.random.key(0), jnp.zeros((8, 44, 16)), jnp.zeros((4, 3)),
        jnp.ones((4, 3)) / np.sqrt(3.0), jnp.zeros((1, 4)), jnp.zeros((1, 1)),
        method=JNetwork.full_init)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(5)
    for name in ("plane_xy", "plane_yz", "plane_xz"):
        params[name] = rng.uniform(-1, 1, params[name].shape).astype(np.float32)
    variables = {"params": params}
    pnet = NeRFNetwork(NeRFNetConfig(**NET))
    pnet.load_state_dict(ernerf_from_flax(variables, NeRFNetConfig(**NET)), strict=True)
    return jnet, variables, pnet.eval()


def test_bf16_head_rounds_as_jax(nets):
    _, variables, pnet = nets
    rng = np.random.default_rng(2)
    n = 4096
    enc = rng.uniform(-1, 1, (n, 12)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    enc_a = rng.standard_normal((1, 32)).astype(np.float32)
    c = rng.standard_normal((1, 4)).astype(np.float32)
    e = np.asarray([[0.3]], np.float32)
    bnet = JNetwork(JNetConfig(**NET), dtype=jnp.bfloat16)
    ref = jax.jit(lambda v, *a: tuple(
        o.astype(jnp.float32) for o in bnet.apply(v, *a, method=JNetwork.forward_with_enc)))(
        variables, enc, d, enc_a, c, e)
    got = forward_with_enc_bf16(pnet, t_(enc), t_(d), t_(enc_a), t_(c), t_(e))
    sig, col = got[0].numpy(), got[1].numpy()
    sig_j, col_j = np.asarray(ref[0]), np.asarray(ref[1])
    # σ = exp(bf16 logit): a logit within one bf16 step, all but 0.1% equal
    lg, lg_j = np.log(sig), np.log(sig_j)
    assert (np.abs(lg - lg_j) <= 2.0 ** -8 * np.maximum(np.abs(lg_j), 1.0)).all()
    assert (np.abs(sig - sig_j) > 1e-6 * sig_j).mean() <= 1e-3
    assert np.abs(col - col_j).max() <= 2.0 ** -8
    assert (col != col_j).mean() <= 1e-3
    # an f32 head is further off than that
    f32 = pnet.forward_with_enc(t_(enc), t_(d), t_(enc_a), t_(c), t_(e))[1].detach().numpy()
    assert (f32 != col_j).mean() > 0.1


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    d = synthesize_nerf_dataset(str(tmp_path_factory.mktemp("nerfdata")), hw=64)
    kw = dict(scale=1.0, smooth_path=True, smooth_path_window=3, smooth_eye=True)
    return (JDataset.load(f"{d}/transforms.json", f"{d}/au.csv", **kw),
            NeRFTestDataset.load(f"{d}/transforms.json", f"{d}/au.csv", **kw))


@pytest.mark.parametrize("mode,shade_dtype", [("bilinear", "bfloat16"),
                                              ("nearest", "bfloat16"),
                                              ("bilinear", "float32")])
def test_frame_step_matches_jax(nets, datasets, mode, shade_dtype):
    jnet, variables, pnet = nets
    jds, pds = datasets
    over = {**OVERRIDES, "nerf.sample_mode": mode, "nerf.shade_dtype": shade_dtype,
            # half the 64² frame: the compaction keeps the first rays in raster order
            "nerf.max_active_rays": 2048}
    baked = jbake.bake_triplanes(variables["params"], JNetConfig(**NET).plane_spec, 1.0,
                                 resolution=128, dtype=jnp.bfloat16)
    pbaked = {k: t_(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
              for k, v in baked.items()}
    jstep = make_nerf_render_step(jnet, variables, jds, JConfig().override(**over), baked=baked)
    pstep = make_baked_render_step(pnet, pds, Config().override(**over), pbaked)
    g = 16
    occ = np.zeros((g, g, g), bool)
    occ[5:11, 4:12, 5:11] = True
    grids = [jrend.DensityGrid.create(g),
             jrend.DensityGrid(grid=jnp.zeros(g**3), occupancy=jnp.asarray(occ.reshape(-1)),
                               mean_density=jnp.zeros(()))]
    rng = np.random.default_rng(8)
    frames = []
    for index, jdens in ((0, grids[0]), (1, grids[1]), (2, grids[1])):
        auds = rng.standard_normal((8, 44, 16)).astype(np.float32)   # the EMA carries over
        jd, pd = jds.collate(index), pds.collate(index)
        ji = np.asarray(jstep(jd["pose"], jnp.asarray(auds), jnp.asarray(jd["eye"]), jdens,
                              jnp.asarray(jd["bg_color"])))
        pi, n_active, n_overflow = pstep(pd["pose"], t_(auds), pd["eye"],
                                         density_from_flax(jdens), t_(pd["bg_color"]))
        assert n_active is None and n_overflow is None
        assert pi.dtype == torch.uint8 and pi.shape == (64, 64, 3)
        diff = np.abs(pi.numpy().astype(int) - ji.astype(int))
        assert diff.max() <= 1, f"{mode} frame {index} differs by {diff.max()} LSB"
        frames.append(pi.numpy())
    # the dense grid's budget cuts the frame: its lower half is background
    assert frames[0][:32].std() > 2 and (frames[0][40:] == frames[0][63, 0]).all()
    assert (frames[1] != frames[2]).any()


def test_cli_and_metrics_serve_the_modes():
    from mere_fusion_tpu_torch import cli
    from mere_fusion_tpu_torch.runtime.metrics import LatencyMeter

    parser = cli.build_parser()
    args = parser.parse_args(["--model", "ernerf", "--sample_mode", "bilinear"])
    assert cli.config_from_args(args).nerf.sample_mode == "bilinear"
    assert cli.config_from_args(parser.parse_args([])).nerf.sample_mode == "pallas"
    with pytest.raises(SystemExit):
        parser.parse_args(["--sample_mode", "trilinear"])
    meter = LatencyMeter()
    meter.observe(0.5)
    meter.reset()                      # a new window: a phase's own p50
    meter.observe(0.1)
    assert meter.count == 1 and meter.quantile(0.5) == 0.1
