"""The ER-NeRF head-training slice of the PyTorch port against the JAX
package on the CPU at toy sizes (4 levels, 2^10 tables, grid 16, 16
candidates, 4 steps, 32² images, 3 frames, as tests/test_nerf_train.py
uses; a 64² scene with landmarks and 32² patches for the fine-tuning): the
renderer's training path, the density refresh, the training dataset and its
preload tiers with its patch and lips batches, the optimiser groups, one
whole train step, the LPIPS patch and lips steps, ``--test`` evaluation, the
training viewer and the CLI.

Weights come from the JAX init through ``convert.ernerf_from_flax``, inputs
from numpy seeds, and the jitter noise of the train step from the JAX
draw. Tolerances, with their reasons:
- geometry, pixel choice, frames and masks: exact (the same operations);
  rays 1e-7 (as test_torch_nerf_ops.py: the normalisation rounds
  differently);
- network outputs composited along rays: 2e-5 (ROADMAP's MLP rule);
- the optimiser: 1e-6 after three steps (Adam's moments round in another
  order), below the 3e-6 by which torch AdamW's default weight decay of
  1e-2 moves the net weights on the same gradients;
- the train step: loss, mse and gradient norm 1e-6 relative (1.2e-7
  read); every gradient within 2e-5 of its parameter's largest gradient
  entry (3.9e-6 read: f32 sums over the 1024 samples and the hash-table
  scatter sums in another order);
- the LPIPS patch and lips steps, with the JAX package's LPIPS weights
  through ``convert.lpips_from_flax``: the same limits (9.3e-8 on the
  metrics; 1.2e-5 patch, 3.3e-6 lips on the gradients), and the port's
  two-patch step on the camera's rays against its float64 step the same
  (1.0e-7, 6.3e-6);
- ``--test``'s PSNR and SSIM: 1e-5 relative (3.0e-8 and 2.9e-6 read: f32
  means over the frame in another order);
- the viewer's render: 2e-5 (2.4e-7 read); its JPEG within 4 LSB of the
  render on average (0.83 read at quality 85).
"""
from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mere_fusion_tpu.data import provider as jprov
from mere_fusion_tpu.models import lpips as jlpips
from mere_fusion_tpu.models.ernerf import renderer as jrend
from mere_fusion_tpu.models.ernerf.network import NeRFNetConfig as JNetConfig
from mere_fusion_tpu.models.ernerf.network import NeRFNetwork as JNetwork
from mere_fusion_tpu.train import ernerf_train as jtrain
from mere_fusion_tpu_torch.convert import density_from_flax, ernerf_from_flax, lpips_from_flax
from mere_fusion_tpu_torch.data import provider as pprov
from mere_fusion_tpu_torch.models import lpips as plpips
from mere_fusion_tpu_torch.models.ernerf import renderer as prend
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork
from mere_fusion_tpu_torch.train import ernerf_cli
from mere_fusion_tpu_torch.train import ernerf_train as ptrain
from mere_fusion_tpu_torch.utils.checkpoint import Checkpointer
from chip_smoke import write_lms
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

NET = dict(num_levels=4, base_resolution=16, desired_resolution=64, log2_hashmap_size=10,
           individual_dim=4, num_train_frames=4)
TRAIN = dict(grid_size=16, n_candidates=16, n_steps=4, iters=1000)
CPU = torch.device("cpu")


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
    return jnet, variables, port_net(variables)


def port_net(variables) -> NeRFNetwork:
    cfg = NeRFNetConfig(**NET)
    net = NeRFNetwork(cfg)
    net.load_state_dict(ernerf_from_flax(variables, cfg), strict=True)
    return net


def make_batch(n: int = 256, seed: int = 0) -> dict:
    """A numpy ray batch into the box, as tests/test_nerf_train.py makes it."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {
        "rays_o": (np.zeros((n, 3), np.float32) + [0, 0, -2.0]).astype(np.float32),
        "rays_d": (np.abs(d) * [0.2, 0.2, 1.0] / 1.2).astype(np.float32),
        "rgb": rng.uniform(0.4, 0.6, (n, 3)).astype(np.float32),
        "bg_color": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "auds": (rng.standard_normal((8, 44, 16)) * 0.1).astype(np.float32),
        "eye": np.asarray([[0.25]], np.float32),
        "index": 1,
        "face_mask": rng.uniform(size=n) > 0.5,
    }


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v, jnp.int32) if k == "index" else jnp.asarray(v)
            for k, v in b.items()}


def torch_batch(b: dict) -> dict:
    return {k: v if k == "index" else t_(v) for k, v in b.items()}


def occupancy(seed: int, g: int = 16):
    occ = np.random.default_rng(seed).random(g**3) < 0.4
    dj = jrend.DensityGrid(grid=jnp.zeros(g**3), occupancy=jnp.asarray(occ),
                           mean_density=jnp.zeros(()))
    return dj, density_from_flax(dj)


def test_render_rays_with_extras_matches_jax(nets):
    jnet, variables, pnet = nets
    b = make_batch(128, seed=1)
    dj, dp = occupancy(2)
    auds = b["auds"]
    enc_a = jnet.apply(variables, jnp.asarray(auds), method=JNetwork.encode_audio)
    c = jnet.apply(variables, 1, method=JNetwork.individual_code)
    eye = jnp.asarray(b["eye"])
    kw = dict(bound=1.0, grid_size=16, n_candidates=16, n_steps=4, training=True)
    ref = jrend.render_rays(
        lambda x, d, tr: jnet.apply(variables, x, d, enc_a, c, eye, training=tr),
        jnp.asarray(b["rays_o"]), jnp.asarray(b["rays_d"]), dj,
        bg_color=jnp.asarray(b["bg_color"]), **kw)
    plan_j = jrend.plan_rays(jnp.asarray(b["rays_o"]), jnp.asarray(b["rays_d"]), dj, 1.0, 16,
                             n_candidates=16, n_steps=4)
    with torch.no_grad():
        pa, pc, pe = t_(np.asarray(enc_a)), t_(np.asarray(c)), t_(b["eye"])
        plan_p = prend.plan_rays(t_(b["rays_o"]), t_(b["rays_d"]), dp, 1.0, 16,
                                 n_candidates=16, n_steps=4)
        got = prend.render_rays(lambda x, d, tr: pnet(x, d, pa, pc, pe, tr),
                                t_(b["rays_o"]), t_(b["rays_d"]), dp,
                                bg_color=t_(b["bg_color"]), **kw)
    np.testing.assert_array_equal(plan_p["valid"].numpy(), np.asarray(plan_j["valid"]))
    assert plan_p["sel"] is None and bool(plan_p["valid"].any()) and not bool(
        plan_p["valid"].all())
    for key in ("xyz", "z", "dt"):
        np.testing.assert_allclose(plan_p[key].numpy(), np.asarray(plan_j[key]),
                                   rtol=2e-6, atol=1e-7, err_msg=key)
    for key in ("image", "depth", "weights_sum", "ambient_aud", "ambient_eye", "uncertainty"):
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=2e-5, atol=2e-5, err_msg=key)
    assert float(np.asarray(ref["uncertainty"]).max()) > 0.1
    # the static compaction keeps the first 8 rays with a valid sample, in order
    cj = jrend.plan_rays(jnp.asarray(b["rays_o"]), jnp.asarray(b["rays_d"]), dj, 1.0, 16,
                         n_candidates=16, n_steps=4, max_active_rays=8)
    cp = prend.plan_rays(t_(b["rays_o"]), t_(b["rays_d"]), dp, 1.0, 16, n_candidates=16,
                         n_steps=4, max_active_rays=8)
    np.testing.assert_array_equal(cp["sel"].numpy(), np.asarray(cj["sel"]))
    np.testing.assert_array_equal(cp["valid"].numpy(), np.asarray(cj["valid"]))


def test_update_density_grid_matches_jax(nets):
    jnet, variables, pnet = nets
    auds = np.random.default_rng(3).standard_normal((8, 44, 16)).astype(np.float32)
    dj, _ = occupancy(4)
    old = np.random.default_rng(5).uniform(0, 3, 16**3).astype(np.float32)
    old[:40] = -1.0                                  # untrained cells stay −1
    dj = jrend.DensityGrid(grid=jnp.asarray(old), occupancy=dj.occupancy,
                           mean_density=jnp.zeros(()))
    state_j = jtrain.NeRFTrainState(variables["params"], None, None, dj, jnp.zeros((), jnp.int32))
    tcfg = jtrain.NeRFTrainConfig(**TRAIN)
    ref = jtrain.refresh_density_grid(jnet, state_j, jnp.asarray(auds), tcfg).density
    state_p = ptrain.NeRFTrainState(network=pnet, optimizer=None,
                                    density=density_from_flax(dj))
    got = ptrain.refresh_density_grid(state_p, t_(auds), ptrain.NeRFTrainConfig(**TRAIN)).density
    grid_ref = np.asarray(ref.grid)
    np.testing.assert_array_equal(got.grid.numpy()[:40], -1.0)
    np.testing.assert_allclose(got.grid.numpy(), grid_ref, rtol=2e-5, atol=0)
    np.testing.assert_allclose(float(got.mean_density), float(ref.mean_density), rtol=2e-5)
    # occupancy agrees wherever the cell is not within the tolerance of the threshold
    thresh = min(float(ref.mean_density), tcfg.density_thresh)
    clear = np.abs(grid_ref - thresh) > 2e-5 * np.abs(grid_ref)
    occ_ref = np.asarray(ref.occupancy)
    assert 0 < occ_ref.mean() < 1
    np.testing.assert_array_equal(got.occupancy.numpy()[clear], occ_ref[clear])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    pprov.synthesize_nerf_train_data(root, n_frames=3, hw=32)
    return root


def test_synthesized_data_matches_jax(scene, tmp_path):
    other = jprov.synthesize_nerf_train_data(str(tmp_path / "jax"), n_frames=3, hw=32)
    for name in ("transforms.json", "au.csv", "aud.npy", "gt_imgs/0.png", "gt_imgs/2.png"):
        with open(os.path.join(scene, name), "rb") as a, open(os.path.join(other, name),
                                                               "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("preload", [0, 1, 2])
def test_train_dataset_batches_match_jax(scene, preload):
    dj = jprov.NeRFTrainDataset.load(scene, scale=1.0, preload=preload)
    dp = pprov.NeRFTrainDataset.load(scene, scale=1.0, preload=preload, device=CPU)
    assert len(dp) == len(dj) == 3 and (dp.H, dp.W) == (dj.H, dj.W) == (32, 32)
    assert isinstance(dp.images, pprov.LazyFrames) == (preload == 0)
    assert (dp.images_dev is not None) == (preload == 2)
    np.testing.assert_array_equal(dp.poses, dj.poses)
    np.testing.assert_array_equal(dp.auds, dj.auds)
    np.testing.assert_array_equal(dp.eye_area, dj.eye_area)
    np.testing.assert_array_equal(dp.face_masks, dj.face_masks)
    np.testing.assert_array_equal(dp.images[1], dj.images[1])
    assert dp.intrinsics == dj.intrinsics
    for index in (0, 2):
        bj = dj.sample_rays(index, 64, np.random.default_rng(7))
        bp = dp.sample_rays(index, 64, np.random.default_rng(7))
        assert set(bp) == set(bj)
        assert bp["index"] == int(bj["index"])
        for key in ("rgb", "bg_color", "auds", "eye", "face_mask"):
            np.testing.assert_array_equal(bp[key].numpy(), np.asarray(bj[key]), err_msg=key)
        for key in ("rays_o", "rays_d"):
            np.testing.assert_allclose(bp[key].numpy(), np.asarray(bj[key]), rtol=0,
                                       atol=1e-7, err_msg=key)


@pytest.fixture(scope="module")
def lips_scene(tmp_path_factory):
    """A 64² scene with landmark files (gt_imgs/<i>.lms), for the patch and
    lips batches, the LPIPS steps and the fine-tuning CLI."""
    root = str(tmp_path_factory.mktemp("lips_scene"))
    pprov.synthesize_nerf_train_data(root, n_frames=3, hw=64)
    write_lms(root, 3, 64)
    return root


def test_lms_lips_rects_match_jax(lips_scene, scene, tmp_path):
    dj = jprov.NeRFTrainDataset.load(lips_scene, scale=1.0)
    dp = pprov.NeRFTrainDataset.load(lips_scene, scale=1.0, device=CPU)
    assert dp.lips_rects.dtype == np.int32 and dp.lips_rects.shape == (3, 4)
    np.testing.assert_array_equal(dp.lips_rects, dj.lips_rects)
    # the landmarks' y are rows: a mouth wider than tall gives a square rect
    rmin, rmax, cmin, cmax = dp.lips_rects[0]
    assert rmax - rmin == cmax - cmin > 0
    # no .lms: no rects, as in JAX; frame 0 with one and a later frame without: both raise
    assert pprov.NeRFTrainDataset.load(scene, scale=1.0, device=CPU).lips_rects is None
    other = shutil.copytree(lips_scene, str(tmp_path / "some_lms"))
    os.remove(os.path.join(other, "gt_imgs", "2.lms"))
    with pytest.raises(FileNotFoundError, match="frame 2 has no .lms"):
        jprov.NeRFTrainDataset.load(other, scale=1.0)
    with pytest.raises(FileNotFoundError, match="frame 2 has no .lms"):
        pprov.NeRFTrainDataset.load(other, scale=1.0, device=CPU)


@pytest.mark.parametrize("preload", [0, 1, 2])
def test_patch_and_lips_batches_match_jax(lips_scene, preload):
    """Patch batches (two 32² patches) and the 32² lips window equal JAX's
    at every preload tier: the same pixels, patch-major and row-major."""
    dj = jprov.NeRFTrainDataset.load(lips_scene, scale=1.0, preload=preload)
    dp = pprov.NeRFTrainDataset.load(lips_scene, scale=1.0, preload=preload, device=CPU)
    rng_j, rng_p, rng_t = (np.random.default_rng(5) for _ in range(3))
    for index, kind in ((0, "patch"), (2, "patch"), (1, "lips"), (2, "lips")):
        if kind == "patch":
            bj = dj.sample_rays(index, 2048, rng_j, patch_size=32)
            bp = dp.sample_rays(index, 2048, rng_p, patch_size=32)
            corners = list(zip(rng_t.integers(0, 32, 2), rng_t.integers(0, 32, 2)))
        else:
            bj = dj.sample_lips_rays(index, rng_j, size=32)
            bp = dp.sample_lips_rays(index, rng_p, size=32)
            rmin, rmax, cmin, cmax = dp.lips_rects[index]
            corners = [(int(np.clip((rmin + rmax) // 2 - 16, 0, 32)),
                        int(np.clip((cmin + cmax) // 2 - 16, 0, 32)))]
        assert set(bp) == set(bj) and bp["index"] == int(bj["index"])
        for key in ("rgb", "bg_color", "auds", "eye", "face_mask"):
            np.testing.assert_array_equal(bp[key].numpy(), np.asarray(bj[key]),
                                          err_msg=f"{kind} {key}")
        for key in ("rays_o", "rays_d"):
            np.testing.assert_allclose(bp[key].numpy(), np.asarray(bj[key]), rtol=0,
                                       atol=1e-7, err_msg=f"{kind} {key}")
        # each 32² block of rays is one row-major square of the frame
        _, rays_d = prend.get_rays(t_(dp.poses[index]), dp.intrinsics, 64, 64)
        rays_d = rays_d.reshape(64, 64, 3)
        got = bp["rays_d"].reshape(-1, 32, 32, 3)
        assert got.shape[0] == len(corners)
        for block, (y0, x0) in zip(got, corners):
            assert torch.equal(block, rays_d[y0:y0 + 32, x0:x0 + 32]), (kind, y0, x0)
    assert rng_p.random() == rng_j.random() == rng_t.random()     # the same draws
    with pytest.raises(ValueError, match="multiple of patch_size"):
        dp.sample_rays(0, 1000, rng_p, patch_size=32)


def test_optimizer_groups_match_optax(nets):
    jnet, variables, _ = nets
    tcfg_j = jtrain.NeRFTrainConfig(**TRAIN)
    tx, state_j = jtrain.init_nerf_train(jnet, variables, tcfg_j)
    pnet = port_net(variables)
    state_p = ptrain.init_nerf_train(pnet, ptrain.NeRFTrainConfig(**TRAIN))
    params_j, opt_j = state_j.params, state_j.opt_state
    rng = np.random.default_rng(8)
    names = dict(pnet.named_parameters())
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params_j)
        updates, opt_j = tx.update(grads, opt_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for name, g in ernerf_from_flax({"params": grads}, pnet.cfg).items():
            names[name].grad = g
        state_p.optimizer.step()
    want = ernerf_from_flax({"params": params_j}, pnet.cfg)
    groups = {ptrain.param_group(n) for n in want}
    assert groups == {"grid", "net", "att"}
    for name, p in pnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def recording_tx():
    """An optax transform that applies nothing and keeps the last gradients
    in its state: the public way to read the JAX step's gradients."""
    return optax.GradientTransformation(
        lambda params: {"grads": jax.tree_util.tree_map(jnp.zeros_like, params)},
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), {"grads": grads}))


def test_train_step_matches_jax(nets):
    jnet, variables, _ = nets
    tcfg_j = jtrain.NeRFTrainConfig(**TRAIN)
    tx = recording_tx()
    # a fully occupied grid, as tests/test_nerf_train.py trains: on a random
    # occupancy grid the jitted JAX planner moves a few rays' spans against
    # its own eager run (a candidate on a voxel face rounds across it), which
    # test_render_rays_with_extras_matches_jax covers eagerly
    dj = jrend.DensityGrid.create(TRAIN["grid_size"])
    dp = density_from_flax(dj)
    # halfway through training, so every step-factor term of the loss is on
    state_j = jtrain.NeRFTrainState(variables["params"], tx.init(variables["params"]),
                                    variables["params"], dj, jnp.asarray(500, jnp.int32))
    b = make_batch(256, seed=10)
    key = jax.random.key(3)
    new_j, m_j = jtrain.make_nerf_train_step(jnet, tx, tcfg_j)(state_j, jax_batch(b), key)
    noise = np.asarray(jax.random.uniform(key, (256, 3)))      # the step's jitter draw
    want = ernerf_from_flax({"params": new_j.opt_state["grads"]}, JNetConfig(**NET))

    pnet = port_net(variables)
    tcfg_p = ptrain.NeRFTrainConfig(**TRAIN)
    state_p = ptrain.init_nerf_train(pnet, tcfg_p)
    state_p.density, state_p.step = dp, 500
    m_p = ptrain.compute_grads(state_p, torch_batch(b), tcfg_p, t_(noise))
    for key in ("loss", "mse", "weights_sum", "grad_norm"):
        np.testing.assert_allclose(float(m_p[key]), float(m_j[key]), rtol=1e-6, err_msg=key)
    for name, p in pnet.named_parameters():
        ref = want[name].numpy()
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, atol=2e-5 * scale,
                                   err_msg=name)
    # the step itself: one optimiser update, the EMA, the step count
    before = {n: p.detach().clone() for n, p in pnet.named_parameters()}
    step = ptrain.make_nerf_train_step(tcfg_p)
    m2 = step(state_p, torch_batch(b), noise=t_(noise))
    assert state_p.step == 501 and np.isfinite(float(m2["loss"]))
    for name, p in pnet.named_parameters():
        ema = state_p.ema[name]
        np.testing.assert_allclose(ema.numpy(), (0.95 * before[name] + 0.05 * p.detach()).numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.fixture(scope="module")
def lpips_pair():
    """(the JAX package's make_lpips_fn() weights, the port's LPIPS with them)."""
    variables = jax.jit(jlpips.LPIPS().init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                             jnp.zeros((1, 32, 32, 3)))
    module = plpips.LPIPS()
    module.load_state_dict(lpips_from_flax(jax.tree_util.tree_map(np.array, variables)),
                           strict=True)
    return variables, module


def lpips_batch(root: str, kind: str, n_patches: int = 1, camera_rays: bool = True) -> dict:
    """A numpy batch of frame 1 of the scene at root: n_patches 32² patches
    or the 32² lips window; with ``camera_rays`` False its rays are
    make_batch's instead of the camera's."""
    ds = jprov.NeRFTrainDataset.load(root, scale=1.0)
    rng = np.random.default_rng(2)
    bj = (ds.sample_rays(1, n_patches * 1024, rng, patch_size=32) if kind == "patch"
          else ds.sample_lips_rays(1, rng, size=32))
    b = {k: np.asarray(v) for k, v in bj.items()}
    b["index"] = int(b["index"])
    if not camera_rays:
        b.update({k: v for k, v in make_batch(len(b["rgb"]), seed=12).items()
                  if k in ("rays_o", "rays_d")})
    return b


def lpips_step_config(kind: str) -> tuple[float, bool]:
    """(LPIPS weight, uncertainty loss) of the CLI's patch and lips steps."""
    return (0.1, True) if kind == "patch" else (0.01, False)


def port_lpips_grads(variables, module, b: dict, kind: str, noise, dtype=torch.float32):
    """The port's step gradients and metrics from the JAX variables, at 500
    of 1000 iterations on a full grid, in ``dtype``."""
    weight, unc_loss = lpips_step_config(kind)
    pnet = port_net(variables).to(dtype)
    tcfg = ptrain.NeRFTrainConfig(**TRAIN, unc_loss=unc_loss)
    state = ptrain.init_nerf_train(pnet, tcfg)
    state.density, state.step = density_from_flax(
        jrend.DensityGrid.create(TRAIN["grid_size"])), 500
    lp = plpips.LPIPS()
    lp.load_state_dict(module.state_dict())
    fn = plpips.make_lpips_fn(module=lp.to(dtype), device=CPU)
    batch = {k: v.to(dtype) if k != "index" and v.is_floating_point() else v
             for k, v in torch_batch(b).items()}
    m = ptrain.compute_grads(state, batch, tcfg, noise.to(dtype), lpips_fn=fn,
                             patch_hw=(32, 32), lpips_weight=weight)
    plain, _ = ptrain.nerf_loss(state, batch, tcfg, noise.to(dtype))
    return m, {n: p.grad for n, p in pnet.named_parameters()}, float(plain.detach())


@pytest.mark.parametrize("kind", ["patch", "lips"])
def test_lpips_train_steps_match_jax(nets, lips_scene, lpips_pair, kind):
    """One patch step (a 32² patch's colours, 0.1 × LPIPS) and one lips step
    (the 32² window's, 0.01 × LPIPS, no uncertainty loss) against JAX's,
    within test_train_step_matches_jax's tolerances, on that test's rays.
    Jitted JAX is no reference on the camera's rays or at 2,048 rays: its
    gradients there read 1.4e-4 and 1.8e-3 of their largest entry from the
    float64 step, where eager JAX's and the port's read 6.5e-7 to 3e-6
    (ROADMAP §3). The camera's rays and two patches are held to float64
    below."""
    jnet, variables, _ = nets
    lp_vars, lp_module = lpips_pair
    weight, unc_loss = lpips_step_config(kind)
    tx = recording_tx()
    dj = jrend.DensityGrid.create(TRAIN["grid_size"])
    state_j = jtrain.NeRFTrainState(variables["params"], tx.init(variables["params"]),
                                    variables["params"], dj, jnp.asarray(500, jnp.int32))
    b = lpips_batch(lips_scene, kind, camera_rays=False)
    key = jax.random.key(4)
    step = jtrain.make_nerf_train_step(
        jnet, tx, jtrain.NeRFTrainConfig(**TRAIN, unc_loss=unc_loss),
        lpips_fn=jlpips.make_lpips_fn(variables=lp_vars), patch_hw=(32, 32),
        lpips_weight=weight)
    new_j, m_j = step(state_j, jax_batch(b), key)
    noise = t_(np.asarray(jax.random.uniform(key, b["rays_o"].shape)))
    want = ernerf_from_flax({"params": new_j.opt_state["grads"]}, JNetConfig(**NET))
    m_p, grads, plain = port_lpips_grads(variables, lp_module, b, kind, noise)
    for name in ("loss", "mse", "weights_sum", "grad_norm"):
        np.testing.assert_allclose(float(m_p[name]), float(m_j[name]), rtol=1e-6, err_msg=name)
    for name, g in grads.items():
        ref = want[name].numpy()
        scale = float(np.abs(ref).max())
        # without the uncertainty loss (lips) nothing reaches the uncertainty head
        assert scale > 0 or (not unc_loss and name.startswith("unc_net.")), name
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=2e-5 * scale, err_msg=name)
    # the LPIPS term is in the loss: without it the loss moves past the tolerance
    assert abs(plain - float(m_p["loss"])) > 1e-4 * abs(float(m_p["loss"]))


def test_lpips_patch_step_of_two_patches_matches_float64(nets, lips_scene, lpips_pair):
    """Two 32² patches on the camera's rays (the LPIPS term's mean over
    patches): the port's f32 step against its own float64 step, within
    test_train_step_matches_jax's tolerances."""
    _, variables, _ = nets
    b = lpips_batch(lips_scene, "patch", n_patches=2)
    noise = t_(np.random.default_rng(6).random(b["rays_o"].shape, np.float32))
    m32, g32, _ = port_lpips_grads(variables, lpips_pair[1], b, "patch", noise)
    m64, g64, _ = port_lpips_grads(variables, lpips_pair[1], b, "patch", noise, torch.float64)
    for name in ("loss", "mse", "weights_sum", "grad_norm"):
        np.testing.assert_allclose(float(m32[name]), float(m64[name]), rtol=1e-6, err_msg=name)
    for name, g in g32.items():
        ref = g64[name].numpy()
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.double().numpy(), ref, rtol=0, atol=2e-5 * scale,
                                   err_msg=name)


class FakeClock:
    """A perf_counter that moves only when told to."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self) -> float:
        return self.now


def drive_viewer(viewer_mod, monkeypatch, durations) -> tuple[list, list]:
    """Tick a viewer of viewer_mod 200 times under a fake clock: each
    iteration takes durations[it][0] ms of training, each render
    durations[it][1] ms. Returns (train_steps after every tick, the stats
    after every render)."""
    clock = FakeClock()
    monkeypatch.setattr(viewer_mod, "time", clock)
    it_box = [0]

    def render_fn(state, pose, intrinsics):
        clock.now += durations[it_box[0]][1] / 1e3
        return np.full((16, 16, 3), 0.5, np.float32)

    v = viewer_mod.TrainingViewer(render_fn, width=16, height=16, port=0)
    steps, stats = [], []
    try:
        for it in range(len(durations)):
            it_box[0] = it
            clock.now += durations[it][0] / 1e3
            v.tick(object(), it, {"loss": 0.5 / (it + 1)})
            steps.append(v.train_steps)
            if not stats or v.stats["step"] != stats[-1]["step"]:
                stats.append(dict(v.stats))
    finally:
        v.close()
    return steps, stats


def test_viewer_train_steps_match_jax(monkeypatch):
    """The retarget rule: the same train_steps sequence and stats as the JAX
    viewer's under the same clock, with training at 2-200 ms an iteration."""
    from mere_fusion_tpu.train import viewer as jviewer
    from mere_fusion_tpu_torch.train import viewer as pviewer

    rng = np.random.default_rng(9)
    train_ms = np.repeat(rng.choice([2.0, 20.0, 45.0, 200.0], 10), 20)
    durations = list(zip(train_ms * rng.uniform(0.9, 1.1, 200), rng.uniform(5, 50, 200)))
    want = drive_viewer(jviewer, monkeypatch, durations)
    got = drive_viewer(pviewer, monkeypatch, durations)
    assert got == want
    assert set(got[0]) >= {4, 16} and len(set(got[0])) >= 3
    assert len(got[1]) > 10 and got[1][-1]["step"] > 180


def test_viewer_http_contract():
    """/stats, the MJPEG /preview, POST /camera re-rendering the moved view,
    400 on a bad body, 404 elsewhere; close ends the open /preview stream."""
    import urllib.error
    import urllib.request

    from mere_fusion_tpu_torch.train.viewer import TrainingViewer

    poses = []

    def render_fn(state, pose, intrinsics):
        poses.append(pose.copy())
        img = np.zeros((32, 32, 3), np.float32)
        img[8:24, 8:24] = [0.2, 0.5, 0.9]
        return img

    v = TrainingViewer(render_fn, width=32, height=32, port=0)
    url = f"http://127.0.0.1:{v.port}"
    stream = None
    try:
        for it in range(16):
            v.tick(object(), it, {"loss": 0.5})
        assert len(poses) == 1
        with urllib.request.urlopen(url + "/stats", timeout=5) as r:
            stats = json.loads(r.read())
        assert stats["step"] == 15 and stats["loss"] == 0.5 and 4 <= stats["train_steps"] <= 16
        stream = urllib.request.urlopen(url + "/preview", timeout=5)
        assert stream.headers["Content-Type"].startswith("multipart/x-mixed-replace")
        head = stream.read(64)
        assert b"--mjpeg" in head and b"image/jpeg" in head
        req = urllib.request.Request(url + "/camera", data=json.dumps({"dx": 400.0}).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=5) as r:
            assert json.loads(r.read())["ok"] is True
        assert len(poses) == 2 and not np.allclose(poses[1], poses[0])
        for path, data, code in (("/camera", b"{bad", 400), ("/nothing", None, 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(urllib.request.Request(url + path, data=data), timeout=5)
            assert err.value.code == code
    finally:
        v.close()
    # the stream ends with the viewer (the JAX one's stays open)
    rest = stream.read()
    stream.close()
    assert rest.count(b"--mjpeg") <= 2


def test_checkpointer_keeps_the_newest(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ws"), max_keep=2)
    assert ckpt.latest_step is None
    for step in (5, 10, 20):
        ckpt.save(step, {"x": torch.full((2,), float(step)), "step": step}, {"loss": 1.0})
    assert ckpt.steps() == [10, 20] and ckpt.latest_step == 20
    assert not [n for n in os.listdir(ckpt.directory) if n.endswith(".tmp")]
    np.testing.assert_array_equal(ckpt.restore()["x"].numpy(), [20.0, 20.0])
    assert ckpt.restore(10)["step"] == 10
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore()


EVAL_RTOL = 1e-5
TOY_FLAGS = ["--device", "cpu", "--num_levels", "4", "--base_resolution", "16",
             "--desired_resolution", "64", "--log2_hashmap_size", "10", "--grid_size", "16",
             "--num_rays", "128"]


def test_cli_trains_checkpoints_and_resumes(scene, tmp_path, capsys):
    ws = str(tmp_path / "ws")
    ernerf_cli.main([scene, "--workspace", ws, "--iters", "3", *TOY_FLAGS])
    assert Checkpointer(ws).steps() == [3]
    with open(os.path.join(ws, "scalars.jsonl")) as f:
        rec = [json.loads(line) for line in f]
    assert rec[0]["step"] == 0 and np.isfinite(rec[0]["loss"]) and rec[0]["it_per_s"] > 0
    ernerf_cli.main([scene, "--workspace", ws, "--iters", "5", *TOY_FLAGS])
    assert "resumed from step 3" in capsys.readouterr().out
    assert Checkpointer(ws).steps() == [3, 5]
    assert Checkpointer(ws).restore()["step"] == 5


@pytest.mark.parametrize("argv,scale", [([], 4.0), (["--scale", "0.0025"], 0.0025)],
                         ids=["default", "given"])
def test_cli_scale_reaches_the_loader(scene, monkeypatch, argv, scale):
    """--scale (the upstream ER-NeRF main.py's flag; the JAX CLI always loads
    at the default 4) is the scale the CLI loads its dataset at."""
    seen = {}

    class Loaded(Exception):
        pass

    def load(root, **kw):
        seen.update(kw)
        raise Loaded

    monkeypatch.setattr(pprov.NeRFTrainDataset, "load", load)
    with pytest.raises(Loaded):
        ernerf_cli.main([scene, "--iters", "1", *argv, *TOY_FLAGS])
    assert seen["scale"] == scale


def converted_workspaces(nets, root: str, tmp_path) -> tuple:
    """A JAX workspace (orbax) and a port workspace (ckpt-<step>.pt) holding
    the same EMA weights (the widened tables) and a full density grid.
    Returns (JAX workspace, port workspace, the JAX net config)."""
    from mere_fusion_tpu.utils.checkpoint import Checkpointer as JCheckpointer

    jnet, variables, _ = nets
    tcfg_j = jtrain.NeRFTrainConfig(**TRAIN)
    _, state_j = jtrain.init_nerf_train(jnet, variables, tcfg_j)
    dj = jrend.DensityGrid(grid=jnp.full((16**3,), 20.0), occupancy=jnp.ones((16**3,), bool),
                           mean_density=jnp.asarray(20.0))
    state_j = state_j._replace(density=dj, step=jnp.asarray(7, jnp.int32))
    ws_j, ws_p = str(tmp_path / "ws_jax"), str(tmp_path / "ws_port")
    ckpt = JCheckpointer(ws_j)
    ckpt.save(7, state_j, {"loss": 0.0})
    ckpt.close()
    state_p = ptrain.init_nerf_train(port_net(variables), ptrain.NeRFTrainConfig(**TRAIN))
    state_p.density, state_p.step = density_from_flax(dj), 7
    Checkpointer(ws_p).save(7, state_p.state_dict(), {"loss": 0.0})
    return ws_j, ws_p


def test_evaluate_matches_jax(nets, lips_scene, tmp_path, capsys, monkeypatch):
    """--test's eval.json against the JAX package's _evaluate on the same
    converted workspace: every frame rendered whole at 64² on white.

    The JAX package's --test fails on its own workspaces: restore_raw gives
    numpy arrays, which its jitted render closes over, and grid_encode then
    indexes a numpy table with a traced index (ROADMAP §3). The reference
    run here gets the restored tree as jax arrays."""
    import argparse

    from mere_fusion_tpu.train import ernerf_cli as jcli
    from mere_fusion_tpu.utils.checkpoint import Checkpointer as JCheckpointer

    ws_j, ws_p = converted_workspaces(nets, lips_scene, tmp_path)
    tcfg_j = jtrain.NeRFTrainConfig(grid_size=16)
    ds_j = jprov.NeRFTrainDataset.load(lips_scene, scale=1.0)
    args_j = argparse.Namespace(workspace=ws_j)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jcli._evaluate(args_j, ds_j, JNetConfig(**NET), tcfg_j)
    restore_raw = JCheckpointer.restore_raw
    monkeypatch.setattr(JCheckpointer, "restore_raw", lambda self, step=None: jax.tree.map(
        jnp.asarray, restore_raw(self, step)))
    jcli._evaluate(args_j, ds_j, JNetConfig(**NET), tcfg_j)
    ernerf_cli._evaluate(argparse.Namespace(workspace=ws_p),
                         pprov.NeRFTrainDataset.load(lips_scene, scale=1.0, device=CPU),
                         NeRFNetConfig(**NET), ptrain.NeRFTrainConfig(grid_size=16), CPU)
    reports = []
    for ws in (ws_j, ws_p):
        with open(os.path.join(ws, "eval.json")) as f:
            reports.append(json.load(f))
    want, got = reports
    assert set(got) == set(want) == {"frames", "psnr", "ssim", "seconds"}
    assert got["frames"] == want["frames"] == 3
    assert 5 < got["psnr"] < 60 and 0 < got["ssim"] < 1
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=EVAL_RTOL)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=EVAL_RTOL)
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("[test] PSNR = ") and "3 frames in" in out[-1]


def test_viewer_preview_matches_jax(nets, lips_scene):
    """The viewer's render of the current weights against the JAX CLI's
    render closure (2e-5), and that frame over HTTP as an MJPEG part."""
    import urllib.request

    import cv2

    from mere_fusion_tpu.train import ernerf_cli as jcli
    from mere_fusion_tpu_torch.train.viewer import TrainingViewer

    jnet, variables, pnet = nets
    dj = jrend.DensityGrid(grid=jnp.full((16**3,), 20.0), occupancy=jnp.ones((16**3,), bool),
                           mean_density=jnp.asarray(20.0))
    tcfg_j = jtrain.NeRFTrainConfig(**TRAIN)
    ds_j = jprov.NeRFTrainDataset.load(lips_scene, scale=1.0)
    jrender = jcli._make_viewer_render(jnet, JNetConfig(**NET), tcfg_j, ds_j, 32)
    state_j = jtrain.NeRFTrainState(variables["params"], None, None, dj, None)
    state_p = ptrain.NeRFTrainState(network=pnet, optimizer=None, density=density_from_flax(dj))
    prender = ernerf_cli._make_viewer_render(
        ptrain.NeRFTrainConfig(**TRAIN),
        pprov.NeRFTrainDataset.load(lips_scene, scale=1.0, device=CPU), 32)
    v = TrainingViewer(prender, width=32, height=32, port=0)
    try:
        # the dataset's camera, mirrored by update_pose (ROADMAP §3), panned back to the head
        v.cam.update_pose(ds_j.poses[0])
        v.cam.pan(0, 0, -2e4 * v.cam.radius)
        pose, intr = v.cam.pose.astype(np.float32), v.cam.intrinsics.astype(np.float32)
        want = np.asarray(jrender(state_j, pose, intr))
        got = prender(state_p, pose, intr)
        assert got.shape == want.shape == (32, 32, 3) and got.dtype == np.float32
        assert want.std() > 0.01                  # not a blank frame
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
        for it in range(16):
            v.tick(state_p, it, {"loss": torch.tensor(0.25)})
        with urllib.request.urlopen(f"http://127.0.0.1:{v.port}/preview", timeout=10) as r:
            r.readline()
            r.readline()
            size = int(r.readline().split(b":")[1])
            r.readline()
            jpg = r.read(size)
        img = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
        assert img.shape == (32, 32, 3)
        assert np.abs(img.astype(float) - np.clip(want * 255, 0, 255)).mean() < 4   # JPEG q85
        assert v.stats["step"] == 15 and v.stats["loss"] == 0.25
    finally:
        v.close()


@pytest.mark.parametrize("flag", [["--test"], ["--patch_size", "32"],
                                  ["--finetune_lips", "--lips_size", "32"],
                                  ["--viewer_port", "0", "--viewer_size", "32"]],
                         ids=lambda f: f[0])
def test_cli_fine_tuning_flags_run(lips_scene, tmp_path, capsys, flag):
    """Each flag that raised before runs through the CLI at toy size: the
    patch and lips runs log finite losses and checkpoint, --test writes
    eval.json for every frame, the viewer serves during the run."""
    ws = str(tmp_path / "ws")
    argv = [lips_scene, "--workspace", ws, *TOY_FLAGS]
    if flag[0] == "--test":
        ernerf_cli.main([*argv, "--iters", "2"])
        ernerf_cli.main([*argv, *flag])
        with open(os.path.join(ws, "eval.json")) as f:
            report = json.load(f)
        assert report["frames"] == 3 and np.isfinite(report["psnr"]) and np.isfinite(
            report["ssim"])
        return
    rays = ["--num_rays", "1024"] if flag[0] == "--patch_size" else []
    ernerf_cli.main([*argv, *rays, "--iters", "18", *flag])
    assert Checkpointer(ws).steps() == [18]
    assert np.isfinite(Checkpointer(ws).restore()["network"]["plane_xy"]).all()
    with open(os.path.join(ws, "scalars.jsonl")) as f:
        rec = [json.loads(line) for line in f]
    assert rec[0]["step"] == 0 and np.isfinite(rec[0]["loss"])
    out = capsys.readouterr().out
    if flag[0] == "--viewer_port":
        assert "[train] viewer: http://127.0.0.1:" in out
