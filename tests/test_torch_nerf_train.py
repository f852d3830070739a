"""The ER-NeRF head-training slice of the PyTorch port against the JAX
package on the CPU at toy sizes (4 levels, 2^10 tables, grid 16, 16
candidates, 4 steps, 32² images, 3 frames, as tests/test_nerf_train.py
uses): the renderer's training path, the density refresh, the training
dataset and its preload tiers, the optimiser groups, one whole train step
and the CLI.

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
  scatter sums in another order).
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mere_fusion_tpu.data import provider as jprov
from mere_fusion_tpu.models.ernerf import renderer as jrend
from mere_fusion_tpu.models.ernerf.network import NeRFNetConfig as JNetConfig
from mere_fusion_tpu.models.ernerf.network import NeRFNetwork as JNetwork
from mere_fusion_tpu.train import ernerf_train as jtrain
from mere_fusion_tpu_torch.convert import density_from_flax, ernerf_from_flax
from mere_fusion_tpu_torch.data import provider as pprov
from mere_fusion_tpu_torch.models.ernerf import renderer as prend
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork
from mere_fusion_tpu_torch.train import ernerf_cli
from mere_fusion_tpu_torch.train import ernerf_train as ptrain
from mere_fusion_tpu_torch.utils.checkpoint import Checkpointer

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


def test_unported_batches_raise(scene):
    dp = pprov.NeRFTrainDataset.load(scene, scale=1.0, device=CPU)
    rng = np.random.default_rng(0)
    with pytest.raises(NotImplementedError, match="ER-NeRF LPIPS fine-tuning"):
        dp.sample_rays(0, 16, rng, patch_size=4)
    with pytest.raises(NotImplementedError, match="ER-NeRF LPIPS fine-tuning"):
        dp.sample_lips_rays(0, rng)


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


@pytest.mark.parametrize("flag", [["--test"], ["--patch_size", "16"],
                                  ["--finetune_lips"], ["--viewer_port", "0"]],
                         ids=lambda f: f[0])
def test_cli_unported_flags_raise(scene, tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP: 'ER-NeRF"):
        ernerf_cli.main([scene, "--workspace", str(tmp_path), *flag, *TOY_FLAGS])
    assert not os.listdir(tmp_path)
