"""The ER-NeRF torso in the PyTorch port against the JAX package, on the CPU:
the head at toy sizes (4 hash levels, 2^10 tables, 64² frames, 8 samples a
ray), the torso at its published widths (a 16-level × 2-channel tiled 2-D
grid of 2^16 rows a level, MLPs of 32), which the JAX network fixes.

- ``forward_torso`` and ``render_torso_background``: 2e-5 (ROADMAP's MLP
  rule); the tiled grid's encode, its table gradient and its position
  gradient at the clip edges x = ±1 (x01 = 1 falls in the last cell), at the
  coarse levels (a dense table) and the fine ones (rows wrap): 2e-5 of
  each one's largest value;
- the K2 step (plain K2 against the Pallas kernel in interpret mode, the
  torso composite cached as bf16) and the baked ``nearest`` step (the torso
  in f32 every frame): uint8 frames within 1 LSB, as
  ``test_frame_step_matches_jax``;
- ``sample_torso_rays``: the same pixels, exactly;
- three torso train steps against the jitted JAX step, the torso grid cut
  to its coarse levels: the loss (1e-6 relative) and each gradient (2e-5
  of its largest entry) from the same state, and the Adam update and EMA
  on the same gradients (2e-5 of the largest value), the frozen head
  unchanged;
- the CLI's ``--torso --head_ckpt`` stage, and ``make_engine`` serving its
  workspace.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import write_torso_imgs
from mere_fusion_tpu.config import Config as JConfig
from mere_fusion_tpu.data import provider as jprov
from mere_fusion_tpu.engines.nerf import make_nerf_render_step
from mere_fusion_tpu.engines.nerf_pallas import make_pallas_render_step
from mere_fusion_tpu.models.ernerf import renderer as jrend
from mere_fusion_tpu.models.ernerf.network import NeRFNetConfig as JNetConfig
from mere_fusion_tpu.models.ernerf.network import NeRFNetwork as JNetwork
from mere_fusion_tpu.ops import hashgrid as jgrid
from mere_fusion_tpu.ops.triplane_bake import bake_triplanes as j_bake
from mere_fusion_tpu.train import ernerf_train as jtrain
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.convert import density_from_flax, ernerf_from_flax
from mere_fusion_tpu_torch.data import provider as pprov
from mere_fusion_tpu_torch.engines import make_engine
from mere_fusion_tpu_torch.engines.nerf import NeRFReal
from mere_fusion_tpu_torch.engines.nerf_baked import make_baked_render_step
from mere_fusion_tpu_torch.engines.nerf_step import make_render_step
from mere_fusion_tpu_torch.models.ernerf import renderer as prend
from mere_fusion_tpu_torch.models.ernerf.network import (
    TORSO_PARAMS,
    TORSO_SPEC,
    NeRFNetConfig,
    NeRFNetwork,
    init_ernerf_,
    is_torso_param,
)
from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
from mere_fusion_tpu_torch.ops import hashgrid as pgrid
from mere_fusion_tpu_torch.train import ernerf_cli
from mere_fusion_tpu_torch.train import ernerf_train as ptrain
from mere_fusion_tpu_torch.utils.checkpoint import Checkpointer
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
NET = dict(num_levels=4, base_resolution=16, desired_resolution=64, log2_hashmap_size=10,
           torso=True, num_train_frames=3)
OVERRIDES = {
    "nerf.grid_size": 16, "nerf.num_levels": 4, "nerf.base_resolution": 16,
    "nerf.desired_resolution": 64, "nerf.log2_hashmap_size": 10, "nerf.max_steps": 8,
    "nerf.torso": True,
}
J_TORSO_SPEC = jgrid.GridSpec(input_dim=2, num_levels=16, level_dim=2, base_resolution=16,
                              log2_hashmap_size=16, desired_resolution=2048, gridtype="tiled")
COARSE_LEVELS = 3      # the torso grid's levels that the train-step test keeps
EDGES = np.asarray([[-1, -1], [1, 1], [1, -1], [-1, 1], [0, 1], [1, 0], [-1, 0.3]], np.float32)


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def assert_close(got, want, tol, name=""):
    """Within tol of the reference's largest magnitude (equal where it is 0)."""
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale, err_msg=name)


@pytest.fixture(scope="module")
def nets():
    """(JAX network, its variables, the port's network with those weights):
    the head's tables and the torso grid widened to U(−1, 1) so that every
    feature shows, and the anchors moved off their initial values."""
    jnet = JNetwork(JNetConfig(**NET))
    variables = jax.jit(jnet.init, static_argnames="method")(
        jax.random.key(0), jnp.zeros((8, 44, 16)), jnp.zeros((4, 3)),
        jnp.ones((4, 3)) / np.sqrt(3.0), jnp.zeros((1, 4)), jnp.zeros((1, 1)),
        method=JNetwork.full_init)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(5)
    for name in ("plane_xy", "plane_yz", "plane_xz", "torso_grid"):
        params[name] = rng.uniform(-1, 1, params[name].shape).astype(np.float32)
    params["anchor_points"] = (params["anchor_points"]
                               + rng.uniform(-0.05, 0.05, (3, 4)).astype(np.float32))
    variables = {"params": params}
    pnet = NeRFNetwork(NeRFNetConfig(**NET))
    pnet.load_state_dict(ernerf_from_flax(variables, NeRFNetConfig(**NET)), strict=True)
    return jnet, variables, pnet.eval()


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    d = pprov.synthesize_nerf_dataset(str(tmp_path_factory.mktemp("torsodata")), hw=64)
    kw = dict(scale=1.0, smooth_path=True, smooth_path_window=3, smooth_eye=True)
    return (jprov.NeRFTestDataset.load(f"{d}/transforms.json", f"{d}/au.csv", **kw),
            pprov.NeRFTestDataset.load(f"{d}/transforms.json", f"{d}/au.csv", **kw))


def torso_apply(jnet, variables):
    codes = variables["params"]["individual_codes_torso"]
    return lambda x, p: jnet.apply(variables, x, p, codes[:1], method=JNetwork.forward_torso)


def test_forward_torso_matches_jax(nets, datasets):
    jnet, variables, pnet = nets
    pose = datasets[1].poses[1]
    x = np.concatenate([EDGES, np.random.default_rng(3).uniform(-1, 1, (505, 2))
                        .astype(np.float32)])
    want = torso_apply(jnet, variables)(jnp.asarray(x), jnp.asarray(pose))
    with torch.no_grad():
        got = pnet.forward_torso(t_(x), t_(pose), pnet.torso_code())
    for name, g, w in zip(("alpha", "color", "dx"), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=2e-5, err_msg=name)
    assert float(np.abs(np.asarray(want[2])).max()) > 1e-3, "the deformation must move x"


def test_torso_grid_encode_and_gradients_match_jax():
    assert pgrid.GridSpec(**vars(J_TORSO_SPEC)) == TORSO_SPEC
    sides = [(res + 1) ** 2 <= h for _, res, h, _ in TORSO_SPEC.level_params()]
    assert any(sides) and not all(sides), "both dense and wrapped tiled levels"
    rng = np.random.default_rng(4)
    table = rng.uniform(-1, 1, (TORSO_SPEC.total_params, 2)).astype(np.float32)
    x = np.concatenate([EDGES, rng.uniform(-1, 1, (249, 2)).astype(np.float32)])
    gout = rng.standard_normal((x.shape[0], 32)).astype(np.float32)

    def jloss(tab, xx):
        return jnp.sum(jgrid.grid_encode(tab, xx, J_TORSO_SPEC, 1.0) * gout)

    want = jgrid.grid_encode(jnp.asarray(table), jnp.asarray(x), J_TORSO_SPEC, 1.0)
    gtab_w, gx_w = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    tab_t = t_(table).requires_grad_(True)
    x_t = t_(x).requires_grad_(True)
    got = pgrid.grid_encode(tab_t, x_t, TORSO_SPEC, 1.0)
    (got * t_(gout)).sum().backward()
    assert_close(got.detach().numpy(), want, 2e-5, "encode")
    assert_close(tab_t.grad.numpy(), gtab_w, 2e-5, "table gradient")
    assert_close(x_t.grad.numpy(), gx_w, 2e-5, "position gradient")


def test_render_torso_background_matches_jax(nets, datasets):
    jnet, variables, pnet = nets
    pose = datasets[1].poses[2]
    bg = np.random.default_rng(6).uniform(0, 1, (24 * 16, 3)).astype(np.float32)
    want, alpha_w = jrend.render_torso_background(torso_apply(jnet, variables), 24, 16,
                                                  jnp.asarray(pose), jnp.asarray(bg))
    with torch.no_grad():
        got, alpha = prend.render_torso_background(
            lambda x, p: pnet.forward_torso(x, p, pnet.torso_code()), 24, 16, t_(pose), t_(bg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(alpha_w), rtol=0, atol=2e-5)
    assert 0.02 < float(alpha.std()), "the torso's alpha must vary over the frame"


@pytest.fixture(scope="module")
def baked(nets):
    _, variables, _ = nets
    jb = j_bake(variables["params"], JNetConfig(**NET).plane_spec, 1.0, resolution=128,
                dtype=jnp.bfloat16)
    pb = {k: t_(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16) for k, v in jb.items()}
    return jb, pb


def run_frames(jstep, pstep, datasets, keys):
    """(index, pose_key) frames through both steps on a full grid and the
    dataset's background; every frame within 1 LSB."""
    jds, pds = datasets
    jdens = jrend.DensityGrid.create(16)
    pdens = density_from_flax(jdens)
    jbg, pbg = jnp.asarray(jds.bg_img.reshape(-1, 3)), t_(pds.bg_img.reshape(-1, 3))
    rng = np.random.default_rng(8)
    frames = []
    for index, key in keys:
        auds = rng.standard_normal((8, 44, 16)).astype(np.float32)
        jd, pd = jds.collate(index), pds.collate(index)
        kw = {} if key == "none" else {"pose_key": key}
        ji = jstep(jd["pose"], jnp.asarray(auds), jnp.asarray(jd["eye"]), jdens, jbg, **kw)
        pi = pstep(pd["pose"], t_(auds), pd["eye"], pdens, pbg, **kw)[0]
        ji = np.asarray(ji[0] if isinstance(ji, tuple) else ji)
        diff = np.abs(pi.numpy().astype(int) - ji.astype(int))
        assert diff.max() <= 1, f"frame {index} differs by {diff.max()} LSB"
        frames.append(pi.numpy())
    return frames


def test_k2_step_with_the_torso_matches_jax(nets, datasets, baked):
    jnet, variables, pnet = nets
    jds, pds = datasets
    jstep = make_pallas_render_step(jnet, variables, jds, JConfig().override(**OVERRIDES),
                                    baked=baked[0], interpret=True)
    pstep = make_render_step(pnet, pds, Config().override(**OVERRIDES), baked[1])
    frames = run_frames(jstep, pstep, datasets, [(0, 0), (0, 0), (1, None)])
    assert frames[0].std() > 2
    assert set(pstep.torso_cache) == {0}
    hit = pstep.torso_cache[0]
    assert hit.dtype == torch.bfloat16 and hit.shape == (64 * 64, 3)
    # the composite, not the background alone: the torso shows in the cache
    assert float((hit.float() - t_(pds.bg_img.reshape(-1, 3))).abs().max()) > 0.05
    # another background object drops the cache; warmup prefills it
    pstep(pds.poses[1], torch.zeros(8, 44, 16), pds.collate(1)["eye"],
          density_from_flax(jrend.DensityGrid.create(16)), torch.zeros(64 * 64, 3),
          pose_key=1)
    assert set(pstep.torso_cache) == {1}
    pstep.warmup(density_from_flax(jrend.DensityGrid.create(16)), torch.ones(64 * 64, 3))
    assert set(pstep.torso_cache) == set(range(len(pds)))


def test_baked_step_with_the_torso_matches_jax(nets, datasets, baked):
    jnet, variables, pnet = nets
    jds, pds = datasets
    over = {**OVERRIDES, "nerf.sample_mode": "nearest", "nerf.max_active_rays": 2048}
    jstep = make_nerf_render_step(jnet, variables, jds, JConfig().override(**over),
                                  baked=baked[0])
    pstep = make_baked_render_step(pnet, pds, Config().override(**over), baked[1])
    frames = run_frames(jstep, pstep, datasets, [(0, "none"), (2, "none")])
    # past the budget the frame is the torso composite, which differs by pose
    assert (frames[0][48:] != frames[1][48:]).any()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torso_scene"))
    pprov.synthesize_nerf_train_data(root, n_frames=3, hw=32)
    write_torso_imgs(root, 3, 32)
    return root


@pytest.mark.parametrize("preload", [0, 1])
def test_sample_torso_rays_match_jax(scene, preload):
    dj = jprov.NeRFTrainDataset.load(scene, scale=1.0, preload=preload)
    dp = pprov.NeRFTrainDataset.load(scene, scale=1.0, preload=preload, device=CPU)
    np.testing.assert_array_equal(dp.torso_imgs, dj.torso_imgs)
    assert dp.torso_imgs.shape == (3, 32, 32, 4) and dp.torso_imgs[0, -1, 16, 3] == 1.0
    for index in (0, 2):
        bj = dj.sample_torso_rays(index, 96, np.random.default_rng(7))
        bp = dp.sample_torso_rays(index, 96, np.random.default_rng(7))
        assert set(bp) == set(bj) and bp["index"] == int(bj["index"])
        for key in ("coords", "bg_torso_color", "bg_color", "pose"):
            assert bp[key].dtype == torch.float32
            np.testing.assert_array_equal(bp[key].numpy(), np.asarray(bj[key]), err_msg=key)
    dp.torso_imgs = None
    with pytest.raises(ValueError, match="torso_imgs"):
        dp.sample_torso_rays(0, 4, np.random.default_rng())


def torso_batch(seed: int, pose) -> dict:
    rng = np.random.default_rng(seed)
    n = 384
    return {"coords": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
            "bg_torso_color": rng.uniform(0, 1, (n, 3)).astype(np.float32),
            "bg_color": rng.uniform(0, 1, (n, 3)).astype(np.float32),
            "pose": np.asarray(pose, np.float32), "index": seed % 3}


def recording_tx():
    """An optax transform that applies nothing and keeps the last gradients
    in its state: the public way to read the JAX step's gradients."""
    return optax.GradientTransformation(
        lambda params: {"grads": jax.tree_util.tree_map(jnp.zeros_like, params)},
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), {"grads": grads}))


def test_torso_train_steps_match_jax(nets, datasets):
    """Three steps, each held in two parts against the jitted JAX step. The
    gradients: the port's from JAX's state before the step, each within 2e-5
    of its largest entry, which must exceed 1e-6. The update: the port's
    Adam and EMA on JAX's gradients. (Adam's first updates are ±lr for any
    gradient above eps, so an entry whose gradient is a sum that cancels to
    rounding noise would take opposite steps in two implementations that
    each run on their own gradients.)

    The torso grid keeps its widened U(−1, 1) values at the first
    COARSE_LEVELS levels (scales up to 29.6) and is zero above them, with
    the torso net's inputs from those levels cut (zero kernel rows), so they
    stay out of all three steps. At the grid's full depth the gradients of
    the grid and the deformation net are ill-conditioned in f32: x + dx from
    MLPs that sum in another order differs by ~3e-7, which the finest level
    (scale 2048) turns into ~1e-4 of those gradients' largest entries, at any
    table scale; the jitted and eager JAX steps differ from each other by as
    much (ROADMAP §3). The fine levels' encode and both gradients are held
    in test_torso_grid_encode_and_gradients_match_jax."""
    jnet, variables, _ = nets
    params = jax.tree_util.tree_map(np.array, variables["params"])
    fine = sum(lp[2] for lp in TORSO_SPEC.level_params()[:COARSE_LEVELS])  # first fine row
    params["torso_grid"][fine:] = 0
    params["torso_net"]["net_0"]["kernel"][2 * COARSE_LEVELS:32] = 0
    variables = {"params": params}
    tcfg_j = jtrain.NeRFTrainConfig(grid_size=16)
    tx, state_j = jtrain.init_torso_train(jnet, variables, tcfg_j)
    jstep = jtrain.make_torso_train_step(jnet, tx, tcfg_j)
    jgrads = jtrain.make_torso_train_step(jnet, recording_tx(), tcfg_j)
    cfg = NeRFNetConfig(**NET)
    tcfg_p = ptrain.NeRFTrainConfig(grid_size=16)

    def port_state(params):
        net = NeRFNetwork(cfg)
        net.load_state_dict(ernerf_from_flax({"params": params}, cfg), strict=True)
        return ptrain.init_torso_train(net, tcfg_p)

    state_p = port_state(variables["params"])          # driven by JAX's gradients
    before = {n: p.detach().clone() for n, p in state_p.network.named_parameters()}
    for i in range(3):
        b = torso_batch(i, datasets[1].poses[i])
        jb = {k: jnp.asarray(v, jnp.int32) if k == "index" else jnp.asarray(v)
              for k, v in b.items()}
        pb = {k: v if k == "index" else t_(v) for k, v in b.items()}
        rec = jtrain.NeRFTrainState(state_j.params, recording_tx().init(state_j.params),
                                    state_j.params, state_j.density, state_j.step)
        rec, m_rec = jgrads(rec, jb, jax.random.key(i))
        grads = ernerf_from_flax({"params": rec.opt_state["grads"]}, cfg)
        probe = port_state(state_j.params)              # the port's gradients
        m_p = ptrain.compute_torso_grads(probe, pb)
        for key in ("loss", "mse", "torso_alpha"):
            np.testing.assert_allclose(float(m_p[key]), float(m_rec[key]), rtol=1e-6,
                                       err_msg=key)
        for name, p in probe.network.named_parameters():
            if is_torso_param(name):
                assert float(grads[name].abs().max()) > 1e-6, f"{i} {name}"
                assert_close(p.grad.numpy(), grads[name].numpy(), 2e-5, f"{i} {name}")
            else:
                assert p.grad is None, name
        state_j, _ = jstep(state_j, jb, jax.random.key(i))
        for name, p in state_p.network.named_parameters():
            if is_torso_param(name):
                p.grad = grads[name].clone()
        ptrain.apply_update(state_p)
        want = ernerf_from_flax({"params": state_j.params}, cfg)
        want_ema = ernerf_from_flax({"params": state_j.ema_params}, cfg)
        for name, p in state_p.network.named_parameters():
            assert_close(p.detach().numpy(), want[name].numpy(), 2e-5, f"{i} {name}")
            assert_close(state_p.ema[name].numpy(), want_ema[name].numpy(), 2e-5,
                         f"{i} ema {name}")
    assert state_p.step == 3
    moved = {n.split(".")[0] for n, p in state_p.network.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    assert moved == set(TORSO_PARAMS), "the torso trains, the head stays"
    # moments only for the torso's parameters
    assert len(state_p.optimizer.state) == sum(is_torso_param(n) for n in before)


TOY_FLAGS = ["--device", "cpu", "--num_levels", "4", "--base_resolution", "16",
             "--desired_resolution", "64", "--log2_hashmap_size", "10", "--grid_size", "16",
             "--num_rays", "128"]


def test_cli_torso_stage_trains_freezes_and_serves(scene, tmp_path, capsys):
    head_ws, torso_ws = str(tmp_path / "head"), str(tmp_path / "torso")
    ernerf_cli.main([scene, "--workspace", head_ws, "--iters", "3", *TOY_FLAGS])
    ernerf_cli.main([scene, "--workspace", torso_ws, "--iters", "3", "--torso",
                     "--head_ckpt", head_ws, *TOY_FLAGS])
    out = capsys.readouterr().out
    assert "[torso] it 0  loss" in out and "[torso] done" in out
    assert Checkpointer(torso_ws).steps() == [3]
    head, torso = Checkpointer(head_ws).restore(), Checkpointer(torso_ws).restore()
    assert torso["step"] == 3
    seeded = init_ernerf_(NeRFNetwork(NeRFNetConfig(**NET)), 0).state_dict()
    for name, v in torso["network"].items():
        if is_torso_param(name):
            assert not torch.equal(v, seeded[name]), f"{name} did not train"
        else:
            assert torch.equal(v, head["network"][name]), f"{name} is not the frozen head"
    for name in ("grid", "occupancy", "mean_density"):
        assert torch.equal(torso["density"][name], head["density"][name])
    # the torso workspace serves the avatar: its EMA weights and the head's grid
    cfg = Config().override(**{
        **OVERRIDES, "avatar.kind": "ernerf", "tts.backend": "procedural",
        "nerf.pose_path": f"{scene}/transforms.json", "nerf.au_path": f"{scene}/au.csv",
        "nerf.ckpt": torso_ws})
    engine = make_engine(cfg, device=CPU)
    direct = NeRFReal(cfg.override(**{"nerf.ckpt": ""}), engine.dataset, device=CPU,
                      state=torso["ema"], density=DensityGrid(**torso["density"]))
    frames = []
    for e in (engine, direct):
        d = e.dataset.collate(0)
        frames.append(e._render_step(d["pose"], torch.zeros(8, 44, 16), d["eye"], e.density,
                                     e._bg_dev, pose_key=0)[0].numpy())
    np.testing.assert_array_equal(frames[0], frames[1])
    assert set(engine._render_step.torso_cache) == {0}
