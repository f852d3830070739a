"""ER-NeRF checkpoints in the PyTorch port, against the JAX package on the
CPU at toy sizes (4 hash levels, 2^10 tables, a 16³ grid, 64² frames): the
reference-checkpoint converter and the Morton density grid bit-equal to the
JAX converter's, ``load_nerf_checkpoint``'s checks, and ``make_engine``
serving a reference ``.pth`` (with torso keys) and a workspace of the
port's training CLI, each frame equal to the frame of a ``NeRFReal`` given
the same weights directly."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from chip_smoke import write_reference_pth
from mere_fusion_tpu.utils import torch_convert as jconv
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.convert import ernerf_from_flax
from mere_fusion_tpu_torch.data.provider import synthesize_nerf_dataset, synthesize_nerf_train_data
from mere_fusion_tpu_torch.engines import make_engine
from mere_fusion_tpu_torch.engines.nerf import NeRFReal, load_nerf_checkpoint
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork, init_ernerf_
from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
from mere_fusion_tpu_torch.train import ernerf_cli
from mere_fusion_tpu_torch.utils import torch_convert as pconv
from mere_fusion_tpu_torch.utils.checkpoint import Checkpointer
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
NET = dict(num_levels=4, base_resolution=16, desired_resolution=64, log2_hashmap_size=10)
G = 16
OVERRIDES = {
    "tts.backend": "procedural", "avatar.kind": "ernerf", "transport.mode": "loopback",
    "nerf.grid_size": G, "nerf.num_levels": 4, "nerf.base_resolution": 16,
    "nerf.desired_resolution": 64, "nerf.log2_hashmap_size": 10, "nerf.max_steps": 8,
    "nerf.scale": 1.0,
}


def seeded_state(torso: bool, frames: int = 3) -> dict:
    """A port network's state at toy widths, seed 0, tables widened to
    U(−1, 1) so that every feature shows."""
    net = init_ernerf_(NeRFNetwork(NeRFNetConfig(**NET, torso=torso, num_train_frames=frames)), 0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.startswith("plane_") or name == "torso_grid":
                p.uniform_(-1, 1, generator=gen)
    return net.state_dict()


def morton_grid(seed: int = 2) -> np.ndarray:
    """A reference density_grid [1, G³]: random densities in Morton order."""
    return np.random.default_rng(seed).uniform(-1, 30, (1, G ** 3)).astype(np.float32)


def write_pth(path: str, state: dict, prefix: str = "module.", wrap: bool = False) -> str:
    """A reference Trainer checkpoint of state with mean_density 7.5 and
    training stats holding a numpy scalar."""
    return write_reference_pth(path, state, morton_grid(), 7.5, prefix=prefix, wrap=wrap,
                               epoch=3, stats={"loss": [np.float64(0.25)]})


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt_scene"))
    synthesize_nerf_dataset(root, hw=64)
    return root


def serve_cfg(scene: str, **over) -> Config:
    return Config().override(**{**OVERRIDES, "nerf.pose_path": f"{scene}/transforms.json",
                                "nerf.au_path": f"{scene}/au.csv", **over})


def first_frame(engine: NeRFReal) -> np.ndarray:
    d = engine.dataset.collate(0)
    auds = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (8, 44, 16)).astype(np.float32))
    img, _, _ = engine._render_step(d["pose"], auds, d["eye"], engine.density,
                                    engine._bg_dev, pose_key=0)
    return img.numpy()


def test_convert_ernerf_and_density_match_jax(tmp_path):
    state = seeded_state(torso=True)
    path = write_pth(str(tmp_path / "ngp_kf.pth"), state)
    ckpt = jconv.load_torch_checkpoint(path)
    assert set(pconv.load_torch_checkpoint(path)) == set(ckpt)
    model = ckpt["model"]
    want, got = jconv.convert_ernerf(model), pconv.convert_ernerf(model)
    flat_w, flat_g = {}, {}

    def flatten(tree, out, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flatten(v, out, f"{prefix}{k}.")
            else:
                out[prefix + k] = v

    flatten(want, flat_w)
    flatten(got, flat_g)
    assert set(flat_g) == set(flat_w) and "params.torso_net.net_2.kernel" in flat_g
    for k, v in flat_w.items():
        assert flat_g[k].dtype == np.float32 and np.array_equal(flat_g[k], np.asarray(v)), k
    # the one mapping onto the port's names round-trips the weights exactly
    back = ernerf_from_flax(got, NeRFNetConfig(**NET, torso=True, num_train_frames=3))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k

    # the Morton grid, with mean_density from the top level and recomputed
    for mean in (ckpt["mean_density"], None):
        jd = jconv.density_from_ernerf(pconv.strip_prefix(model), G, 10.0, mean_density=mean)
        pd = pconv.density_from_ernerf(pconv.strip_prefix(model), G, 10.0, mean_density=mean)
        assert pd.grid.dtype == torch.float32 and pd.occupancy.dtype == torch.bool
        np.testing.assert_array_equal(pd.grid.numpy(), np.asarray(jd.grid))
        np.testing.assert_array_equal(pd.occupancy.numpy(), np.asarray(jd.occupancy))
        assert float(pd.mean_density) == float(jd.mean_density)
    with pytest.raises(ValueError, match="density grid"):
        pconv.density_from_ernerf(pconv.strip_prefix(model), 8)


def test_checks_raise(scene, tmp_path):
    head = write_pth(str(tmp_path / "head.pth"), seeded_state(torso=False), prefix="")
    cases = [({"nerf.num_levels": 5}, "hash tables"), ({"nerf.audio_in_dim": 29}, "audio_in_dim"),
             ({"nerf.grid_size": 8}, "density grid"), ({"nerf.torso": True}, "anchor_points")]
    for over, match in cases:
        with pytest.raises(ValueError, match=match):
            load_nerf_checkpoint(serve_cfg(scene, **over, **{"nerf.ckpt": head}))
    # the port's workspace takes the same checks
    ws = Checkpointer(str(tmp_path / "ws"))
    state = seeded_state(torso=False)
    density = pconv.density_from_ernerf({"density_grid": morton_grid()}, G)
    ws.save(7, {"network": state, "ema": state, "step": 7,
                "density": {"grid": density.grid, "occupancy": density.occupancy,
                            "mean_density": density.mean_density}})
    for over, match in cases:
        with pytest.raises(ValueError, match=match):
            load_nerf_checkpoint(serve_cfg(scene, **over, **{"nerf.ckpt": ws.directory}))
    # an orbax step directory without its tree metadata, and an empty one
    orbax = tmp_path / "orbax" / "200"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for path in (str(tmp_path / "orbax"), str(tmp_path / "empty")):
        os.makedirs(path, exist_ok=True)
        with pytest.raises(FileNotFoundError):
            make_engine(serve_cfg(scene, **{"nerf.ckpt": path}), device=CPU)


@pytest.mark.parametrize("torso", [True, False], ids=["torso", "head_of_a_torso_ckpt"])
def test_make_engine_serves_a_reference_pth(scene, tmp_path, torso):
    state = seeded_state(torso=True)
    path = write_pth(str(tmp_path / "ngp_kf.pth"), state, wrap=True)
    cfg = serve_cfg(scene, **{"nerf.torso": torso})
    engine = make_engine(cfg.override(**{"nerf.ckpt": path}), device=CPU)
    served = engine.network.state_dict()
    want = {k: v for k, v in state.items()
            if torso or not k.startswith(("anchor", "torso_", "individual_codes_torso"))}
    assert set(served) == set(want)
    for k, v in want.items():
        assert torch.equal(served[k], v), k
    dens = pconv.density_from_ernerf({"density_grid": morton_grid()}, G, mean_density=7.5)
    assert torch.equal(engine.density.occupancy, dens.occupancy)
    assert 0 < int(dens.occupancy.sum()) < G ** 3
    direct = NeRFReal(cfg, engine.dataset, device=CPU, state=want, density=dens)
    frame = first_frame(engine)
    assert frame.std() > 2, "the frame must show the avatar"
    np.testing.assert_array_equal(frame, first_frame(direct))
    assert engine.test_step() and engine.latest_frame.image.shape == (64, 64, 3)


def test_make_engine_serves_a_cli_workspace(tmp_path):
    root = synthesize_nerf_train_data(str(tmp_path / "data"), n_frames=3, hw=32)
    ws = str(tmp_path / "ws")
    ernerf_cli.main([root, "--workspace", ws, "--iters", "3", "--device", "cpu",
                     "--num_levels", "4", "--base_resolution", "16", "--desired_resolution",
                     "64", "--log2_hashmap_size", "10", "--grid_size", str(G),
                     "--num_rays", "128"])
    raw = Checkpointer(ws).restore()
    cfg = serve_cfg(root, **{"nerf.scale": 4.0})
    for path in (ws, Checkpointer(ws).path(3)):
        state, density = load_nerf_checkpoint(cfg.override(**{"nerf.ckpt": path}))
        assert set(state) == set(raw["ema"]) and density.grid.shape == (G ** 3,)
        for k, v in raw["ema"].items():
            assert torch.equal(state[k], v), k
    engine = make_engine(cfg.override(**{"nerf.ckpt": ws}), device=CPU)
    assert int(raw["ema"]["individual_codes"].shape[0]) == engine.network.cfg.num_train_frames
    direct = NeRFReal(cfg, engine.dataset, device=CPU, state=raw["ema"],
                      density=DensityGrid(**raw["density"]))
    np.testing.assert_array_equal(first_frame(engine), first_frame(direct))
