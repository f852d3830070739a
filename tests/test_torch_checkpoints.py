"""Checkpoints in the PyTorch port against the JAX package on the CPU, at toy
sizes: ``utils.checkpoint.restore_orbax_raw`` against the JAX
``Checkpointer.restore_raw`` (tolerance 0), the port's
``tools/convert_ckpt.py`` on directories the JAX converter wrote against
``convert.*_from_flax`` on the same trees in memory and on reference torch
files against what the port served of them before and against the JAX
converter's tree of the same file through ``convert.*_from_flax``, the
engines served from
the JAX package's orbax directories against JAX's ``make_engine`` on the
same directories (uint8 frames within 1 LSB; ER-NeRF frames equal to a
``NeRFReal`` given the weights JAX's loader reads), ``--head_ckpt`` from a
JAX head workspace, and the ImportError naming tensorstore where it is
absent."""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import lip_reference_state, write_lip_pth, write_torso_imgs
from mere_fusion_tpu.config import Config as JaxConfig
from mere_fusion_tpu.engines import make_engine as jax_make_engine
from mere_fusion_tpu.engines import muse as jax_muse
from mere_fusion_tpu.engines.nerf import load_nerf_checkpoint as jax_load_nerf_checkpoint
from mere_fusion_tpu.models.musetalk import VAEConfig as JaxVAEConfig
from mere_fusion_tpu.tools import convert_ckpt as jax_cli
from mere_fusion_tpu.train.ernerf_train import NeRFTrainConfig, init_nerf_train
from mere_fusion_tpu.utils import torch_convert as jconv
from mere_fusion_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from mere_fusion_tpu_torch import convert as pconvert
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.device import random_init_
from mere_fusion_tpu_torch.engines import (
    _DEVICE_TREES,
    load_serving_tree,
    make_engine,
    shared_device_tree,
)
from mere_fusion_tpu_torch.engines.muse import synthesize_muse_avatar
from mere_fusion_tpu_torch.engines.nerf import NeRFReal, load_nerf_checkpoint
from mere_fusion_tpu_torch.models.musetalk import AutoencoderKL, UNet2DCondition, VAEConfig
from mere_fusion_tpu_torch.models.whisper import Whisper
from mere_fusion_tpu_torch.models.yolo import YoloV10
from mere_fusion_tpu_torch.perception import TPUYoloPerception
from mere_fusion_tpu_torch.tools import convert_ckpt, genavatar
from mere_fusion_tpu_torch.train import ernerf_cli
from mere_fusion_tpu_torch.utils.checkpoint import (
    Checkpointer,
    load_converted,
    restore_orbax_raw,
)
from mere_fusion_tpu_torch.utils.yolo_convert import convert_yolo_file
from tests.test_torch_genavatar import _write_video, fixed_s3fd  # noqa: F401  (fixture)
from tests.test_torch_musetalk import PORT_UNET, PORT_WHISPER, TINY_UNET
from tests.test_torch_nerf_ckpt import G, NET, OVERRIDES, first_frame, seeded_state, write_pth
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
FEATURE_REL = 3e-4       # the whisper encoder's features: a deep f32 stack
# the JAX converter reads a VAE of sd-vae's four levels (convert_vae's n_down)
JAX_VAE = JaxVAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=2,
                       norm_num_groups=8)
PORT_VAE = VAEConfig(**dataclasses.asdict(JAX_VAE))


def _as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same(a: dict, b: dict) -> None:
    assert set(a) == set(b), (sorted(set(a) ^ set(b))[:8])
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _jax_convert(family: str, src: str, out: str, *extra: str) -> str:
    jax_cli.main([family, src, out, *extra])
    return out


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Reference-layout torch files of six families, seeded, at toy widths
    (Wav2Lip at its only width, YOLOv10 at scale n). The ER-NeRF file's
    keys are ``module.``-prefixed, so the JAX converter reads no density
    grid of it (its grid would have to be 128³)."""
    d = tmp_path_factory.mktemp("sources")
    out = {"wav2lip": write_lip_pth(str(d / "wav2lip.pth"), lip_reference_state(5))}
    vae = random_init_(AutoencoderKL(PORT_VAE), 3).state_dict()
    legacy = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.",
              ".to_out.0.": ".proj_attn."}       # sd-vae-ft-mse's published names
    for new, old in legacy.items():
        vae = {k.replace(new, old): v for k, v in vae.items()}
    torch.save(vae, d / "vae.bin")
    torch.save(random_init_(UNet2DCondition(PORT_UNET), 4).state_dict(), d / "unet.bin")
    torch.save({"dims": dataclasses.asdict(PORT_WHISPER),
                "model_state_dict": random_init_(Whisper(PORT_WHISPER), 6).state_dict()},
               d / "whisper.pt")
    torch.save(random_init_(YoloV10("n", 80), 7).state_dict(), d / "yolo.pt")
    out.update(vae=str(d / "vae.bin"), unet=str(d / "unet.bin"), whisper=str(d / "whisper.pt"),
               yolo=str(d / "yolo.pt"),
               ernerf=write_pth(str(d / "ngp_kf.pth"), seeded_state(torso=True)))
    cfg_json = d / "unet.json"
    cfg_json.write_text(json.dumps(dataclasses.asdict(TINY_UNET)))
    out["unet_config"] = str(cfg_json)
    return out


FAMILY_SOURCE = {"wav2lip": "wav2lip", "vae": "vae", "musetalk-unet": "unet",
                 "whisper": "whisper", "yolo": "yolo", "ernerf": "ernerf"}


@pytest.fixture(scope="module")
def jax_dirs(sources, tmp_path_factory):
    """Each family's orbax directory as the JAX converter writes it."""
    d = tmp_path_factory.mktemp("jax_dirs")
    out = {}
    for family, src in FAMILY_SOURCE.items():
        extra = ("--unet-config", sources["unet_config"]) if family == "musetalk-unet" else ()
        out[family] = _jax_convert(family, sources[src], str(d / family), *extra)
    return out


# ---- restore_orbax_raw ----------------------------------------------------------------

def _compare_raw(ref, got, path="") -> None:
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(ref) == set(got), path
        for k in ref:
            _compare_raw(ref[k], got[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, list) and len(ref) == len(got), path
        for i, (r, g) in enumerate(zip(ref, got)):
            _compare_raw(r, g, f"{path}.{i}")
    elif ref is None or isinstance(ref, (int, float)):
        assert type(got) is type(ref) and got == ref, path
    else:
        ref = np.asarray(ref)
        if ref.dtype == jnp.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            got = got.view(torch.int16).numpy().view(np.uint16)
            ref = ref.view(np.uint16)
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(got, ref, err_msg=path)


@pytest.fixture(scope="module")
def jax_tree_dir(tmp_path_factory):
    """A JAX workspace of two steps whose tree holds a bfloat16 leaf (not a
    value bfloat16 rounds to a float's), uint8, int32, a scalar, an optax
    chain's state (a tuple holding an EmptyState), a list, an empty dict and
    an empty tuple."""
    rng = np.random.default_rng(0)
    params = {"net": {"kernel": jnp.asarray(rng.standard_normal((3, 5)), jnp.float32),
                      "bias": jnp.asarray(rng.standard_normal(5), jnp.bfloat16)},
              "codes": jnp.asarray(rng.integers(0, 255, 4), jnp.uint8)}
    tx = optax.chain(optax.scale_by_adam(), optax.scale(-1e-3))
    tree = {"params": params, "opt_state": tx.init(params), "step": jnp.int32(7),
            "loss": 0.25, "seq": [jnp.ones(12), jnp.arange(12)] * 6, "empty": {},
            "no_fields": ()}
    d = str(tmp_path_factory.mktemp("raw") / "ws")
    ckpt = JaxCheckpointer(d)
    ckpt.save(3, tree)
    ckpt.save(9, {**tree, "step": jnp.int32(9)}, {"loss": 0.5})
    ckpt.close()
    return d


@pytest.mark.parametrize("where", ["manager", "step_dir", "explicit_step"])
def test_restore_orbax_raw_matches_jax(jax_tree_dir, where):
    step = {"manager": None, "step_dir": None, "explicit_step": 3}[where]
    path = os.path.join(jax_tree_dir, "9") if where == "step_dir" else jax_tree_dir
    ckpt = JaxCheckpointer(jax_tree_dir)
    ref = ckpt.restore_raw(step if step is not None else 9)
    ckpt.close()
    got = restore_orbax_raw(path, step)
    _compare_raw(ref, got)
    assert got["step"] == (7 if step == 3 else 9) and got["loss"] == 0.25
    assert got["params"]["net"]["bias"].dtype == torch.bfloat16
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        restore_orbax_raw(jax_tree_dir, 5)


def test_restore_orbax_raw_skips_unfinished_saves(jax_tree_dir, tmp_path):
    ws = tmp_path / "ws"
    shutil.copytree(os.path.join(jax_tree_dir, "3"), ws / "3")
    (ws / "12.orbax-checkpoint-tmp-1234").mkdir()
    assert restore_orbax_raw(str(ws))["step"] == 7
    for empty in (ws / "12.orbax-checkpoint-tmp-1234", tmp_path):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            restore_orbax_raw(str(empty))


def test_orbax_without_tensorstore_raises_naming_it(jax_dirs, sources, tmp_path,
                                                    monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore.*convert_ckpt"):
        restore_orbax_raw(jax_dirs["wav2lip"])
    with pytest.raises(ImportError, match="tensorstore"):
        convert_ckpt.main(["wav2lip", jax_dirs["wav2lip"], str(tmp_path / "out")])
    cfg = Config().override(**{"avatar.ckpt": jax_dirs["wav2lip"], "avatar.batch_size": 2,
                               "tts.backend": "procedural"})
    with pytest.raises(ImportError, match="tensorstore"):
        make_engine(cfg, device=CPU)
    assert not os.path.exists(tmp_path / "out")
    # a converted directory needs no tensorstore
    convert_ckpt.main(["wav2lip", sources["wav2lip"], str(tmp_path / "conv")])
    assert set(load_serving_tree("wav2lip", str(tmp_path / "conv"))[0])


# ---- the converter CLI ----------------------------------------------------------------

def test_cli_families_and_arguments_match_jax(capsys):
    choices = []
    for main in (jax_cli.main, convert_ckpt.main):
        with pytest.raises(SystemExit):
            main(["no-such-family", "in", "out"])
        err = capsys.readouterr().err
        choices.append(err[err.index("choose from"):])
    assert choices[0] == choices[1]
    assert len(convert_ckpt.FAMILIES) == 18
    with pytest.raises(SystemExit):
        convert_ckpt.main(["--help"])
    assert "--unet-config" in capsys.readouterr().out


def _from_flax_in_memory(family: str, sources: dict) -> dict:
    """convert.*_from_flax on the tree JAX's converter makes in memory."""
    extra = {"unet_config": sources["unet_config"]} if family == "musetalk-unet" else {}
    tree, meta = jax_cli.convert_with_meta(family, sources[FAMILY_SOURCE[family]],
                                           **extra)
    tree = _as_numpy(tree)
    if family == "wav2lip":
        return pconvert.wav2lip_from_flax(tree)
    if family == "vae":
        return pconvert.vae_from_flax(tree)
    if family == "musetalk-unet":
        return pconvert.unet_from_flax(tree, PORT_UNET)
    if family == "whisper":
        assert meta["dims"] == dataclasses.asdict(PORT_WHISPER)
        return pconvert.whisper_from_flax(tree, PORT_WHISPER)
    if family == "yolo":
        return pconvert.yolo_from_flax(tree, "n")
    assert "density" not in tree
    return pconvert.ernerf_from_flax(tree["params"])


@pytest.mark.parametrize("family", list(FAMILY_SOURCE))
def test_convert_jax_dir_equals_from_flax(sources, jax_dirs, tmp_path, family, capsys):
    out = str(tmp_path / "out")
    extra = ["--unet-config", sources["unet_config"]] if family == "musetalk-unet" else []
    convert_ckpt.main([family, jax_dirs[family], out, *extra])
    assert f"converted {family}:" in capsys.readouterr().out
    got, info = load_converted(out)
    _assert_same(got, _from_flax_in_memory(family, sources))
    assert info["family"] == family and info["source"] == os.path.abspath(jax_dirs[family])
    if family == "whisper":
        assert info["dims"] == dataclasses.asdict(PORT_WHISPER)
    # a directory this tool wrote converts to itself; another family's raises
    _assert_same(convert_ckpt.convert(family, out), got)
    with pytest.raises(ValueError, match="holds"):
        convert_ckpt.convert("s3fd", out)


def _served_before(family: str, path: str) -> dict:
    """What the port served of a reference torch file before it had a
    converter: the engines' loader on the file as it read it then."""
    if family == "yolo":
        return convert_yolo_file(path)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if family == "whisper":
        return {k[len("encoder."):]: v for k, v in raw["model_state_dict"].items()
                if k.startswith("encoder.")}
    return pconvert.native_state(family, raw)[0]


@pytest.mark.parametrize("family", list(FAMILY_SOURCE))
def test_convert_torch_file_serves_what_the_file_served(sources, tmp_path, family):
    """The port's converter on a reference torch file serves what the port
    served of that file before, and what JAX's converter makes of the same
    file once ``convert.*_from_flax`` translates it."""
    src, out = sources[FAMILY_SOURCE[family]], str(tmp_path / "out")
    convert_ckpt.main([family, src, out])
    info = json.loads(open(os.path.join(out, "family.json")).read())
    assert info["family"] == family and info["source"] == os.path.abspath(src)
    via_jax = _from_flax_in_memory(family, sources)
    if family == "whisper":         # served: the encoder
        via_jax = {k[len("encoder."):]: v for k, v in via_jax.items() if k.startswith("encoder.")}
    if family == "ernerf":
        scene = str(tmp_path / "scene")
        from mere_fusion_tpu_torch.data.provider import synthesize_nerf_dataset

        synthesize_nerf_dataset(scene, hw=64)
        cfg = Config().override(**{**OVERRIDES, "nerf.pose_path": f"{scene}/transforms.json",
                                   "nerf.au_path": f"{scene}/au.csv", "nerf.torso": True})
        (want, wd), (got, gd) = (load_nerf_checkpoint(cfg.override(**{"nerf.ckpt": p}))
                                 for p in (src, out))
        _assert_same(got, want)
        _assert_same(got, via_jax)
        for k in ("grid", "occupancy", "mean_density"):
            assert torch.equal(getattr(gd, k), getattr(wd, k)), k
        return
    served = load_serving_tree(family, out)[0]
    _assert_same(served, _served_before(family, src))
    _assert_same(served, via_jax)
    if family == "whisper":
        assert info["dims"] == dataclasses.asdict(PORT_WHISPER)
        assert load_serving_tree(family, out)[1]["dims"] == info["dims"]


def test_shared_device_tree_shares_one_copy_of_a_directory(sources, tmp_path):
    out = str(tmp_path / "conv")
    convert_ckpt.main(["vae", sources["vae"], out])
    n = len(_DEVICE_TREES)
    tree = shared_device_tree("vae", out, CPU, torch.bfloat16)
    assert shared_device_tree("vae", out + "/", CPU, torch.bfloat16) is tree
    assert shared_device_tree("vae", os.path.relpath(out), CPU, torch.bfloat16) is tree
    assert len(_DEVICE_TREES) == n + 1
    assert tree["decoder.conv_in.weight"].dtype == torch.bfloat16


# ---- serving the JAX package's directories ---------------------------------------------

MUSE = {"avatar.kind": "musetalk", "avatar.batch_size": 2, "avatar.dtype": "float32",
        "avatar.vae_int8": "off", "tts.backend": "procedural"}


def test_make_engine_serves_jax_muse_dirs(sources, jax_dirs):
    ckpts = {"avatar.vae_ckpt": jax_dirs["vae"], "avatar.unet_ckpt": jax_dirs["musetalk-unet"],
             "avatar.whisper_ckpt": jax_dirs["whisper"],
             "avatar.unet_config": sources["unet_config"]}
    jcfg = JaxConfig().override(**MUSE, **ckpts)
    jax_models = jax_muse.MuseModels(JAX_VAE, TINY_UNET, face_size=64, vae_int8="off")
    jeng = jax_make_engine(jcfg, vae_cfg=JAX_VAE, face_size=64,
                           avatar=jax_muse.synthesize_muse_avatar(jax_models, 2))
    from mere_fusion_tpu_torch.engines.muse import MuseModels

    peng = make_engine(Config().override(**MUSE, **ckpts), vae_cfg=PORT_VAE, face_size=64,
                       avatar=synthesize_muse_avatar(
                           MuseModels(PORT_VAE, PORT_UNET, face_size=64, device=CPU,
                                      vae_int8="off"), 2),
                       device=CPU)
    rng = np.random.default_rng(8)
    lat = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    # the engines' warm-up shape: 10 rows a layer of the extractor's dims
    feats = rng.standard_normal((2, 10 * (PORT_WHISPER.n_audio_layer + 1), 64))
    feats = feats.astype(np.float32)
    ref = np.asarray(jeng.models.generate(jnp.asarray(lat), jnp.asarray(feats)))
    got = peng.models.generate(torch.from_numpy(lat), torch.from_numpy(feats)).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 3) and ref.std() > 2
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    # the whisper dims came from the JAX directory's family.json
    assert peng.asr.features.dims == PORT_WHISPER
    audio = np.random.default_rng(9).standard_normal(8000).astype(np.float32) * 0.1
    want = jeng.asr.features.audio2feat(audio)
    have = peng.asr.features.audio2feat(audio)
    assert have.shape == want.shape
    assert np.abs(have - want).max() / np.abs(want).max() < FEATURE_REL


def test_make_engine_serves_a_jax_wav2lip_dir(jax_dirs, tmp_path):
    from mere_fusion_tpu.engines.avatar import synthesize_avatar as jax_synthesize_avatar
    from mere_fusion_tpu_torch.engines.avatar import load_lip_avatar

    avatar_dir = str(tmp_path / "avatar")
    jax_avatar = jax_synthesize_avatar(avatar_dir, n_frames=4)
    over = {"avatar.ckpt": jax_dirs["wav2lip"], "avatar.batch_size": 2,
            "avatar.dtype": "float32", "tts.backend": "procedural"}
    jeng = jax_make_engine(JaxConfig().override(**over), avatar=jax_avatar)
    peng = make_engine(Config().override(**over), avatar=load_lip_avatar(avatar_dir),
                       device=CPU)
    rng = np.random.default_rng(10)
    mel = rng.standard_normal((2, 80, 16)).astype(np.float32)
    faces = np.stack(jax_avatar.face_cycle[:2])
    ref = np.asarray(jeng._device_step(jnp.asarray(mel), jnp.asarray(faces)))
    got = peng._device_step(torch.from_numpy(mel), torch.from_numpy(faces)).numpy()
    assert got.shape == ref.shape == (2, 96, 96, 3) and ref.std() > 2
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def nerf_scene(tmp_path_factory):
    from mere_fusion_tpu_torch.data.provider import synthesize_nerf_dataset

    root = str(tmp_path_factory.mktemp("nerf_scene"))
    synthesize_nerf_dataset(root, hw=64)
    return root


@pytest.fixture(scope="module")
def jax_workspace(sources, tmp_path_factory):
    """A JAX NeRFTrainState workspace (optax's multi_transform state, EMA
    parameters apart from the raw ones) written by the JAX Checkpointer."""
    model = jconv.load_torch_checkpoint(sources["ernerf"])["model"]
    params = jconv.convert_ernerf(model)["params"]
    _, state = init_nerf_train(None, {"params": params}, NeRFTrainConfig(grid_size=G))
    ema = jax.tree.map(lambda x: x * np.float32(0.97), state.params)
    density = jconv.density_from_ernerf(
        {k[len("module."):]: v for k, v in model.items()}, G, mean_density=7.5)
    state = state._replace(ema_params=ema, density=density, step=jnp.int32(40))
    ws = str(tmp_path_factory.mktemp("jax_ws") / "ws")
    ckpt = JaxCheckpointer(ws)
    ckpt.save(40, state, {"loss": 0.1})
    ckpt.close()
    return ws


@pytest.mark.parametrize("kind", ["jax_workspace", "jax_converted", "port_converted"])
def test_nerf_serves_jax_dirs(sources, jax_dirs, jax_workspace, nerf_scene, tmp_path, kind):
    path = {"jax_workspace": jax_workspace, "jax_converted": jax_dirs["ernerf"]}.get(kind)
    if kind == "port_converted":
        path = str(tmp_path / "conv")
        convert_ckpt.main(["ernerf", jax_workspace, path])
    over = {**OVERRIDES, "nerf.pose_path": f"{nerf_scene}/transforms.json",
            "nerf.au_path": f"{nerf_scene}/au.csv", "nerf.torso": True,
            "nerf.ckpt": jax_workspace if kind == "port_converted" else path}
    variables, jdens = jax_load_nerf_checkpoint(JaxConfig().override(**over))
    want = pconvert.ernerf_from_flax(_as_numpy(variables))
    cfg = Config().override(**{**over, "nerf.ckpt": path})
    state, density = load_nerf_checkpoint(cfg)
    _assert_same(state, want)
    want_density = jdens and pconvert.density_from_flax(_as_numpy(jdens))
    assert (density is None) == (jdens is None) == (kind == "jax_converted")
    for k in ("grid", "occupancy", "mean_density") if density is not None else ():
        assert torch.equal(getattr(density, k), getattr(want_density, k)), k
    if kind != "jax_converted":     # a workspace serves its EMA, not its raw parameters
        raw = _as_numpy(restore_orbax_raw(jax_workspace)["params"])
        assert not torch.equal(state["plane_xy"], pconvert.ernerf_from_flax(raw)["plane_xy"])
    engine = make_engine(cfg, device=CPU)
    direct = NeRFReal(cfg.override(**{"nerf.ckpt": ""}), engine.dataset, device=CPU,
                      state=want, density=want_density)
    frame = first_frame(engine)
    assert frame.std() > 2
    np.testing.assert_array_equal(frame, first_frame(direct))


def test_head_ckpt_from_a_jax_head_workspace(jax_workspace, tmp_path, capsys):
    """The torso stage takes a JAX head workspace's raw parameters (not its
    EMA) and density grid, as the JAX CLI's --head_ckpt does."""
    from mere_fusion_tpu_torch.data.provider import synthesize_nerf_train_data
    from mere_fusion_tpu_torch.models.ernerf.network import is_torso_param

    raw = restore_orbax_raw(jax_workspace)
    want = pconvert.ernerf_from_flax(_as_numpy(raw["params"]))
    head, density = ernerf_cli.head_checkpoint(jax_workspace, CPU)
    _assert_same(head, want)
    assert torch.equal(density.grid, torch.from_numpy(raw["density"]["grid"]))
    root = synthesize_nerf_train_data(str(tmp_path / "data"), n_frames=3, hw=32)
    write_torso_imgs(root, 3, 32)
    ws = str(tmp_path / "torso")
    ernerf_cli.main([root, "--workspace", ws, "--iters", "2", "--torso", "--head_ckpt",
                     jax_workspace, "--device", "cpu", "--num_levels", "4",
                     "--base_resolution", "16", "--desired_resolution", "64",
                     "--log2_hashmap_size", "10", "--grid_size", str(G), "--num_rays", "64"])
    assert "[torso] done" in capsys.readouterr().out
    torso = Checkpointer(ws).restore()
    for name, v in torso["network"].items():
        if not is_torso_param(name):
            assert torch.equal(v, want[name]), f"{name} is not the JAX head's"
    assert torch.equal(torso["density"]["occupancy"], density.occupancy)


# ---- the other entry points that take converted directories ---------------------------

def test_perception_ckpt_takes_converted_dirs(sources, jax_dirs, tmp_path):
    out = str(tmp_path / "yolo")
    convert_ckpt.main(["yolo", sources["yolo"], out])
    for path in (out, jax_dirs["yolo"]):
        p = TPUYoloPerception(ckpt=path, scale="n", device=CPU, use_deepface=False,
                              use_ocr=False)
        got = {k: v.float() for k, v in p.detector.model.state_dict().items()}
        want = convert_yolo_file(sources["yolo"])
        assert set(got) == set(want)
        for k, v in want.items():
            if v.is_floating_point():
                assert torch.equal(got[k], v.to(torch.bfloat16).float() if v.ndim == 4
                                   else v), k
    # the names are checked where the model is built, at its scale
    with pytest.raises(ValueError, match="spec"):
        TPUYoloPerception(ckpt=jax_dirs["yolo"], scale="s", device=CPU, use_deepface=False,
                          use_ocr=False)


def test_genavatar_vae_ckpt_takes_a_converted_dir(sources, tmp_path, fixed_s3fd,  # noqa: F811
                                                  monkeypatch):
    from mere_fusion_tpu_torch.engines import muse as muse_mod
    from mere_fusion_tpu_torch.engines.muse import MuseModels, load_muse_avatar, preprocess_face

    def models(vae_state=None, device=None, vae_int8="auto"):
        return MuseModels(PORT_VAE, PORT_UNET, vae_state=vae_state, face_size=64,
                          device=device, vae_int8=vae_int8)

    monkeypatch.setattr(muse_mod, "MuseModels", models)
    conv = str(tmp_path / "vae")
    convert_ckpt.main(["vae", sources["vae"], conv])
    video = str(tmp_path / "in.mp4")
    _write_video(video, n=2, hw=(72, 80))
    out = str(tmp_path / "muse")
    genavatar.main([video, "--kind", "musetalk", "--out", out, "--device", "cpu",
                    "--vae_ckpt", conv])
    pm = models(vae_state=_served_before("vae", sources["vae"]), device=CPU, vae_int8="off")
    faces = np.stack([preprocess_face(f[10:50, 10:50], 64, half_mask=False)
                      for f in genavatar.video_to_frames(video)])
    np.testing.assert_array_equal(load_muse_avatar(out).latent_cycle,
                                  pm.encode_pair(torch.from_numpy(faces)).numpy())
