"""The port's ER-NeRF data pipeline against the JAX package's.

Tasks 4-6 write byte-equal files: face parsing with a mask-only parser
(tests/test_nerf_data.py's), the background plate and the gt/torso
composites from the JAX run's own parsing maps; task 2's windows and task
9's transforms.json are byte-equal for the same logits and poses; the CLI
of tasks 8-9 on a 68-vertex model matches JAX's fit; the port's BiSeNet
parses through the CLI; the gates raise as JAX's do, and task 1 names the
missing ffmpeg. One torch thread.
"""
from __future__ import annotations

import filecmp
import json
import os

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mere_fusion_tpu.tools import face_tracking as jft
from mere_fusion_tpu.tools import nerf_data as jnd
from mere_fusion_tpu_torch.tools import nerf_data as nd
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def mask_parser(img, size=(512, 512)):
    m = np.zeros(size, np.uint8)
    m[:200, 100:400] = 255
    return m


def frames_dir(root, n=3, hw=(64, 80)):
    """n noisy frames with a face-coloured block as ``<i>.jpg``."""
    os.makedirs(root)
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(80, 120, (*hw, 3), dtype=np.uint8)
        img[8:40, 20:60] = (60 + 10 * i, 150, 200)
        cv2.imwrite(os.path.join(root, f"{i}.jpg"), img)
    return root


def semantic_maps(root, names, hw=(64, 80)):
    os.makedirs(root)
    for i, name in enumerate(names):
        seg = np.full((*hw, 3), 255, np.uint8)
        seg[8:30, 20:60] = (255, 0, 0)
        seg[30:36, 30 + i:50] = (0, 255, 0)
        seg[36:62, 24:56] = (0, 0, 255)
        cv2.imwrite(os.path.join(root, name), seg)


def same_tree(a: str, b: str) -> None:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_tasks_4_to_6_write_jaxs_files(tmp_path):
    for side in ("jax", "port"):
        frames_dir(str(tmp_path / side / "ori_imgs"))
    jnd.face_parsing(str(tmp_path / "jax" / "ori_imgs"),
                     str(tmp_path / "jax" / "masks"), mask_parser)
    nd.face_parsing(str(tmp_path / "port" / "ori_imgs"), str(tmp_path / "port" / "masks"),
                    mask_parser)
    same_tree(str(tmp_path / "jax" / "masks"), str(tmp_path / "port" / "masks"))
    # tasks 5 and 6 through the CLIs over the same semantic maps
    for side in ("jax", "port"):
        semantic_maps(str(tmp_path / side / "parsing"), ["0.png", "1.png", "2.png"])
    jnd.main([str(tmp_path / "jax"), "--task", "5"])
    jnd.main([str(tmp_path / "jax"), "--task", "6"])
    nd.main([str(tmp_path / "port"), "--task", "5", "--device", "cpu"])
    nd.main([str(tmp_path / "port"), "--task", "6", "--device", "cpu"])
    assert filecmp.cmp(tmp_path / "jax" / "bc.jpg", tmp_path / "port" / "bc.jpg", shallow=False)
    for sub in ("gt_imgs", "torso_imgs"):
        same_tree(str(tmp_path / "jax" / sub), str(tmp_path / "port" / sub))
    torso = cv2.imread(str(tmp_path / "port" / "torso_imgs" / "0.png"), cv2.IMREAD_UNCHANGED)
    assert torso.shape == (64, 80, 4) and torso[50, 40, 3] == 255 and torso[2, 2, 3] == 0


def test_audio_windows_and_transforms_equal_jaxs(tmp_path):
    from scipy.io import wavfile

    wav = (np.sin(np.linspace(0, 440 * 6.28, 24000)) * 0.4 * 32767).astype(np.int16)
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 22050, wav)           # resampled to 16 kHz on both sides

    def logits_fn(audio):
        frames = audio[: len(audio) // 320 * 320].reshape(-1, 320)
        return np.tile(frames.mean(axis=1, keepdims=True), (1, 29))[:-1]

    want = jnd.audio_features(path, str(tmp_path / "jax.npy"), logits_fn)
    got = nd.audio_features(path, str(tmp_path / "port.npy"), logits_fn)
    assert filecmp.cmp(want, got, shallow=False)
    assert np.load(got).shape[1:] == (16, 29)

    poses = np.random.default_rng(1).normal(size=(3, 4, 4)).astype(np.float32)
    a = jnd.export_transforms(poses, 1234.5, 256.0, 256.0, str(tmp_path / "jax.json"),
                              aud_ids=[0, 2, 4])
    b = nd.export_transforms(poses, 1234.5, 256.0, 256.0, str(tmp_path / "port.json"),
                             aud_ids=[0, 2, 4])
    assert filecmp.cmp(a, b, shallow=False)


def write_bfm(root: str, n: int = 68, seed: int = 0) -> jft.MorphableModel:
    rng = np.random.default_rng(seed)
    mean = rng.normal(0, 40, (n, 3)).astype(np.float32)
    info = {"mu_shape": mean.reshape(-1),
            "b_shape": rng.normal(0, 3, (n * 3, 6)).astype(np.float32),
            "b_exp": rng.normal(0, 2, (n * 3, 4)).astype(np.float32)}
    os.makedirs(root)
    np.save(os.path.join(root, "3DMM_info.npy"), info, allow_pickle=True)
    return jft.MorphableModel(mean=mean, base_id=info["b_shape"], base_exp=info["b_exp"])


def test_tracking_cli_matches_jaxs(tmp_path):
    """Tasks 8-9 through both CLIs on a 68-vertex model and its landmarks
    at seeded poses: the same transforms.json keys and frames, the poses and
    focal within 2e-3 (3,000 Adam steps in each package)."""
    model = write_bfm(str(tmp_path / "bfm"))
    rng = np.random.default_rng(3)
    f = 3
    euler = rng.normal(0, 0.1, (f, 3)).astype(np.float32)
    trans = np.tile([0.0, 0.0, -600.0], (f, 1)).astype(np.float32)
    rot = np.asarray(jft.euler_to_rot(jnp.asarray(euler)))
    cam = np.einsum("fij,nj->fni", rot, model.mean) + trans[:, None]
    lmk = np.asarray(jft.project(jnp.asarray(cam), 1100.0, (40.0, 32.0)))
    for side in ("jax", "port"):
        ori = frames_dir(str(tmp_path / side / "ori_imgs"), n=f)
        for i in range(f):
            np.savetxt(os.path.join(ori, f"{i}.lms"), lmk[i], "%f")
    jnd.main([str(tmp_path / "jax"), "--task", "8", "--bfm_dir", str(tmp_path / "bfm")])
    nd.main([str(tmp_path / "port"), "--task", "8", "--bfm_dir", str(tmp_path / "bfm"),
             "--device", "cpu"])
    want = json.load(open(tmp_path / "jax" / "transforms.json"))
    got = json.load(open(tmp_path / "port" / "transforms.json"))
    assert set(got) == set(want) and (got["cx"], got["cy"]) == (want["cx"], want["cy"]) == (40, 32)
    assert got["focal_len"] == pytest.approx(want["focal_len"], rel=2e-3)
    for g, w in zip(got["frames"], want["frames"], strict=True):
        assert (g["img_id"], g["aud_id"]) == (w["img_id"], w["aud_id"])
        np.testing.assert_allclose(g["transform_matrix"], w["transform_matrix"], atol=2e-3 * 600)


def test_photometric_tracking_uses_the_models_landmark_vertices(tmp_path):
    """A model with topology and keys_info.npy: task 8's landmark stage fits
    the landmark vertices' sub-basis, and the mesh path refines."""
    n_side = 10
    g = np.linspace(-1, 1, n_side)
    xx, yy = np.meshgrid(g, g)
    mean = np.stack([xx, yy, 0.3 * (1 - xx ** 2 - yy ** 2)], -1).reshape(-1, 3) * 10.0
    idx = np.arange(n_side * n_side).reshape(n_side, n_side)
    tris = np.concatenate([np.stack([idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:]], -1),
                           np.stack([idx[1:, :-1], idx[1:, 1:], idx[:-1, 1:]], -1)]).reshape(-1, 3)
    rng = np.random.default_rng(0)
    keyinds = np.arange(0, n_side * n_side, 9)
    bfm = tmp_path / "bfm"
    os.makedirs(bfm)
    np.save(bfm / "3DMM_info.npy", {"mu_shape": mean.reshape(-1).astype(np.float32),
                                    "b_shape": rng.normal(0, 0.5, (mean.size, 3)).astype(np.float32),
                                    "b_exp": rng.normal(0, 0.5, (mean.size, 2)).astype(np.float32)},
            allow_pickle=True)
    np.save(bfm / "topology_info.npy", {"tris": tris}, allow_pickle=True)
    np.save(bfm / "keys_info.npy", {"keyinds": keyinds}, allow_pickle=True)
    cam = mean[keyinds] + np.array([0.0, 0.0, -300.0])
    lmk = np.asarray(jft.project(jnp.asarray(cam, jnp.float32), 1000.0, (16.0, 16.0)))
    ori = frames_dir(str(tmp_path / "data" / "ori_imgs"), n=2, hw=(32, 32))
    for i in range(2):
        np.savetxt(os.path.join(ori, f"{i}.lms"), lmk, "%f")
    nd.main([str(tmp_path / "data"), "--task", "9", "--bfm_dir", str(bfm), "--photometric",
             "--device", "cpu"])
    out = json.load(open(tmp_path / "data" / "transforms.json"))
    assert len(out["frames"]) == 2 and np.isfinite(out["focal_len"])
    assert np.isfinite(np.asarray([fr["transform_matrix"] for fr in out["frames"]])).all()


def test_bisenet_parses_through_the_cli(tmp_path):
    from mere_fusion_tpu_torch.models.bisenet import FaceParsing

    frames_dir(str(tmp_path / "ori_imgs"), n=1, hw=(32, 40))
    ckpt = str(tmp_path / "79999_iter.pth")
    torch.save(FaceParsing(device=CPU).model.state_dict(), ckpt)
    nd.main([str(tmp_path), "--task", "4", "--bisenet_ckpt", ckpt, "--device", "cpu"])
    seg = cv2.imread(str(tmp_path / "parsing" / "0.png"))
    assert seg.shape == (32, 40, 3)
    colours = {tuple(c) for c in seg.reshape(-1, 3)}
    assert colours <= {(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 255)}


def test_gates_raise_as_jaxs(tmp_path, monkeypatch):
    for fn in (lambda m: m.face_tracking(np.zeros((1, 4, 2), np.float32), (64, 64)),
               lambda m: m.landmarks("/nonexistent")):
        with pytest.raises(ValueError):
            fn(jnd)
        with pytest.raises(ValueError):
            fn(nd)
    base = str(tmp_path)
    os.makedirs(os.path.join(base, "ori_imgs"))
    for task, flags, message in (("4", [], "--bisenet_ckpt"), ("5", [], "parsing/"),
                                 ("6", [], "bc.jpg"), ("7", [], "--fan_ckpt"),
                                 ("9", [], "--bfm_dir"),
                                 ("8", ["--bfm_dir", base], ".lms")):
        for mod, extra in ((jnd, []), (nd, ["--device", "cpu"])):
            with pytest.raises(SystemExit, match=message.replace(".", r"\.")):
                mod.main([base, "--task", task, *flags, *extra])
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="ffmpeg"):
        nd.extract_audio("in.mp4", str(tmp_path / "a.wav"))
