"""The avatar preparation tool of the PyTorch port against the JAX package's.

On a seeded 8-frame video with a fixed detector (as the JAX package's own
CLI test patches one in: seeded S3FD weights find no face), the Wav2Lip
bundle is equal file by file to JAX's ``create_lip_avatar``. The MuseTalk
bundle (the tiny VAE of tests/test_musetalk.py, the seeded BiSeNet of
tests/test_torch_face_models.py) matches JAX's in coords and mask boxes,
its masks at ≥ 99.9% of pixels (an argmax near-tie may fall either way)
and its latents within the VAE's 3e-4; encoded in batches, the latents
are within 2e-5 of one call's. ``main`` writes a bundle that the port's
engines serve.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.engines.muse import MuseModels as JaxMuseModels
from mere_fusion_tpu.models import bisenet as jax_bisenet
from mere_fusion_tpu.models.musetalk import AutoencoderKL as JaxVAE
from mere_fusion_tpu.models.musetalk import UNet2DCondition as JaxUNet
from mere_fusion_tpu.tools import genavatar as jax_genavatar
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.convert import bisenet_from_flax, vae_from_flax
from mere_fusion_tpu_torch.engines import make_engine
from mere_fusion_tpu_torch.engines import muse as muse_mod
from mere_fusion_tpu_torch.engines.avatar import load_lip_avatar
from mere_fusion_tpu_torch.engines.muse import MuseModels, load_muse_avatar
from mere_fusion_tpu_torch.models import bisenet
from mere_fusion_tpu_torch.models import s3fd as s3fd_mod
from mere_fusion_tpu_torch.models.musetalk import UNetConfig, VAEConfig
from mere_fusion_tpu_torch.tools import genavatar
from tests.test_musetalk import TINY_UNET, TINY_VAE
from tests.test_torch_face_models import seeded_tree
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PORT_VAE = VAEConfig(**dataclasses.asdict(TINY_VAE))
PORT_UNET = UNetConfig(**dataclasses.asdict(TINY_UNET))
LATENT_REL = 3e-4          # the VAE against JAX's (tests/test_torch_musetalk.py)
BATCHED_REL = 2e-5         # batched encode against one call
MASK_EQUAL_SHARE = 0.999
BOX = (40, 30, 104, 94)    # (x1, y1, x2, y2) in a 120×160 frame


def synth_frames(n: int = 8, h: int = 120, w: int = 160, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


class JitterDetector:
    """A detector whose box moves a few pixels from frame to frame (so the
    smoothing window matters), the same on both sides."""

    def __init__(self, seed: int = 1):
        self.rng = np.random.default_rng(seed)

    def detect_batch(self, imgs, **kw):
        out = []
        for _ in imgs:
            d = np.asarray(BOX, np.float32) + self.rng.integers(-4, 5, 4)
            out.append(np.asarray([[*d, 0.9], [0, 0, 10, 10, 0.3]], np.float32))
        return out


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _tree_files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(b, f), root)
                  for b, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("T", [1, 3, 5])
def test_smooth_boxes_matches_jax(T):
    boxes = np.random.default_rng(2).integers(0, 200, (11, 4))
    np.testing.assert_array_equal(genavatar.smooth_boxes(boxes, T),
                                  jax_genavatar.smooth_boxes(boxes, T))


@pytest.mark.parametrize("pads", [(0, 10, 0, 0), (3, 0, 5, 2)])
def test_detect_face_boxes_matches_jax(pads):
    frames = synth_frames(12)
    got = genavatar.detect_face_boxes(frames, JitterDetector(), batch_size=5, pads=pads)
    want = jax_genavatar.detect_face_boxes(frames, JitterDetector(), batch_size=5, pads=pads)
    assert got == want and len(got) == 12


def test_detect_face_boxes_halves_the_batch_on_oom():
    """A batch that runs out of device memory is retried at half the size;
    at batch 1 the error goes out."""
    frames = synth_frames(6)
    sizes = []

    class OomAbove2(genavatar.FixedBoxDetector):
        def detect_batch(self, imgs, **kw):
            sizes.append(len(imgs))
            if len(imgs) > 2:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return super().detect_batch(imgs)

    boxes = genavatar.detect_face_boxes(frames, OomAbove2(BOX), batch_size=8)
    assert sizes == [6, 4, 2, 2, 2] and boxes == [(30, 104, 40, 104)] * 6

    class AlwaysOom(OomAbove2):
        def detect_batch(self, imgs, **kw):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        genavatar.detect_face_boxes(frames, AlwaysOom(BOX), batch_size=4)
    with pytest.raises(ValueError, match="not detected"):
        genavatar.detect_face_boxes(frames, type("NoFace", (), {
            "detect_batch": lambda self, imgs, **kw: [np.zeros((0, 5))] * len(imgs)})())


def test_lip_bundle_equals_jax_file_by_file(tmp_path):
    frames = synth_frames()
    port = genavatar.create_lip_avatar(frames, str(tmp_path / "port"), JitterDetector())
    ref = jax_genavatar.create_lip_avatar(frames, str(tmp_path / "jax"), JitterDetector())
    files = _tree_files(port)
    assert files == _tree_files(ref) and len(files) == 2 * 8 + 1
    for name in files:
        assert _read(os.path.join(port, name)) == _read(os.path.join(ref, name)), name
    avatar = load_lip_avatar(port)
    assert len(avatar) == 8 and avatar.face_cycle[0].shape == (96, 96, 3)


def test_get_landmark_and_bbox_matches_jax():
    """The landmark-refined boxes, the bbox_shift and the fallback to the
    detector's box, on the JAX package's own stubs."""
    frames = [np.full((100, 100, 3), 128, np.uint8)] * 2

    class StubLms:
        def __init__(self, lm):
            self.lm = lm

        def landmarks_from_boxes(self, img, boxes):
            return [self.lm for _ in boxes]

    det = genavatar.FixedBoxDetector((20, 10, 80, 90))
    lm = np.zeros((68, 2), np.float32)
    lm[:, 0] = np.linspace(25, 75, 68)
    lm[:, 1] = np.linspace(30, 90, 68)
    lm[28], lm[29], lm[30] = [50, 40], [50, 50], [50, 57]
    bad = lm.copy()
    bad[:, 0] = np.linspace(-5, 75, 68)
    for stub, shift in ((StubLms(lm), 0), (StubLms(lm), 10), (StubLms(bad), 0), (None, 0)):
        got = genavatar.get_landmark_and_bbox(frames, det, stub, upperbondrange=shift)
        want = jax_genavatar.get_landmark_and_bbox(frames, det, stub, upperbondrange=shift)
        assert got == want
    assert genavatar.get_landmark_and_bbox(frames, det, StubLms(lm)) == [(25, 10, 75, 90)] * 2


@pytest.fixture(scope="module")
def muse_pair():
    """JAX's and the port's tiny MuseModels with the same seeded VAE (the
    UNet, which preparation does not run, seeded on the JAX side only)."""
    vae_vars = seeded_tree(JaxVAE(TINY_VAE), (1, 64, 64, 3), seed=3)
    unet_vars = jax.eval_shape(
        JaxUNet(TINY_UNET).init, jax.random.key(0), jnp.zeros((1, 32, 32, 8)),
        jnp.zeros((1,)), jnp.zeros((1, 50, TINY_UNET.cross_attention_dim)))
    unet_vars = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), unet_vars)
    jm = JaxMuseModels(TINY_VAE, TINY_UNET, vae_vars=vae_vars, unet_vars=unet_vars,
                       face_size=64, vae_int8="off")
    pm = MuseModels(PORT_VAE, PORT_UNET, vae_state=vae_from_flax(jm.vae_vars, PORT_VAE),
                    face_size=64, device=CPU, vae_int8="off")
    return jm, pm


@pytest.fixture(scope="module")
def parsers():
    tree = seeded_tree(jax_bisenet.BiSeNet(), (1, 64, 64, 3), seed=2)
    return (jax_bisenet.FaceParsing(variables=tree),
            bisenet.FaceParsing(state=bisenet_from_flax(tree), device=CPU))


@pytest.mark.parametrize("parse", [False, True])
def test_muse_bundle_matches_jax(tmp_path, muse_pair, parsers, parse):
    # parsing: one crop size for every frame, so JAX compiles its parser
    # once, and three frames (BiSeNet runs at 512² a frame on both sides);
    # without it eight, so that the jittered boxes' smoothing window fills
    n = 3 if parse else 8
    frames = synth_frames(n)
    jm, pm = muse_pair
    jparse, pparse = parsers if parse else (None, None)
    detector = (lambda: genavatar.FixedBoxDetector(BOX)) if parse else JitterDetector
    port = genavatar.create_muse_avatar(frames, str(tmp_path / "port" / "av"), detector(), pm,
                                        bbox_shift=4, face_parser=pparse, encode_batch=3)
    ref = jax_genavatar.create_muse_avatar(frames, str(tmp_path / "jax" / "av"), detector(), jm,
                                           bbox_shift=4, face_parser=jparse)
    assert _tree_files(port) == _tree_files(ref)
    for name in ("coords.pkl", "mask_coords.pkl", "avator_info.json"):
        assert _read(os.path.join(port, name)) == _read(os.path.join(ref, name)), name
    for i in range(n):
        assert _read(os.path.join(port, "full_imgs", f"{i}.png")) == \
            _read(os.path.join(ref, "full_imgs", f"{i}.png"))
        a, b = (cv2.imread(os.path.join(d, "mask", f"{i}.png")) for d in (port, ref))
        assert a.shape == b.shape and (a == b).mean() >= MASK_EQUAL_SHARE
        if not parse:
            assert _read(os.path.join(port, "mask", f"{i}.png")) == \
                _read(os.path.join(ref, "mask", f"{i}.png"))
    got, want = (np.load(os.path.join(d, "latents.npy")) for d in (port, ref))
    assert got.shape == want.shape == (n, 32, 32, 8)
    assert np.abs(got - want).max() <= LATENT_REL * np.abs(want).max()
    avatar = load_muse_avatar(port)
    assert len(avatar) == n and avatar.coords == pickle.load(open(os.path.join(ref, "coords.pkl"), "rb"))


def test_batched_encode_equals_one_call(tmp_path, muse_pair):
    frames = synth_frames(7)
    _, pm = muse_pair
    det = genavatar.FixedBoxDetector(BOX)
    lat = {}
    for batch in (None, 3):
        out = genavatar.create_muse_avatar(frames, str(tmp_path / f"b{batch}"), det, pm,
                                           encode_batch=batch)
        lat[batch] = np.load(os.path.join(out, "latents.npy"))
    assert lat[None].shape == (7, 32, 32, 8)
    assert np.abs(lat[3] - lat[None]).max() <= BATCHED_REL * np.abs(lat[None]).max()


def _write_video(path: str, n: int = 4, hw=(64, 64)) -> None:
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, hw[::-1])
    for i in range(n):
        w.write(np.full((*hw, 3), 60 + 30 * i, np.uint8))
    w.release()


@pytest.fixture()
def fixed_s3fd(monkeypatch):
    """The CLI's S3FD swapped for a fixed box (seeded weights find no face)."""
    class Fixed(genavatar.FixedBoxDetector):
        def __init__(self, *a, **kw):
            super().__init__((10, 10, 50, 50), 0.9)

    monkeypatch.setattr(s3fd_mod, "FaceDetector", Fixed)


def test_main_writes_a_lip_bundle_that_serves(tmp_path, fixed_s3fd):
    video = str(tmp_path / "in.mp4")
    _write_video(video)
    out = str(tmp_path / "avatars" / "cli")
    genavatar.main([video, "--kind", "wav2lip", "--out", out, "--device", "cpu"])
    assert genavatar.video_to_frames(video)[0].shape == (64, 64, 3)
    avatar = load_lip_avatar(out)
    assert len(avatar) == 4 and avatar.coords[0] == (10, 60, 10, 50)
    cfg = Config().override(**{"avatar.avatar_dir": str(tmp_path / "avatars"),
                               "avatar.avatar_id": "cli", "avatar.batch_size": 2,
                               "avatar.dtype": "float32", "tts.backend": "procedural"})
    engine = make_engine(cfg, device=CPU)
    assert len(engine.avatar) == 4 and engine.first_video_frame_shape() == (64, 64)
    faces = engine._faces_dev[:2]
    from mere_fusion_tpu_torch.engines.lip import make_lip_feature_fn

    features, n_chunks = make_lip_feature_fn(cfg, CPU)
    mel = features(np.zeros(n_chunks * cfg.audio.chunk, np.float32))
    out_faces = engine._device_step(mel, faces)
    assert tuple(out_faces.shape) == (2, 96, 96, 3) and out_faces.dtype == torch.uint8


def test_main_writes_a_muse_bundle(tmp_path, fixed_s3fd, muse_pair, parsers, monkeypatch):
    """--kind musetalk with --vae_ckpt and --bisenet_ckpt (the tiny VAE and
    the seeded BiSeNet written as torch files), the models built at the
    tiny widths; the bundle loads and a MuseReal serves it."""
    _, pm = muse_pair
    monkeypatch.setattr(muse_mod, "MuseModels", lambda vae_state=None, device=None: MuseModels(
        PORT_VAE, PORT_UNET, vae_state=vae_state, face_size=64, device=device, vae_int8="off"))
    video = str(tmp_path / "in.mp4")
    _write_video(video, n=3, hw=(72, 80))
    vae_pth, parse_pth = str(tmp_path / "vae.pth"), str(tmp_path / "parse.pth")
    torch.save(pm.vae.state_dict(), vae_pth)
    torch.save(parsers[1].model.state_dict(), parse_pth)
    out = str(tmp_path / "muse")
    genavatar.main([video, "--kind", "musetalk", "--out", out, "--device", "cpu",
                    "--vae_ckpt", vae_pth, "--bisenet_ckpt", parse_pth])
    avatar = load_muse_avatar(out)
    assert len(avatar) == 3 and avatar.latent_cycle.shape == (3, 32, 32, 8)
    assert avatar.coords[0] == (10, 10, 50, 50) and avatar.mask_coords[0] == (0, 0, 66, 66)
    faces = np.stack([muse_mod.preprocess_face(f[10:50, 10:50], 64, half_mask=False)
                      for f in genavatar.video_to_frames(video)])
    np.testing.assert_array_equal(avatar.latent_cycle,
                                  pm.encode_pair(torch.from_numpy(faces)).numpy())


def test_dwpose_raises_naming_the_roadmap_item(tmp_path, fixed_s3fd, muse_pair, monkeypatch):
    """--dwpose_ckpt no longer raises: the CLI serves the RTMPose wholebody
    landmarker from an mmpose-layout checkpoint (seeded at deepen 1/3,
    widen 0.25, built at that size), and the bundle's boxes are JAX's
    get_landmark_and_bbox with JAX's landmarker on the same weights
    (through the JAX package's own converter of the same file)."""
    from mere_fusion_tpu.models import rtmpose as jax_rtmpose
    from mere_fusion_tpu.utils.torch_convert import convert_rtmpose as jax_convert_rtmpose
    from mere_fusion_tpu_torch.models import rtmpose

    size = dict(deepen=1.0 / 3.0, widen=0.25)
    net = rtmpose.init_rtmpose_(rtmpose.RTMPose(**size), 5)
    pth = str(tmp_path / "dw-ll_ucoco_384.pth")
    torch.save({"state_dict": net.state_dict()}, pth)
    build = rtmpose.WholebodyLandmarker.from_checkpoint.__func__
    monkeypatch.setattr(rtmpose.WholebodyLandmarker, "from_checkpoint", classmethod(
        lambda cls, path, **kw: build(cls, path, dtype=torch.float32, **size, **kw)))
    _, pm = muse_pair
    monkeypatch.setattr(muse_mod, "MuseModels", lambda vae_state=None, device=None: pm)
    video = str(tmp_path / "in.mp4")
    _write_video(video, n=3, hw=(72, 80))
    out = str(tmp_path / "muse")
    genavatar.main([video, "--kind", "musetalk", "--out", out, "--device", "cpu",
                    "--dwpose_ckpt", pth])
    avatar = load_muse_avatar(out)
    lm = jax_rtmpose.WholebodyLandmarker(
        jax_convert_rtmpose(torch.load(pth)["state_dict"], **size), dtype=jnp.float32, **size)
    want = jax_genavatar.get_landmark_and_bbox(
        genavatar.video_to_frames(video), genavatar.FixedBoxDetector((10, 10, 50, 50), 0.9), lm)
    # the crop loop clips the boxes' tops at the frame
    assert len(avatar) == 3 and avatar.coords == [(x1, max(0, y1), x2, y2)
                                                  for x1, y1, x2, y2 in want]


def test_genavatar_meters_split_the_time(tmp_path):
    from mere_fusion_tpu_torch.runtime.metrics import metrics

    names = ("detect", "crop", "write")
    for n in names:
        metrics.latency(f"genavatar.{n}").reset()
    genavatar.create_lip_avatar(synth_frames(3), str(tmp_path / "m"),
                                genavatar.FixedBoxDetector(BOX))
    counts = {n: metrics.latency(f"genavatar.{n}").count for n in names}
    assert counts == {"detect": 1, "crop": 3, "write": 7}
