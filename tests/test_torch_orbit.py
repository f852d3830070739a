"""The PyTorch port's orbit camera, ``/camera`` route and fullbody paste
against the JAX package's, on the CPU at toy sizes (64² frames, 4 hash
levels, the fake featurizer):

- ``OrbitCamera`` (pose, intrinsics, orbit, scale, pan, update_pose,
  reset) within 1e-6 of JAX's;
- ``NeRFReal``'s orbit-mode frames (the pose from the camera, planned and
  drawn live with no cache key) within 1 LSB of JAX ``NeRFReal``'s, the
  port's K2 step on the JAX engine's baked textures (the Pallas kernel in
  interpret mode), as ``tests/test_torch_nerf_engine.py`` holds frames;
- ``/camera``'s answers within 1e-6 of the JAX server's for the same
  requests, and its error for an engine without a camera;
- the fullbody frame within 1 LSB of JAX's, the body outside the head
  region untouched.
"""
from __future__ import annotations

import asyncio
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from mere_fusion_tpu.config import Config as JConfig
from mere_fusion_tpu.data.provider import NeRFTestDataset as JDataset
from mere_fusion_tpu.engines.nerf import NeRFReal as JNeRFReal
from mere_fusion_tpu.engines.orbit import OrbitCamera as JOrbitCamera
from mere_fusion_tpu.models.ernerf.network import NeRFNetConfig as JNetConfig
from mere_fusion_tpu.models.ernerf.network import NeRFNetwork as JNetwork
from mere_fusion_tpu.ops.triplane_bake import bake_triplanes as j_bake
from mere_fusion_tpu.server.app import create_app as j_create_app
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.convert import ernerf_from_flax
from mere_fusion_tpu_torch.data.provider import NeRFTestDataset, synthesize_nerf_dataset
from mere_fusion_tpu_torch.engines.base import read_imgs
from mere_fusion_tpu_torch.engines.nerf import NeRFReal
from mere_fusion_tpu_torch.engines.nerf_step import make_render_step
from mere_fusion_tpu_torch.engines.orbit import OrbitCamera
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig
from mere_fusion_tpu_torch.server.app import create_app
from tests.fakes import FakeEngine
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
NET = dict(num_levels=4, base_resolution=16, desired_resolution=64, log2_hashmap_size=10)
OVERRIDES = {
    "tts.backend": "procedural", "avatar.kind": "ernerf", "nerf.grid_size": 16,
    "nerf.num_levels": 4, "nerf.base_resolution": 16, "nerf.desired_resolution": 64,
    "nerf.log2_hashmap_size": 10, "nerf.max_steps": 8, "nerf.tile_budget": 8,
}
MOVES = [("orbit", (120.0, -40.0)), ("scale", (1.0,)), ("pan", (100.0, -50.0)),
         ("orbit", (2000.0, 0.0)), ("pan", (3.0, 4.0, 5.0)), ("scale", (-2.5,))]


def test_orbit_camera_matches_jax():
    port, ref = OrbitCamera(128, 96, r=2.0, fovy=50.0), JOrbitCamera(128, 96, r=2.0, fovy=50.0)
    np.testing.assert_allclose(port.intrinsics, ref.intrinsics, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.pose, ref.pose, rtol=0, atol=1e-6)
    for name, args in MOVES:
        getattr(port, name)(*args)
        getattr(ref, name)(*args)
        assert port.pose.dtype == ref.pose.dtype == np.float32
        np.testing.assert_allclose(port.pose, ref.pose, rtol=0, atol=1e-6, err_msg=name)
        assert port.radius == pytest.approx(ref.radius, abs=1e-6)
    target = port.pose.copy()
    for cam in (port, ref):
        cam.reset()
    np.testing.assert_allclose(port.pose, ref.pose, rtol=0, atol=1e-6)
    for cam in (port, ref):
        cam.update_pose(target)
    np.testing.assert_allclose(port.pose, ref.pose, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.pose[:3, :3], target[:3, :3], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX NeRFReal, the port's NeRFReal) on the same weights, the port's
    K2 step on the JAX engine's baked textures."""
    d = synthesize_nerf_dataset(str(tmp_path_factory.mktemp("orbitdata")), hw=64)
    kw = dict(scale=1.0, smooth_path=True, smooth_path_window=3, smooth_eye=True)
    jds, pds = (cls.load(f"{d}/transforms.json", f"{d}/au.csv", **kw)
                for cls in (JDataset, NeRFTestDataset))
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
    jeng = JNeRFReal(JConfig().override(**OVERRIDES), network=jnet, variables=variables,
                     dataset=jds)
    cfg = Config().override(**OVERRIDES)
    peng = NeRFReal(cfg, pds, device=CPU, state=ernerf_from_flax(variables, NeRFNetConfig(**NET)))
    baked = j_bake(params, JNetConfig(**NET).plane_spec, 1.0, resolution=128,
                   dtype=jnp.bfloat16)
    peng._render_step = make_render_step(peng.network, pds, cfg, {
        k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
        for k, v in baked.items()})
    return jeng, peng


def frame_pair(engines) -> np.ndarray:
    """One frame of each engine in step (idle audio: every frame renders);
    the port's frame, asserted within 1 LSB of JAX's."""
    for e in engines:
        e.asr.run_step()
        e.asr.run_step()
        assert e.test_step()
    jimg, pimg = (e.latest_frame.image for e in engines)
    assert pimg.shape == jimg.shape and pimg.dtype == np.uint8
    diff = np.abs(pimg.astype(int) - jimg.astype(int))
    assert diff.max() <= 1, f"frames differ by {diff.max()} LSB"
    return pimg


def test_orbit_frames_match_jax(engines):
    jeng, peng = engines
    path = frame_pair(engines)
    cams = [e.set_orbit_camera(True) for e in engines]
    assert cams[1] is peng.orbit and peng.set_orbit_camera(True) is cams[1]
    # the camera adopts the dataset's first pose as JAX's does: its rotation,
    # and the position mirrored through the origin (the reference GUI's
    # camera sits at −r on its z axis; the rays look along −z), so it looks
    # away from the head (ROADMAP §3)
    np.testing.assert_allclose(cams[1].pose, cams[0].pose, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cams[1].pose[:3, :3], peng.dataset.poses[0][:3, :3],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(cams[1].pose[:3, 3], -peng.dataset.poses[0][:3, 3],
                               rtol=0, atol=1e-5)
    away = frame_pair(engines)
    assert (away == away[0, 0]).all(), "the mirrored camera sees only the background"
    keys = set(peng._render_step.span_cache)
    for cam in cams:
        cam.pan(0.0, 0.0, -30000.0)     # the centre 3 back: the head in view again
        cam.orbit(300.0, 200.0)
    orbit = [frame_pair(engines) for _ in range(2)]
    assert orbit[0].std() > 2 and (orbit[0] != path).mean() > 0.05, \
        "the orbit pose must show the head from another view"
    assert set(peng._render_step.span_cache) == keys, "an orbit pose is never cached"
    for e in engines:
        e.set_orbit_camera(False)
    assert peng.orbit is None
    frame_pair(engines)


def test_fullbody_frame_matches_jax(engines, tmp_path):
    body = tmp_path / "body"
    body.mkdir()
    rng = np.random.default_rng(2)
    for i in range(2):
        cv2.imwrite(str(body / f"{i}.png"), rng.integers(0, 256, (96, 80, 3), np.uint8))
    frames = read_imgs([str(body / f"{i}.png") for i in range(2)])
    for e in engines:
        e.fullbody_frames, e.fullbody_offset = frames, (8, 16)
    try:
        img = frame_pair(engines)
    finally:
        for e in engines:
            e.fullbody_frames = None
    assert img.shape == (96, 80, 3)
    outside = np.ones((96, 80), bool)
    outside[16:80, 8:72] = False
    # one of the body frames (the pose track's index picks it), untouched outside
    assert any((img[outside] == f[outside]).all() for f in frames)
    assert img[16:80, 8:72].std() > 2


class CameraEngine(FakeEngine):
    """A weightless engine carrying a NeRFReal's ``set_orbit_camera`` over a
    64² dataset stub."""

    def __init__(self, cfg, set_orbit_camera, pose):
        super().__init__(cfg)
        self.dataset = types.SimpleNamespace(W=64, H=64, poses=[pose])
        self.orbit = None
        self.set_orbit_camera = types.MethodType(set_orbit_camera, self)


def test_camera_route_matches_jax(engines):
    pose = engines[1].dataset.poses[0]
    requests = [{"orbit": [120, -40]}, {"scale": 1.0, "pan": [100, -50]},
                {"orbit": [10, 5], "scale": -0.5, "pan": [1, 2, 3]}, {"reset": True},
                {"enable": False}, {"orbit": [2000, 0]}]

    async def answers(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            sid = (await (await client.post("/start_session", json={})).json())["session_id"]
            out = []
            for body in requests:
                r = await client.post("/camera", json={"session_id": sid, **body})
                out.append(await r.json())
            return out
        finally:
            await client.close()

    cfg = {"transport.mode": "loopback", "server.max_sessions": 1}
    port = asyncio.run(answers(create_app(
        Config().override(**cfg), lambda c, **kw: CameraEngine(c, NeRFReal.set_orbit_camera, pose),
        devices=[CPU])))
    ref = asyncio.run(answers(j_create_app(
        JConfig().override(**cfg),
        lambda c, **kw: CameraEngine(c, JNeRFReal.set_orbit_camera, pose))))
    assert [a["code"] for a in port] == [a["code"] for a in ref] == [0] * len(requests)
    for got, want in zip(port, ref):
        if isinstance(want["data"], str):
            assert got["data"] == want["data"] == "camera disabled"
            continue
        assert got["data"]["radius"] == pytest.approx(want["data"]["radius"], abs=1e-6)
        np.testing.assert_allclose(got["data"]["pose"], want["data"]["pose"], rtol=0, atol=1e-6)


def test_camera_route_without_a_camera():
    async def main():
        app = create_app(Config().override(**{"transport.mode": "loopback"}),
                         engine_factory=lambda c: FakeEngine(c), devices=[CPU])
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            sid = (await (await client.post("/start_session", json={})).json())["session_id"]
            r = await client.post("/camera", json={"session_id": sid, "orbit": [10, 0]})
            body = await r.json()
            assert r.status == 400 and body["code"] != 0 and "camera" in body["message"]
            r = await client.post("/camera", json={"session_id": "nope"})
            assert r.status == 404
        finally:
            await client.close()

    asyncio.run(main())
