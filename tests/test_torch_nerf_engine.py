"""The PyTorch port's ER-NeRF serving path against the JAX package, on the
CPU at toy sizes (64² frames, 4 hash levels, 8 samples per ray, 16×8
tiles): the whole K2 frame step against ``make_pallas_render_step`` with
the Pallas kernel in interpret mode (uint8 frames within 1 LSB, the
ROADMAP rule: float sums in another order can move a value across a
truncation boundary), its span cache and density swap, the unbaked
hash-encode step against ``make_nerf_render_step(baked=None)`` (1 LSB),
the dataset loader, the feature ring, and ``make_engine`` serving a
loopback session through the port's server in each sample mode (the K2
step, nearest, bilinear) and unbaked."""
from __future__ import annotations

import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from mere_fusion_tpu.config import Config as JConfig
from mere_fusion_tpu.data.provider import NeRFTestDataset as JDataset
from mere_fusion_tpu.engines.nerf import NerfASR as JNerfASR
from mere_fusion_tpu.engines.nerf import make_nerf_render_step
from mere_fusion_tpu.engines.nerf_pallas import make_pallas_render_step
from mere_fusion_tpu.engines.nerf_pallas import shade_weights as j_shade_weights
from mere_fusion_tpu.models.ernerf.network import NeRFNetConfig as JNetConfig
from mere_fusion_tpu.models.ernerf.network import NeRFNetwork as JNetwork
from mere_fusion_tpu.models.ernerf.renderer import DensityGrid as JDensity
from mere_fusion_tpu.ops.pallas_sampler import SamplerSpec as JSpec
from mere_fusion_tpu.ops.triplane_bake import bake_triplanes as j_bake
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.convert import density_from_flax, ernerf_from_flax
from mere_fusion_tpu_torch.data.provider import NeRFTestDataset, synthesize_nerf_dataset
from mere_fusion_tpu_torch.engines import make_engine
from mere_fusion_tpu_torch.engines.nerf import NeRFReal, NerfASR, fake_logits_fn
from mere_fusion_tpu_torch.engines.nerf_baked import make_unbaked_render_step
from mere_fusion_tpu_torch.engines.nerf_step import make_render_step, shade_weights
from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetConfig, NeRFNetwork
from mere_fusion_tpu_torch.ops import sampler as psamp
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.server.app import create_app

CPU = torch.device("cpu")
OVERRIDES = {
    "tts.backend": "procedural",
    "avatar.kind": "ernerf",
    "transport.mode": "loopback",
    "nerf.grid_size": 16,
    "nerf.num_levels": 4,
    "nerf.base_resolution": 16,
    "nerf.desired_resolution": 64,
    "nerf.log2_hashmap_size": 10,
    "nerf.max_steps": 8,
    "nerf.tile_budget": 8,
}
NET = dict(num_levels=4, base_resolution=16, desired_resolution=64, log2_hashmap_size=10)
N_TILES = 64 * 64 // (Config().nerf.pallas_tile_w * Config().nerf.pallas_tile_h)  # 64² frame


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return synthesize_nerf_dataset(str(tmp_path_factory.mktemp("nerfdata")), hw=64)


@pytest.fixture(scope="module")
def datasets(data_dir):
    kw = dict(scale=1.0, smooth_path=True, smooth_path_window=3, smooth_eye=True)
    return (JDataset.load(f"{data_dir}/transforms.json", f"{data_dir}/au.csv", **kw),
            NeRFTestDataset.load(f"{data_dir}/transforms.json", f"{data_dir}/au.csv", **kw))


@pytest.fixture(scope="module")
def parts(datasets):
    """(JAX network, its variables, the baked textures, the port's network
    with those weights, the textures as torch tensors)."""
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
    baked = j_bake(params, JNetConfig(**NET).plane_spec, 1.0, resolution=128,
                   dtype=jnp.bfloat16)
    pnet = NeRFNetwork(NeRFNetConfig(**NET))
    pnet.load_state_dict(ernerf_from_flax(variables, NeRFNetConfig(**NET)), strict=True)
    pbaked = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
              for k, v in baked.items()}
    return jnet, variables, baked, pnet.eval(), pbaked


def make_steps(parts, datasets, shade_dtype: str):
    """(JAX step with the Pallas K2 in interpret mode, port step) on the same
    weights and baked textures, at nerf.shade_dtype ``shade_dtype``."""
    jnet, variables, baked, pnet, pbaked = parts
    jds, pds = datasets
    over = {**OVERRIDES, "nerf.shade_dtype": shade_dtype}
    return (make_pallas_render_step(jnet, variables, jds, JConfig().override(**over),
                                    baked=baked, interpret=True),
            make_render_step(pnet, pds, Config().override(**over), pbaked))


@pytest.fixture(scope="module")
def pipelines(parts, datasets):
    """(JAX step, port step, JAX net+variables, port net) on the same
    weights and the same baked textures, bf16 shade weights."""
    jnet, variables, _, pnet, _ = parts
    return (*make_steps(parts, datasets, "bfloat16"), (jnet, variables), pnet)


def test_dataset_load_matches_jax(datasets):
    jds, pds = datasets
    np.testing.assert_allclose(pds.poses, jds.poses, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pds.eye_area, jds.eye_area)
    assert (pds.H, pds.W, pds.intrinsics) == (jds.H, jds.W, jds.intrinsics)
    np.testing.assert_array_equal(pds.bg_img, jds.bg_img)
    assert pds.collate(5)["index"] == jds.collate(5)["index"] == 2


def test_shade_weights_match_jax(pipelines):
    _, _, (jnet, variables), pnet = pipelines
    spec_kw = dict(resolution=128, channels=4, tile_w=16, tile_h=8, k=8, kg=4, wu=64, wv=16)
    rng = np.random.default_rng(6)
    enc_a = rng.standard_normal((1, 32)).astype(np.float32)
    ind = rng.standard_normal((1, 4)).astype(np.float32)
    eye = np.asarray([[0.4]], np.float32)
    for jdt, pdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = j_shade_weights(variables["params"], JSpec(**spec_kw), jnp.asarray(enc_a),
                              jnp.asarray(ind), jnp.asarray(eye), jdt)
        got = shade_weights(pnet, psamp.SamplerSpec(**spec_kw), torch.from_numpy(enc_a),
                            torch.from_numpy(ind), torch.from_numpy(eye), pdt)
        assert list(got) == list(psamp.SHADE_WEIGHTS)
        for name in psamp.SHADE_WEIGHTS:
            assert got[name].dtype == pdt and got[name].is_contiguous()
            np.testing.assert_allclose(got[name].float().numpy(),
                                       np.asarray(ref[name].astype(jnp.float32)),
                                       rtol=0, atol=1e-6, err_msg=name)


def frame_pair(steps, datasets, index, auds, jdens, pdens, pose_key):
    jstep, pstep = steps[:2]
    jds, pds = datasets
    jd, pd = jds.collate(index), pds.collate(index)
    ji, jn, jo = jstep(jd["pose"], jnp.asarray(auds), jnp.asarray(jd["eye"]), jdens,
                       jnp.asarray(jd["bg_color"]), pose_key=pose_key)
    pi, pn, po = pstep(pd["pose"], torch.from_numpy(auds), pd["eye"], pdens,
                       torch.from_numpy(pd["bg_color"]), pose_key=pose_key)
    assert pi.dtype == torch.uint8 and pi.shape == (64, 64, 3)
    diff = np.abs(pi.numpy().astype(int) - np.asarray(ji).astype(int))
    assert diff.max() <= 1, f"frames differ by {diff.max()} LSB"
    assert int(pn) == int(jn) and int(po) == int(jo)
    return pi.numpy(), int(pn)


@pytest.mark.parametrize("shade_dtype", ["bfloat16", "float32"])
def test_frame_step_matches_jax(parts, pipelines, datasets, shade_dtype):
    steps = pipelines if shade_dtype == "bfloat16" else make_steps(parts, datasets, shade_dtype)
    pstep = steps[1]
    rng = np.random.default_rng(8)
    g = 16
    jdense = JDensity.create(g)
    pdense = density_from_flax(jdense)
    a0 = rng.standard_normal((8, 44, 16)).astype(np.float32)
    img0, n0 = frame_pair(steps, datasets, 0, a0, jdense, pdense, 0)
    assert n0 == N_TILES                           # dense grid: every tile active
    assert img0.std() > 2, "the frame must show the rendered head"
    assert set(pstep.span_cache) == {0}
    # a cached pose and new audio (the EMA carries the previous code)
    a1 = rng.standard_normal((8, 44, 16)).astype(np.float32)
    frame_pair(steps, datasets, 0, a1, jdense, pdense, 0)
    # a density swap drops the cache; the sparse grid leaves tiles inactive,
    # so the port compacts while the JAX step pads to a ladder rung
    occ = np.zeros((g, g, g), bool)
    occ[6:10, 6:10, 6:10] = True
    jsparse = JDensity(grid=jnp.zeros(g**3), occupancy=jnp.asarray(occ.reshape(-1)),
                       mean_density=jnp.zeros(()))
    psparse = density_from_flax(jsparse)
    _, n_sparse = frame_pair(steps, datasets, 1, a1, jsparse, psparse, 1)
    assert 0 < n_sparse < N_TILES
    assert set(pstep.span_cache) == {1}
    # uncached (pose_key None): full coverage, no cache entry
    frame_pair(steps, datasets, 2, a0, jsparse, psparse, None)
    assert set(pstep.span_cache) == {1}


def test_warmup_prefills_the_span_cache_up_to_the_cap(datasets):
    _, pds = datasets
    cfg = Config().override(**OVERRIDES, **{"nerf.span_cache_poses": 3})
    engine = NeRFReal(cfg, dataset=pds, device=CPU)
    step = engine._render_step
    step.warmup(engine.density, engine._bg_dev)
    assert set(step.span_cache) == {0, 1, 2}
    img, n_act, _ = step(pds.poses[3], torch.zeros(8, 44, 16), pds.collate(3)["eye"],
                         engine.density, engine._bg_dev, pose_key=3)
    assert img.shape == (64, 64, 3) and int(n_act) == N_TILES
    assert set(step.span_cache) == {0, 1, 2}, "the cap must hold after warmup"


def test_feature_ring_matches_jax_and_device_window():
    cfg, jcfg = Config().override(**OVERRIDES), JConfig().override(**OVERRIDES)
    asr_p = NerfASR(cfg, None, fake_logits_fn(44))
    asr_d = NerfASR(cfg, None, fake_logits_fn(44))
    asr_j = JNerfASR(jcfg, None, fake_logits_fn(44))
    for a in (asr_p, asr_d, asr_j):
        a.warm_up()
    rng = np.random.default_rng(9)
    for step in range(30):
        for _ in range(2):
            chunk = (0.5 * rng.standard_normal(320)).astype(np.float32)
            for a in (asr_p, asr_d, asr_j):
                a.put_audio_frame(chunk)
                a.run_step()
        host = asr_p.get_next_feat()
        np.testing.assert_array_equal(host, asr_j.get_next_feat())
        np.testing.assert_array_equal(asr_d.get_next_feat_device().numpy(), host)
    assert np.abs(host).sum() > 0, "speech features must reach the window"


def test_unported_options_raise(datasets, data_dir, tmp_path, monkeypatch):
    """The options that raised until the featurizer, orbit and fullbody
    slice now build: a DeepSpeech ``nerf.asr_model`` (a graph at hidden
    width 4, with its bf16 device form), the orbit camera and
    ``nerf.fullbody_imgs``. What stays unported still raises naming its
    ROADMAP item: an orbax ``nerf.ckpt``."""
    import cv2

    from chip_smoke import deepspeech_graph_names, write_graphdef
    from mere_fusion_tpu_torch.audio import deepspeech

    paths = {"nerf.pose_path": f"{data_dir}/transforms.json",
             "nerf.au_path": f"{data_dir}/au.csv", "nerf.scale": 1.0}
    monkeypatch.setattr(deepspeech, "PARAM_SHAPES", {
        "h1": (494, 4), "b1": (4,), "h2": (4, 4), "b2": (4,), "h3": (4, 8), "b3": (8,),
        "lstm_fw_kernel": (12, 16), "lstm_fw_bias": (16,), "lstm_bw_kernel": (12, 16),
        "lstm_bw_bias": (16,), "h5": (8, 4), "b5": (4,), "h6": (4, 29), "b6": (29,)})
    pb = str(tmp_path / "ds.pb")
    write_graphdef(pb, deepspeech_graph_names(deepspeech.init_params()))
    engine = make_engine(Config().override(**OVERRIDES, **paths, **{
        "nerf.asr_model": pb, "nerf.audio_in_dim": 29}), device=CPU)
    assert engine.asr.device_logits_fn is not None and engine.asr.audio_dim == 29
    assert engine.set_orbit_camera(True) is engine.orbit is not None
    body = tmp_path / "body"
    body.mkdir()
    for i in range(3):
        cv2.imwrite(str(body / f"{i}.png"), np.full((80, 96, 3), 40 * i, np.uint8))
    engine = make_engine(Config().override(**OVERRIDES, **paths, **{
        "nerf.fullbody_imgs": str(body), "nerf.fullbody_offset": (4, 8)}), device=CPU)
    assert len(engine.fullbody_frames) == 3 and engine.fullbody_offset == (4, 8)
    assert (engine.fullbody_frames[2] == 80).all()
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="ROADMAP: 'Checkpoints'"):
        make_engine(Config().override(**OVERRIDES, **paths,
                                      **{"nerf.ckpt": str(tmp_path / "orbax")}), device=CPU)


@pytest.mark.parametrize("shade_dtype", ["bfloat16", "float32"])
def test_unbaked_step_matches_jax(pipelines, datasets, shade_dtype):
    _, _, (jnet, variables), pnet = pipelines
    jds, pds = datasets
    over = {**OVERRIDES, "nerf.shade_dtype": shade_dtype,
            # half the 64² frame: the compaction keeps the first rays in raster order
            "nerf.max_active_rays": 2048}
    jstep = make_nerf_render_step(jnet, variables, jds, JConfig().override(**over), baked=None)
    pstep = make_unbaked_render_step(pnet, pds, Config().override(**over))
    g = 16
    occ = np.zeros((g, g, g), bool)
    occ[5:11, 4:12, 5:11] = True
    grids = [JDensity.create(g), JDensity(grid=jnp.zeros(g**3), mean_density=jnp.zeros(()),
                                          occupancy=jnp.asarray(occ.reshape(-1)))]
    rng = np.random.default_rng(8)
    frames = []
    for index, jdens in ((0, grids[0]), (1, grids[1]), (2, grids[1])):
        auds = rng.standard_normal((8, 44, 16)).astype(np.float32)   # the EMA carries over
        jd, pd = jds.collate(index), pds.collate(index)
        ji = np.asarray(jstep(jd["pose"], jnp.asarray(auds), jnp.asarray(jd["eye"]), jdens,
                              jnp.asarray(jd["bg_color"])))
        pi, n_active, n_overflow = pstep(pd["pose"], torch.from_numpy(auds), pd["eye"],
                                         density_from_flax(jdens), torch.from_numpy(pd["bg_color"]))
        assert n_active is None and n_overflow is None
        assert pi.dtype == torch.uint8 and pi.shape == (64, 64, 3)
        diff = np.abs(pi.numpy().astype(int) - ji.astype(int))
        assert diff.max() <= 1, f"unbaked frame {index} differs by {diff.max()} LSB"
        frames.append(pi.numpy())
    # the budget cuts the dense frame: its lower half is background
    assert frames[0][:32].std() > 2 and (frames[0][40:] == frames[0][63, 0]).all()
    assert (frames[1] != frames[2]).any()


@pytest.mark.parametrize("mode", ["pallas", "bilinear", "nearest", "unbaked"])
def test_make_engine_serves_a_loopback_session(data_dir, mode):
    cfg = Config().override(**OVERRIDES, **{
        "nerf.pose_path": f"{data_dir}/transforms.json",
        "nerf.au_path": f"{data_dir}/au.csv", "nerf.scale": 1.0,
        "server.max_sessions": 1, "nerf.sample_mode": "pallas" if mode == "unbaked" else mode})
    engines = []

    def factory(c, **kw):
        if mode == "unbaked":
            kw["bake_planes"] = False
        engines.append(make_engine(c, **kw))
        return engines[-1]

    async def main():
        client = TestClient(TestServer(create_app(cfg, factory, devices=[CPU])))
        await client.start_server()
        try:
            body = await (await client.post("/start_session", json={})).json()
            assert body["code"] == 0, body
            sid = body["session_id"]
            start = metrics.latency("nerf.render").count
            r = await client.post("/talk", json={"session_id": sid, "type": "echo",
                                                 "text": "the nerf port speaks"})
            assert (await r.json())["code"] == 0
            deadline = time.monotonic() + 120
            while metrics.latency("nerf.render").count < start + 6:
                assert time.monotonic() < deadline, "no rendered frames"
                await asyncio.sleep(0.05)
            frame = engines[0].latest_frame
            r = await client.post("/stop_session", json={"session_id": sid})
            assert (await r.json())["code"] == 0
        finally:
            await client.close()
        return frame

    frame = asyncio.run(main())
    assert isinstance(engines[0], NeRFReal) and engines[0].device == CPU
    factory = {"pallas": "make_render_step", "unbaked": "make_unbaked_render_step"}.get(
        mode, "make_baked_render_step")
    assert engines[0]._render_step.__qualname__.startswith(factory + ".")
    assert frame is not None and frame.image.shape == (64, 64, 3)
    assert frame.image.dtype == np.uint8
