"""The MuseTalk slice of the PyTorch port against the JAX package.

Weights come from the JAX init (with norm scales and biases jittered, so an
identity leaf cannot hide a key-mapping bug) through mere_fusion_tpu_torch
.convert; inputs come from numpy seeds. Tolerances: 3e-4 relative for the
VAE and UNet (deep f32 stacks, as tests/test_musetalk_parity.py), 1 LSB for
the uint8 faces of the whole generation step. Then the port's engine and
its loopback session server run end to end on the CPU.
"""
from __future__ import annotations

import asyncio
import dataclasses
import functools
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from jax.experimental import pallas as pl

import mere_fusion_tpu.models.musetalk.unet as jax_unet_mod
import mere_fusion_tpu.ops.attention as jax_attention
from mere_fusion_tpu.engines.muse import MuseModels as JaxMuseModels
from mere_fusion_tpu.models.musetalk import AutoencoderKL as JaxVAE
from mere_fusion_tpu.models.musetalk import UNet2DCondition as JaxUNet
from mere_fusion_tpu.utils.diffusers_convert import convert_musetalk_unet, convert_vae
from mere_fusion_tpu.utils.torch_convert import convert_whisper
from mere_fusion_tpu_torch.audio.features import WhisperFeatureExtractor
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.convert import (
    unet_from_flax,
    vae_from_flax,
    whisper_encoder_from_flax,
)
from mere_fusion_tpu_torch.device import random_init_, resolve_device
from mere_fusion_tpu_torch.engines import load_serving_tree, make_engine
from mere_fusion_tpu_torch.engines.muse import MuseModels, MuseReal, synthesize_muse_avatar
from mere_fusion_tpu_torch.models.musetalk import (
    AutoencoderKL,
    UNet2DCondition,
    UNetConfig,
    VAEConfig,
)
from mere_fusion_tpu_torch.models.whisper import AudioEncoder, WhisperDims
from mere_fusion_tpu_torch.ops import attention
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.server.app import MANAGER, create_app
from mere_fusion_tpu_torch.transport.mp4 import parse_boxes
from tests.test_musetalk import SMALL_WHISPER, TINY_UNET, TINY_VAE
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PORT_VAE = VAEConfig(**dataclasses.asdict(TINY_VAE))
PORT_UNET = UNetConfig(**dataclasses.asdict(TINY_UNET))
PORT_WHISPER = WhisperDims(**dataclasses.asdict(SMALL_WHISPER))


def _max_rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / max(1e-6, float(np.abs(b).max())))


def _jitter(tree, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + (rng.uniform(-0.2, 0.2, x.shape).astype(np.float32)
                                   if x.ndim == 1 else np.float32(0.0)),
        tree)


@pytest.fixture(scope="module")
def jax_models():
    m = JaxMuseModels(TINY_VAE, TINY_UNET, face_size=64, vae_int8="off")
    m.vae_vars = _jitter(m.vae_vars, 11)
    m.unet_vars = _jitter(m.unet_vars, 12)
    return m


@pytest.fixture(scope="module")
def port_models(jax_models):
    return MuseModels(PORT_VAE, PORT_UNET,
                      vae_state=vae_from_flax(jax_models.vae_vars, PORT_VAE),
                      unet_state=unet_from_flax(jax_models.unet_vars, PORT_UNET),
                      face_size=64, device=CPU, vae_int8="off")


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(jax_attention.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# ---- models -----------------------------------------------------------------

def test_vae_encode_decode_match_jax(jax_models, port_models):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    vae = JaxVAE(TINY_VAE)
    mean_ref = np.asarray(vae.apply(jax_models.vae_vars, jnp.asarray(x),
                                    method=JaxVAE.encode))
    dec_ref = np.asarray(vae.apply(jax_models.vae_vars, jnp.asarray(mean_ref),
                                   method=JaxVAE.decode))
    with torch.no_grad():
        mean = port_models.vae.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
        dec = port_models.vae.decode(torch.from_numpy(mean_ref.copy()).permute(0, 3, 1, 2))
    assert _max_rel(mean.permute(0, 2, 3, 1).numpy(), mean_ref) < 3e-4
    assert _max_rel(dec.permute(0, 2, 3, 1).numpy(), dec_ref) < 3e-4
    _, logvar = port_models.vae.moments(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert logvar.min() >= -30.0 and logvar.max() <= 20.0


@pytest.mark.parametrize("tval", [0.0, 7.0])
def test_unet_matches_jax_fused(jax_models, port_models, interpret_pallas,
                                monkeypatch, tval):
    """32×32 latents: the self-attentions pass the lq >= 512 K1 site on both
    sides (JAX: the Pallas kernel in interpret mode)."""
    monkeypatch.setattr(jax_unet_mod, "ATTN_IMPL", "fused")
    calls = []
    real = attention.self_attention
    monkeypatch.setattr(attention, "self_attention",
                        lambda q, k, v: calls.append(q.shape) or real(q, k, v))
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 50, 64)).astype(np.float32)
    t = np.full((2,), tval, np.float32)
    ref = np.asarray(JaxUNet(TINY_UNET).apply(
        jax_models.unet_vars, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        out = port_models.unet(torch.from_numpy(lat).permute(0, 3, 1, 2),
                               torch.from_numpy(t), torch.from_numpy(ctx))
    assert _max_rel(out.permute(0, 2, 3, 1).numpy(), ref) < 3e-4
    # down_0 (1 layer) + up_1 (2 layers) at 32×32, 4 heads of 8
    assert calls == [(2, 4, 1024, 8)] * 3


def test_generate_matches_jax_within_one_lsb(jax_models, port_models):
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)
    feats = rng.standard_normal((2, 50, 64)).astype(np.float32)
    ref = np.asarray(jax_models.generate(jnp.asarray(lat), jnp.asarray(feats)))
    out = port_models.generate(torch.from_numpy(lat), torch.from_numpy(feats))
    assert out.dtype == torch.uint8 and out.shape == ref.shape == (2, 64, 64, 3)
    assert np.abs(out.numpy().astype(int) - ref.astype(int)).max() <= 1


def test_encode_pair_matches_jax(jax_models, port_models):
    rng = np.random.default_rng(4)
    faces = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax_models.encode_pair(jnp.asarray(faces)))
    out = port_models.encode_pair(torch.from_numpy(faces)).numpy()
    assert out.shape == ref.shape == (2, 32, 32, 8)
    assert _max_rel(out, ref) < 3e-4


# ---- converters -------------------------------------------------------------

def _random_state(module: torch.nn.Module, seed: int) -> dict:
    random_init_(module, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim == 1:
                p.add_(torch.rand(p.shape, generator=gen) - 0.5)
    return module.state_dict()


def _whisper_decoder_zeros(d: WhisperDims) -> dict:
    n = d.n_text_state
    sd = {"decoder.token_embedding.weight": torch.zeros(d.n_vocab, n),
          "decoder.positional_embedding": torch.zeros(d.n_text_ctx, n),
          "decoder.ln.weight": torch.zeros(n), "decoder.ln.bias": torch.zeros(n)}
    for i in range(d.n_text_layer):
        b = f"decoder.blocks.{i}"
        for att in ("attn", "cross_attn"):
            for lin in ("query", "key", "value", "out"):
                sd[f"{b}.{att}.{lin}.weight"] = torch.zeros(n, n)
                if lin != "key":
                    sd[f"{b}.{att}.{lin}.bias"] = torch.zeros(n)
        for ln in ("attn_ln", "cross_attn_ln", "mlp_ln"):
            sd[f"{b}.{ln}.weight"] = torch.zeros(n)
            sd[f"{b}.{ln}.bias"] = torch.zeros(n)
        sd[f"{b}.mlp.0.weight"] = torch.zeros(4 * n, n)
        sd[f"{b}.mlp.0.bias"] = torch.zeros(4 * n)
        sd[f"{b}.mlp.2.weight"] = torch.zeros(n, 4 * n)
        sd[f"{b}.mlp.2.bias"] = torch.zeros(n)
    return sd


def _assert_same_state(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("family", ["vae", "unet", "whisper"])
def test_converters_round_trip_exactly(family):
    if family == "vae":
        sd = _random_state(AutoencoderKL(PORT_VAE), 0)
        back = vae_from_flax(convert_vae(sd, n_down=2))
    elif family == "unet":
        sd = _random_state(UNet2DCondition(PORT_UNET), 1)
        back = unet_from_flax(convert_musetalk_unet(sd, TINY_UNET), PORT_UNET)
    else:
        sd = _random_state(AudioEncoder(PORT_WHISPER), 2)
        full = {f"encoder.{k}": v for k, v in sd.items()}
        full.update(_whisper_decoder_zeros(PORT_WHISPER))
        back = whisper_encoder_from_flax(convert_whisper(full, SMALL_WHISPER), PORT_WHISPER)
    _assert_same_state(sd, back)


def test_converters_reject_missing_and_extra_keys():
    tree = convert_vae(AutoencoderKL(PORT_VAE).state_dict(), n_down=2)
    del tree["params"]["decoder"]["conv_in"]["bias"]
    with pytest.raises(KeyError, match=r"missing \['decoder.conv_in.bias'\]"):
        vae_from_flax(tree, PORT_VAE)
    tree = convert_musetalk_unet(UNet2DCondition(PORT_UNET).state_dict(), TINY_UNET)
    tree["params"]["conv_in"]["extra"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match=r"extra \['conv_in.extra.bias'\]"):
        unet_from_flax(tree, PORT_UNET)


def test_torch_checkpoints_load_natively(tmp_path, port_models):
    """Diffusers-named .bin files load with strict=True, legacy VAE
    attention names included; a directory that holds no checkpoint is
    refused."""
    vae_sd = {k: v.clone() for k, v in port_models.vae.state_dict().items()}
    legacy = {k.replace(".to_out.0.", ".proj_attn.").replace(".to_q.", ".query."): v
              for k, v in vae_sd.items()}
    torch.save(legacy, tmp_path / "vae.bin")
    torch.save(port_models.unet.state_dict(), tmp_path / "unet.bin")
    vae_state, _ = load_serving_tree("vae", str(tmp_path / "vae.bin"))
    unet_state, _ = load_serving_tree("musetalk-unet", str(tmp_path / "unet.bin"))
    m = MuseModels(PORT_VAE, PORT_UNET, vae_state=vae_state, unet_state=unet_state,
                   face_size=64, device=CPU, vae_int8="off")
    _assert_same_state(m.vae.state_dict(), vae_sd)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_serving_tree("vae", str(tmp_path))


# ---- engine contracts ---------------------------------------------------------

def test_vae_int8_modes():
    """"on" serves the int8 VAE decode (the JAX "full" tier); "auto" runs the
    load-time gate over the rungs in order and serves the first at or above
    40 dB, else float (tests/test_torch_quant.py holds it against JAX)."""
    m = MuseModels(PORT_VAE, PORT_UNET, face_size=64, device=CPU, vae_int8="on")
    assert m.int8_tier == "full" and m.int8_enabled and m.int8_gate_probes == {}
    m = MuseModels(PORT_VAE, PORT_UNET, face_size=64, device=CPU, vae_int8="auto")
    names = [name for name, *_ in MuseModels.INT8_RUNGS]
    assert list(m.int8_gate_probes) == names[:len(m.int8_gate_probes)]
    passed = [n for n, db in m.int8_gate_probes.items() if db >= MuseModels.INT8_GATE_DB]
    assert m.int8_tier == (passed[0] if passed else "off")
    assert passed in ([], [list(m.int8_gate_probes)[-1]])


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == CPU


@pytest.mark.parametrize("kind", ["wav2lip", "ernerf"])
def test_unported_engines_raise(kind, tmp_path):
    """Both engines that once raised now serve. wav2lip, the default
    engine: make_engine(Config()) builds a LipReal with seeded weights that
    serves idle frames of its avatar. ernerf serves since the ER-NeRF slice
    and its fullbody paste since the featurizer slice: a make_engine with
    nerf.fullbody_imgs builds and pastes its head."""
    if kind == "wav2lip":
        from mere_fusion_tpu_torch.engines.avatar import synthesize_avatar
        from mere_fusion_tpu_torch.engines.lip import LipReal

        avatar = synthesize_avatar(str(tmp_path / "avatars" / "avator_1"), n_frames=4)
        engine = make_engine(Config().override(**{"avatar.avatar_dir": str(tmp_path / "avatars")}),
                             device=CPU)
        assert isinstance(engine, LipReal) and Config().avatar.kind == kind
        quit_event = threading.Event()
        threading.Thread(target=engine.process_frames, args=(quit_event,), daemon=True).start()
        threading.Thread(target=engine._inference_loop, args=(quit_event,), daemon=True).start()
        engine.render_event.set()
        try:
            cycle = [f.tobytes() for f in avatar.frame_cycle]
            for _ in range(2):
                engine.asr.run_step()
            for _ in range(300):
                if engine.latest_frame is not None:
                    break
                time.sleep(0.01)
            assert engine.latest_frame.image.tobytes() in cycle
        finally:
            quit_event.set()
        return
    import cv2

    from mere_fusion_tpu_torch.data.provider import synthesize_nerf_dataset

    d = synthesize_nerf_dataset(str(tmp_path / "data"), hw=64)
    (tmp_path / "body").mkdir()
    cv2.imwrite(str(tmp_path / "body" / "0.jpg"), np.zeros((72, 80, 3), np.uint8))
    engine = make_engine(Config().override(**{
        "avatar.kind": kind, "tts.backend": "procedural", "nerf.pose_path": f"{d}/transforms.json",
        "nerf.au_path": f"{d}/au.csv", "nerf.scale": 1.0, "nerf.fullbody_imgs": str(tmp_path / "body"),
        "nerf.fullbody_offset": (16, 8), "nerf.grid_size": 16, "nerf.num_levels": 4,
        "nerf.base_resolution": 16, "nerf.desired_resolution": 64,
        "nerf.log2_hashmap_size": 10, "nerf.max_steps": 8}), device=CPU)
    engine.asr.run_step()
    engine.asr.run_step()
    assert engine.test_step()
    image = engine.latest_frame.image
    assert image.shape == (72, 80, 3) and image[:8].max() == 0 and image[8:, 16:].std() > 0


def _engine_cfg() -> Config:
    return Config().override(**{
        "avatar.kind": "musetalk", "avatar.batch_size": 2, "avatar.dtype": "float32",
        "tts.backend": "procedural", "stride.left": 4, "stride.right": 4,
        "transport.mode": "loopback", "server.max_sessions": 1})


def test_muse_engine_end_to_end(port_models):
    avatar = synthesize_muse_avatar(port_models, n_frames=4)
    extractor = WhisperFeatureExtractor(dims=PORT_WHISPER, device=CPU)
    engine = MuseReal(_engine_cfg(), models=port_models, avatar=avatar,
                      feature_extractor=extractor)

    async def main():
        loop = asyncio.get_running_loop()
        vtrack = SimpleNamespace(_queue=asyncio.Queue())
        atrack = SimpleNamespace(_queue=asyncio.Queue())
        quit_event = threading.Event()
        t = threading.Thread(target=engine.render,
                             args=(quit_event, loop, atrack, vtrack), daemon=True)
        t.start()
        engine.put_msg_txt("muse speaks")
        frames = []
        try:
            while len(frames) < 16:
                frames.append(await asyncio.wait_for(vtrack._queue.get(), timeout=120))
        finally:
            quit_event.set()
            t.join(timeout=10)
        assert not t.is_alive()
        return frames

    frames = asyncio.run(main())
    cycle = [f.tobytes() for f in avatar.frame_cycle]
    assert any(f.image.tobytes() not in cycle for f in frames), "speech must blend faces"
    assert all(f.image.shape == avatar.frame_cycle[0].shape for f in frames)


def test_loopback_server_session(port_models, tmp_path):
    avatar = synthesize_muse_avatar(port_models, n_frames=4)
    extractor = WhisperFeatureExtractor(dims=PORT_WHISPER, device=CPU)

    def factory(cfg, **kw):
        return make_engine(cfg, models=port_models, avatar=avatar,
                           feature_extractor=extractor, **kw)

    def generated() -> float:
        return metrics.snapshot()["counters"].get("muse.generated_frames", 0.0)

    async def main():
        client = TestClient(TestServer(create_app(_engine_cfg(), factory,
                                                  devices=[CPU])))
        await client.start_server()
        try:
            r = await client.post("/start_session", json={})
            body = await r.json()
            assert r.status == 200 and body["code"] == 0, body
            sid = body["session_id"]
            assert client.app[MANAGER].get(sid).device == CPU
            assert (await client.post("/start_session", json={})).status == 429
            start = generated()
            r = await client.post("/talk", json={"session_id": sid, "type": "echo",
                                                 "text": "hello from the port"})
            assert (await r.json())["code"] == 0
            for _ in range(600):
                if generated() >= start + 4:
                    break
                await asyncio.sleep(0.1)
            assert generated() >= start + 4
            out = str(tmp_path / "call.mp4")
            written = metrics.latency("record.frame").count
            r = await client.post("/record", json={"session_id": sid,
                                                   "type": "start_record", "path": out})
            assert (await r.json())["code"] == 0
            model = client.app[MANAGER].get(sid).model
            for _ in range(600):
                if metrics.latency("record.frame").count >= written + 2:
                    break
                await asyncio.sleep(0.05)
            r = await client.post("/record", json={"session_id": sid, "type": "end_record"})
            assert (await r.json())["code"] == 0
            model.record_thread.join(timeout=10)
            data = open(out, "rb").read()
            assert [t for t, _, _ in parse_boxes(data)] == [b"ftyp", b"free", b"mdat", b"moov"]
            r = await client.post("/stop_session", json={"session_id": sid})
            assert (await r.json())["code"] == 0
            r = await client.post("/interrupt", json={"session_id": sid})
            assert r.status == 404
        finally:
            await client.close()

    asyncio.run(main())
