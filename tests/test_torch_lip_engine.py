"""The Wav2Lip engine of the PyTorch port against the JAX package.

The mel windows within 1e-4 of JAX's (its f32 DFT rounds near-empty bins;
the port's runs in float64), the device step's uint8 faces within 1 LSB in
float32 and, in bfloat16, no more than BF16_SHARE of values more than 1 LSB
apart; the avatar bundle byte-equal; then the port's engine on the CPU:
the twins of tests/test_lip_engine.py's session tests and make_engine
serving ``avatar.ckpt`` from one shared tree (the twin of
tests/test_serving_ckpt.py::test_make_engine_wav2lip_serving_ckpt).
Generator weights from numpy seeds (tests/test_torch_wav2lip.py).
"""
from __future__ import annotations

import asyncio
import os
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.config import Config as JaxConfig
from mere_fusion_tpu.engines import avatar as jax_avatar
from mere_fusion_tpu.engines import lip as jax_lip
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.convert import wav2lip_from_flax
from mere_fusion_tpu_torch.engines import _DEVICE_TREES, make_engine
from mere_fusion_tpu_torch.engines.avatar import load_lip_avatar, synthesize_avatar
from mere_fusion_tpu_torch.engines.base_asr import BaseASR
from mere_fusion_tpu_torch.engines.lip import (
    LipReal,
    load_wav2lip,
    make_lip_device_step,
    make_lip_feature_fn,
    mel_window_starts,
)
from tests.test_torch_wav2lip import BF16_SHARE, generator_tree
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
MEL_ATOL = 1e-4


@pytest.fixture(scope="module")
def gen_tree():
    return generator_tree(seed=11)


@pytest.fixture(scope="module")
def jax_step(gen_tree):
    """JAX's device step for a dtype, built once for the file: each dtype's
    step compiles once at the shapes the tests share."""
    steps = {}

    def get(jdt):
        if jdt not in steps:
            steps[jdt] = jax_lip.make_lip_device_step(gen_tree, 96, jdt)
        return steps[jdt]

    return get


@pytest.fixture(scope="module")
def avatar(tmp_path_factory):
    return synthesize_avatar(str(tmp_path_factory.mktemp("avatar")), n_frames=6)


def _cfg(**over) -> Config:
    return Config().override(**{"avatar.batch_size": 2, "tts.backend": "procedural",
                                "avatar.dtype": "float32", **over})


@pytest.fixture(scope="module")
def engine(avatar):
    return LipReal(_cfg(), avatar=avatar, device=CPU)


def _speech(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    voiced = 0.3 * np.sin(2 * np.pi * 180 * t) * (1 + np.sin(2 * np.pi * 3 * t))
    return (voiced + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n_chunks,batch,fps,left", [(52, 16, 25, 10), (24, 2, 25, 10),
                                                     (36, 8, 30, 6)])
def test_mel_window_starts_match_jax(n_chunks, batch, fps, left):
    args = (n_chunks, 16000 // (fps * 2), batch, fps, left)
    assert mel_window_starts(*args) == jax_lip.mel_window_starts(*args)


@pytest.mark.parametrize("batch", [2, 16])
def test_feature_fn_matches_jax(batch):
    over = {"avatar.batch_size": batch}
    features, n_chunks = make_lip_feature_fn(Config().override(**over), CPU)
    jax_features, jax_n = jax_lip.make_lip_feature_fn(JaxConfig().override(**over))
    assert n_chunks == jax_n
    audio = _speech(n_chunks * 320, seed=batch)
    got = features(audio)
    ref = np.asarray(jax_features(jnp.asarray(audio)))
    assert got.shape == ref.shape == (batch, 80, 16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=MEL_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_step_matches_jax(gen_tree, jax_step, dtype):
    rng = np.random.default_rng(12)
    mel = rng.standard_normal((2, 80, 16)).astype(np.float32)
    faces = rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = np.asarray(jax_step(jdt)(mel, faces))
    step = make_lip_device_step(load_wav2lip(wav2lip_from_flax(gen_tree), tdt, CPU))
    got = step(torch.from_numpy(mel), torch.from_numpy(faces))
    assert got.dtype == torch.uint8 and got.shape == (2, 96, 96, 3)
    diff = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert 0 < ref.std()
    if dtype == "float32":
        assert diff.max() <= 1
    else:
        share = float((diff > 1).mean())
        print(f"bf16 device step: {share:.2e} of values more than 1 LSB apart "
              f"(largest {diff.max()})")
        assert share <= BF16_SHARE


def test_avatar_bundle_is_byte_equal_to_jax(tmp_path):
    port = synthesize_avatar(str(tmp_path / "port"), n_frames=4)
    ref = jax_avatar.synthesize_avatar(str(tmp_path / "jax"), n_frames=4)
    for sub in ("full_imgs", "face_imgs"):
        for i in range(4):
            with open(tmp_path / "port" / sub / f"{i}.png", "rb") as a, \
                    open(tmp_path / "jax" / sub / f"{i}.png", "rb") as b:
                assert a.read() == b.read()
    with open(tmp_path / "port" / "coords.pkl", "rb") as a, \
            open(tmp_path / "jax" / "coords.pkl", "rb") as b:
        assert a.read() == b.read()
    assert port.coords == ref.coords
    for a, b in zip(port.frame_cycle + port.face_cycle, ref.frame_cycle + ref.face_cycle):
        np.testing.assert_array_equal(a, b)
    os.remove(tmp_path / "port" / "face_imgs" / "3.png")
    with pytest.raises(ValueError, match="inconsistent"):
        load_lip_avatar(str(tmp_path / "port"))


def _run_session(engine, n_video: int, say: str | None = None, timeout=120.0):
    async def main():
        loop = asyncio.get_running_loop()
        video_track = SimpleNamespace(_queue=asyncio.Queue())
        audio_track = SimpleNamespace(_queue=asyncio.Queue())
        quit_event = threading.Event()
        t = threading.Thread(target=engine.render,
                             args=(quit_event, loop, audio_track, video_track), daemon=True)
        t.start()
        if say:
            engine.put_msg_txt(say)
        frames, chunks = [], []
        try:
            while len(frames) < n_video:
                frames.append(await asyncio.wait_for(video_track._queue.get(), timeout=timeout))
            while len(chunks) < 2 * n_video:
                chunks.append(await asyncio.wait_for(audio_track._queue.get(), timeout=timeout))
        finally:
            quit_event.set()
            t.join(timeout=10)
        assert not t.is_alive()
        return frames, chunks

    return asyncio.run(main())


def test_silence_path_emits_idle_frames(engine, avatar):
    frames, chunks = _run_session(engine, n_video=8)
    cycle = [f.tobytes() for f in avatar.frame_cycle]
    for vf in frames:
        assert vf.image.tobytes() in cycle, "silence frame must be an untouched idle frame"
    for ch in chunks:
        assert ch.samples.dtype == np.int16
        assert np.all(ch.samples == 0), "silence audio must be zeros"


def test_speech_path_mutates_face_region(engine, avatar):
    frames, chunks = _run_session(engine, n_video=24, say="hello from the gpu pipeline")
    assert any(np.any(c.samples != 0) for c in chunks), "speech audio must flow"
    cycle = [f.tobytes() for f in avatar.frame_cycle]
    changed = [vf for vf in frames if vf.image.tobytes() not in cycle]
    assert changed, "speech must produce generated (pasted) frames"
    # the paste stays inside the bbox: outside it, an idle frame
    y1, y2, x1, x2 = avatar.coords[0]
    outside = np.ones(avatar.frame_cycle[0].shape[:2], bool)
    outside[y1:y2, x1:x2] = False
    for vf in changed:
        assert any(np.array_equal(vf.image[outside], f[outside]) for f in avatar.frame_cycle)


def test_pause_talk_clears_queue(engine):
    engine.put_msg_txt("some long text " * 20)
    engine.pause_talk()
    assert engine.asr.queue.qsize() == 0


def test_stale_silence_flagging():
    """Entries consumed before speech arrival are stale (droppable); the
    speech entry itself and anything after it are not."""
    asr = BaseASR(Config())
    pre = []
    for _ in range(5):  # pipeline pre-fills with silence
        frame, ftype = asr.get_audio_frame()
        pre.append((frame, ftype, asr.consumed_seq))
    assert all(f[1] == 1 for f in pre)
    asr.put_audio_frame(np.ones(asr.chunk, np.float32))
    assert asr.is_stale_silence(pre)
    speech = []
    for _ in range(2):  # speech chunk + trailing fresh silence
        frame, ftype = asr.get_audio_frame()
        speech.append((frame, ftype, asr.consumed_seq))
    assert speech[0][1] == 0
    assert not asr.is_stale_silence(speech)
    assert not asr.is_stale_silence([speech[1]])  # fresh silence: play it


def test_put_feat_gives_up_once_the_session_quits():
    """A render loop whose inference thread has stopped drops its step's
    features once quit_event is set instead of blocking on the full queue."""
    asr = BaseASR(Config())
    for i in range(asr.feat_queue.maxsize):
        assert asr.put_feat(i)
    asr.quit_event = threading.Event()
    asr.quit_event.set()
    assert asr.put_feat("late") is False
    assert [asr.get_next_feat(timeout=1) for _ in range(asr.feat_queue.maxsize)] == [0, 1]


def test_first_speech_frame_skips_buffered_silence(avatar):
    """Audio-to-first-frame: pre-buffered idle frames queued ahead of the
    first utterance are dropped, so the first generated frame arrives within
    2·batch emitted frames instead of the full pipeline depth (~5·batch),
    and lip.first_frame records it."""
    from mere_fusion_tpu_torch.runtime.metrics import metrics

    cfg = _cfg(**{"avatar.batch_size": 8})
    engine = LipReal(cfg, avatar=avatar, device=CPU)
    cycle = [f.tobytes() for f in avatar.frame_cycle]
    first_before = metrics.latency("lip.first_frame").count

    async def main():
        loop = asyncio.get_running_loop()
        video_track = SimpleNamespace(_queue=asyncio.Queue())
        audio_track = SimpleNamespace(_queue=asyncio.Queue())
        quit_event = threading.Event()
        t = threading.Thread(target=engine.render,
                             args=(quit_event, loop, audio_track, video_track), daemon=True)
        t.start()
        try:
            for _ in range(3 * cfg.avatar.batch_size):
                await asyncio.wait_for(video_track._queue.get(), timeout=120)
            engine.put_msg_txt("hello hello hello hello")
            emitted_after_put = 0
            while True:
                vf = await asyncio.wait_for(video_track._queue.get(), timeout=120)
                if vf.image.tobytes() not in cycle:
                    return emitted_after_put
                emitted_after_put += 1
        finally:
            quit_event.set()
            t.join(timeout=10)

    silence_before_speech = asyncio.run(main())
    assert silence_before_speech <= 2 * cfg.avatar.batch_size, (
        f"{silence_before_speech} buffered silence frames preceded speech")
    assert metrics.latency("lip.first_frame").count == first_before + 1


def _reference_pth(tree, path: str) -> str:
    state = wav2lip_from_flax(tree)
    torch.save({"state_dict": {f"module.{k}": v for k, v in state.items()},
                "global_step": 0}, path)
    return path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_engine_wav2lip_serving_ckpt(gen_tree, jax_step, avatar, tmp_path, dtype):
    path = _reference_pth(gen_tree, str(tmp_path / "wav2lip.pth"))
    cfg = _cfg(**{"avatar.ckpt": path, "avatar.dtype": dtype})
    n_trees = len(_DEVICE_TREES)
    engine = make_engine(cfg, avatar=avatar, device=CPU)
    assert isinstance(engine, LipReal)
    assert len(_DEVICE_TREES) == n_trees + 1
    kernel = engine.model.face_encoder_blocks[1][0].conv_block[0].weight
    assert kernel.dtype == getattr(torch, dtype)
    assert engine.model.face_encoder_blocks[1][0].conv_block[1].weight.dtype == torch.float32

    # the engine computes with the LOADED weights: JAX's step on the tree
    rng = np.random.default_rng(13)
    mel = rng.standard_normal((2, 80, 16)).astype(np.float32)
    faces = np.stack(avatar.face_cycle[:2])
    out = engine._device_step(torch.from_numpy(mel), torch.from_numpy(faces)).numpy()
    ref = np.asarray(jax_step(getattr(jnp, dtype))(mel, faces))
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert (diff.max() <= 1) if dtype == "float32" else ((diff > 1).mean() <= BF16_SHARE)

    # a second session on the same device shares the tree's kernels
    engine2 = make_engine(cfg, avatar=avatar, device=CPU)
    assert len(_DEVICE_TREES) == n_trees + 1
    kernel2 = engine2.model.face_encoder_blocks[1][0].conv_block[0].weight
    assert kernel2.data_ptr() == kernel.data_ptr()
    out2 = engine2._device_step(torch.from_numpy(mel), torch.from_numpy(faces)).numpy()
    np.testing.assert_array_equal(out, out2)

    # from_checkpoint serves the same weights
    engine3 = LipReal.from_checkpoint(cfg, path, avatar=avatar, device=CPU)
    out3 = engine3._device_step(torch.from_numpy(mel), torch.from_numpy(faces)).numpy()
    np.testing.assert_array_equal(out, out3)


def test_cli_defaults_to_wav2lip():
    from mere_fusion_tpu.cli import build_parser as jax_parser
    from mere_fusion_tpu_torch.cli import build_parser, config_from_args

    args = build_parser().parse_args([])
    assert args.model == jax_parser().parse_args([]).model == "wav2lip"
    cfg = config_from_args(build_parser().parse_args(["--avatar_ckpt", "w.pth"]))
    assert cfg.avatar.kind == "wav2lip" and cfg.avatar.ckpt == "w.pth"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--model", "other"])
