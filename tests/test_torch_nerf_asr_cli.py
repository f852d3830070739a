"""The PyTorch port's standalone featurizer (mere_fusion_tpu_torch/tools/
nerf_asr.py) against the JAX package's tools/nerf_asr.py, on the CPU:
``stream_features`` equal to JAX's with the fake featurizer, and within
2e-2 of the largest value with a DeepSpeech graph at hidden width 64 (both
run bf16 products); PCM16 stdin chunks equal; ``--save_feats`` writing
JAX's array; ``--play`` gated on pyaudio."""
from __future__ import annotations

import io

import numpy as np
import pytest
from scipy.io import wavfile

from chip_smoke import speech_pcm
from mere_fusion_tpu.config import Config as JConfig
from mere_fusion_tpu.engines import make_nerf_featurizer as j_featurizer
from mere_fusion_tpu.engines.nerf import fake_logits_fn as j_fake
from mere_fusion_tpu.tools import nerf_asr as j_tool
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.engines import make_nerf_featurizer
from mere_fusion_tpu_torch.engines.nerf import fake_logits_fn
from mere_fusion_tpu_torch.tools import nerf_asr
from tests.test_torch_deepspeech import assert_close
from tests.test_torch_nerf_featurizer import toy_pb  # noqa: F401  (fixture)


@pytest.fixture()
def wav(tmp_path):
    path = tmp_path / "speech.wav"
    wavfile.write(path, 16000, (speech_pcm(32000) * 32767).astype(np.int16))
    return str(path)


def test_stream_features_match_jax_with_the_fake(wav):
    got = nerf_asr.stream_features(nerf_asr.wav_chunks(wav), Config(), fake_logits_fn(44))
    want = j_tool.stream_features(j_tool.wav_chunks(wav), JConfig(), j_fake(44))
    assert got.shape == want.shape and got.shape[1:] == (16, 44)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).sum() > 0


def test_stream_features_match_jax_with_a_graph(wav, toy_pb):
    cfg = {"nerf.audio_in_dim": 29}
    logits_fn, _ = make_nerf_featurizer(toy_pb, "cpu", audio_in_dim=29)
    got = nerf_asr.stream_features(nerf_asr.wav_chunks(wav), Config().override(**cfg), logits_fn)
    want = j_tool.stream_features(j_tool.wav_chunks(wav), JConfig().override(**cfg),
                                  j_featurizer(toy_pb)[0])
    assert got.shape == want.shape and got.shape[1:] == (16, 29)
    assert_close(got, want, 2e-2)


def test_pcm16_stdin_chunks_match_jax():
    raw = (speech_pcm(16000) * 32767).astype("<i2").tobytes() + b"\x01\x00"
    got = list(nerf_asr.pcm16_chunks(io.BytesIO(raw)))
    want = list(j_tool.pcm16_chunks(io.BytesIO(raw)))
    assert len(got) == len(want) == 51 and all(c.shape == (320,) for c in got)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    feats = nerf_asr.stream_features(iter(got), Config(), fake_logits_fn(44))
    np.testing.assert_array_equal(
        feats, j_tool.stream_features(iter(want), JConfig(), j_fake(44)))


def test_main_saves_features_as_jax(wav, tmp_path, toy_pb):
    got, want = tmp_path / "port.npy", tmp_path / "jax.npy"
    info = nerf_asr.main([wav, "--save_feats", str(got)])
    j_tool.main([wav, "--save_feats", str(want)])
    feats = np.load(got)
    assert feats.dtype == np.float32 and info["frames"] == feats.shape[0] > 0
    np.testing.assert_array_equal(feats, np.load(want))
    # a graph on the CPU; its width must be --audio_dim
    info = nerf_asr.main([wav, "--asr_model", toy_pb, "--audio_dim", "29", "--device", "cpu",
                          "--save_feats", str(got)])
    assert np.load(got).shape == (info["frames"], 16, 29)
    with pytest.raises(ValueError, match="audio_in_dim"):
        nerf_asr.main([wav, "--asr_model", toy_pb, "--device", "cpu"])


def test_play_is_gated_on_pyaudio(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "pyaudio", None)
    with pytest.raises(SystemExit, match="pyaudio"):
        nerf_asr.main([str(tmp_path / "x.wav"), "--play"])
