"""Audio front-end of the PyTorch port against the JAX package: the log-mel
(ops/mel.py), the whisper encoder's per-layer embeddings
(models/whisper.py) and the MuseTalk feature extractor
(audio/features.py), on the same seeded inputs and weights."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu.audio.features import WhisperFeatureExtractor as JaxExtractor
from mere_fusion_tpu.models.whisper import Whisper
from mere_fusion_tpu.models.whisper import WhisperDims as JaxDims
from mere_fusion_tpu.ops import mel as jax_mel
from mere_fusion_tpu_torch.audio.features import WhisperFeatureExtractor
from mere_fusion_tpu_torch.convert import whisper_encoder_from_flax
from mere_fusion_tpu_torch.models.whisper import AudioEncoder, WhisperDims
from mere_fusion_tpu_torch.ops import mel as torch_mel
from tests.test_musetalk import SMALL_WHISPER
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
DIMS = WhisperDims(**SMALL_WHISPER.__dict__)


def _max_rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / max(1e-6, float(np.abs(b).max())))


# whisper log-mel within 1e-5. The wav2lip dB mel spans [-4, 4] and its JAX
# twin's f32 DFT rounds near-empty bins where the port's f64 one does not;
# the dB scale passes that on, hence 1e-4 there.
@pytest.mark.parametrize("name,atol", [("WHISPER_MEL", 1e-5), ("WAV2LIP_MEL", 1e-4)])
def test_melspectrogram_matches_jax(name, atol):
    rng = np.random.default_rng(0)
    wav = (0.3 * rng.standard_normal(16000 * 2)).astype(np.float32)
    ref = np.asarray(jax_mel.melspectrogram(jnp.asarray(wav), getattr(jax_mel, name)))
    out = torch_mel.melspectrogram(torch.from_numpy(wav), getattr(torch_mel, name)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def whisper_vars():
    model = Whisper(SMALL_WHISPER)
    variables = model.init(jax.random.key(0),
                           jnp.zeros((1, DIMS.n_mels, 2 * DIMS.n_audio_ctx)),
                           jnp.zeros((1, 4), jnp.int32))
    # random norm scales and biases too, so no identity leaf hides a mapping bug
    rng = np.random.default_rng(7)
    return jax.tree.map(
        lambda x: np.asarray(x) + (rng.uniform(-0.2, 0.2, x.shape).astype(np.float32)
                                   if x.ndim == 1 else 0.0),
        variables)


def test_whisper_encoder_embeddings_match_jax(whisper_vars):
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32)
    out_ref, emb_ref = Whisper(SMALL_WHISPER).apply(
        whisper_vars, jnp.asarray(mel), True, method=Whisper.encode)
    enc = AudioEncoder(DIMS)
    enc.load_state_dict(whisper_encoder_from_flax(whisper_vars, DIMS), strict=True)
    with torch.no_grad():
        out, emb = enc(torch.from_numpy(mel), include_embeddings=True)
    assert emb.shape == (2, DIMS.n_audio_layer + 1, DIMS.n_audio_ctx, DIMS.n_audio_state)
    assert _max_rel(emb.numpy(), np.asarray(emb_ref)) < 2e-5
    assert _max_rel(out.numpy(), np.asarray(out_ref)) < 2e-5


def test_feature_extractor_matches_jax(whisper_vars):
    jx = JaxExtractor(whisper_vars, SMALL_WHISPER)
    pt = WhisperFeatureExtractor(whisper_encoder_from_flax(whisper_vars, DIMS), DIMS,
                                 device=CPU)
    rng = np.random.default_rng(3)
    audio = (0.2 * rng.standard_normal(6400)).astype(np.float32)
    ref = jx.audio2feat(audio)
    out = pt.audio2feat(audio)
    assert out.shape == ref.shape
    assert _max_rel(out, ref) < 2e-5
    emb_ref, n_ref = jx.audio2feat_device(audio)
    emb, n = pt.audio2feat_device(audio)
    assert n == n_ref
    chunks_ref = np.asarray(jx.chunks_device(emb_ref, n_ref, fps=12.5, batch_size=3,
                                             start=2.0))
    chunks = pt.chunks_device(emb, n, fps=12.5, batch_size=3, start=2.0)
    assert chunks.shape == chunks_ref.shape
    assert _max_rel(chunks.numpy(), chunks_ref) < 2e-5
    host = np.stack(pt.feature2chunks(out, fps=12.5, batch_size=3, start=2.0))
    np.testing.assert_array_equal(host, chunks.numpy())


def test_whisper_dims_match_jax_fields():
    assert set(WhisperDims.__dataclass_fields__) == set(JaxDims.__dataclass_fields__)
