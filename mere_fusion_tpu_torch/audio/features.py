"""Whisper-encoder audio features for MuseTalk.

Port of mere_fusion_tpu/audio/features.py: the whisper encoder's per-layer
embeddings at 50 Hz are sliced into [2,2]-context windows of shape
(50, 384) per video frame. The device-resident form (``audio2feat_device``
+ ``chunks_device``) keeps the embeddings on the card: per step only the
raw PCM is uploaded and nothing is read back.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mere_fusion_tpu_torch.device import resolve_device
from mere_fusion_tpu_torch.models.whisper import TINY, AudioEncoder, WhisperDims
from mere_fusion_tpu_torch.ops.mel import melspectrogram, whisper_mel_config

SAMPLE_RATE = 16000
FEATURE_HZ = 50          # whisper encoder frames per second


class WhisperFeatureExtractor:
    def __init__(self, state_dict=None, dims: WhisperDims | None = None,
                 device=None, seed: int = 0):
        """state_dict: the whisper encoder's weights under OpenAI's names
        without the ``encoder.`` prefix; None means random weights from
        ``seed``."""
        from mere_fusion_tpu_torch.device import random_init_

        self.device = resolve_device(device)
        self.dims = dims or TINY
        encoder = AudioEncoder(self.dims)
        if state_dict is None:
            random_init_(encoder, seed)
        else:
            encoder.load_state_dict(state_dict, strict=True)
        self.encoder = encoder.to(self.device).eval()
        self.mel_cfg = whisper_mel_config(self.dims.n_mels)
        # encoder context window in samples: n_audio_ctx 50 Hz frames
        self.window_samples = self.dims.n_audio_ctx * 2 * 160

    @torch.no_grad()
    def _embed_window(self, audio: torch.Tensor) -> torch.Tensor:
        """PCM (≤ one window) on the device → embeddings [T', L+1, D]."""
        padded = torch.zeros(self.window_samples, dtype=torch.float32,
                             device=self.device)
        n = min(audio.shape[0], self.window_samples)
        padded[:n] = audio[:n]
        mel = melspectrogram(padded, self.mel_cfg)[None]
        _, emb = self.encoder(mel, include_embeddings=True)
        return emb[0].transpose(0, 1)

    def audio2feat(self, audio: np.ndarray) -> np.ndarray:
        """float32 PCM @16 kHz → per-layer embeddings [T50, L+1, D] on the
        host, trimmed to the audio's duration at 50 Hz."""
        emb = self._embed_window(torch.as_tensor(
            np.asarray(audio, np.float32), device=self.device))
        n_frames = int(math.ceil(len(audio) / SAMPLE_RATE * FEATURE_HZ))
        return emb[:n_frames].cpu().numpy()

    @staticmethod
    def get_sliced_feature(
        feature_array: np.ndarray,
        vid_idx: int,
        audio_feat_length=(2, 2),
        fps: float = 25,
    ) -> np.ndarray:
        """Window of 2*(l+r+1) 50 Hz embedding frames around the video frame,
        flattened to (-1, D) — (50, 384) for the default [2,2] context."""
        length = len(feature_array)
        center = int(vid_idx * FEATURE_HZ / fps)
        left = center - audio_feat_length[0] * 2
        right = center + (audio_feat_length[1] + 1) * 2
        idx = np.clip(np.arange(left, right), 0, length - 1)
        return feature_array[idx].reshape(-1, feature_array.shape[-1])

    def feature2chunks(
        self,
        feature_array: np.ndarray,
        fps: float,
        batch_size: int,
        audio_feat_length=(2, 2),
        start: float = 0.0,
    ) -> list[np.ndarray]:
        return [
            self.get_sliced_feature(feature_array, i + start, audio_feat_length, fps)
            for i in range(batch_size)
        ]

    # ---- device-resident live path -----------------------------------------
    def audio2feat_device(self, audio: np.ndarray) -> tuple[torch.Tensor, int]:
        """Live twin of audio2feat: uploads the raw PCM and returns
        (embeddings [T', L+1, D] on the device, n_frames)."""
        n = min(len(audio), self.window_samples)
        pcm = torch.from_numpy(np.ascontiguousarray(audio[:n], np.float32))
        emb = self._embed_window(pcm.to(self.device, non_blocking=True))
        return emb, int(math.ceil(n / SAMPLE_RATE * FEATURE_HZ))

    def chunks_device(self, emb_dev: torch.Tensor, n_frames: int, fps: float,
                      batch_size: int, audio_feat_length=(2, 2),
                      start: float = 0.0) -> torch.Tensor:
        """Device twin of feature2chunks: one gather → [B, W, D] with
        W = 2·(l+r+1)·(L+1), the same windows as get_sliced_feature."""
        l, r = audio_feat_length
        idx = np.stack([
            np.clip(np.arange(int((i + start) * FEATURE_HZ / fps) - l * 2,
                              int((i + start) * FEATURE_HZ / fps) + (r + 1) * 2),
                    0, max(n_frames - 1, 0))
            for i in range(batch_size)
        ])                                             # [B, 2(l+r+1)]
        ix = torch.from_numpy(idx).to(emb_dev.device, non_blocking=True)
        return emb_dev[ix].reshape(batch_size, -1, emb_dev.shape[-1])
