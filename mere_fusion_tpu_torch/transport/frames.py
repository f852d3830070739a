"""Lightweight media frame types.

Engines emit these instead of PyAV frames (the reference builds
av.VideoFrame/av.AudioFrame directly in its hot assembly loop,
lipreal.py:215-227); the transport layer converts to codec frames only when a
real WebRTC peer is attached. This keeps the assembly path numpy-only and
makes the whole pipeline testable without av/aiortc.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class VideoImage:
    """BGR24 uint8 image of shape [H, W, 3]."""

    image: np.ndarray
    pts: int | None = None

    @property
    def width(self) -> int:
        return self.image.shape[1]

    @property
    def height(self) -> int:
        return self.image.shape[0]


@dataclass
class AudioChunk:
    """Mono int16 PCM, usually 320 samples (20 ms @ 16 kHz)."""

    samples: np.ndarray
    sample_rate: int = 16000
    pts: int | None = None

    @classmethod
    def from_float(cls, pcm: np.ndarray, sample_rate: int = 16000) -> "AudioChunk":
        from mere_fusion_tpu_torch import native

        return cls(samples=native.f32_to_pcm16(pcm), sample_rate=sample_rate)


def to_av_video(frame: VideoImage):
    """Convert to av.VideoFrame (requires PyAV; only on the WebRTC path)."""
    from av import VideoFrame

    return VideoFrame.from_ndarray(frame.image, format="bgr24")


def to_av_audio(chunk: AudioChunk):
    from av import AudioFrame

    f = AudioFrame(format="s16", layout="mono", samples=chunk.samples.shape[0])
    f.planes[0].update(chunk.samples.tobytes())
    f.sample_rate = chunk.sample_rate
    return f
