"""Upstream media handlers: the caller's mic and camera → ASR and
perception → the brain.

Port of mere_fusion_tpu/server/upstream.py (reference: app.py:204-273,
whisper_online_server.py:56-116, yolo_opencv.py:136-149):

- ``SpeechUpstream``: 16 kHz PCM accumulated to a minimum chunk, one
  ``StreamingTranscriber.process_iter`` a chunk (its host ms on the
  ``asr.process_iter`` meter), committed text to ``brain.text_produce``;
- ``VideoUpstream``: camera frames → perception summaries →
  ``brain.video_produce``;
- ``attach_upstream_track``: a reader task for an incoming aiortc track. A
  session without an LLM has no upstream and gets no reader, where the JAX
  package starts one that dies at its first frame on ``None.process_pcm``
  (ROADMAP §3).
"""
from __future__ import annotations

import asyncio
import logging
import time

import numpy as np

from mere_fusion_tpu_torch.runtime.metrics import metrics

logger = logging.getLogger(__name__)


class SpeechUpstream:
    """20 ms PCM frames → StreamingTranscriber → brain.text_produce."""

    def __init__(self, transcriber, brain, min_chunk_seconds: float = 1.0,
                 sample_rate: int = 16000):
        self.transcriber = transcriber
        self.brain = brain
        self.min_chunk = min_chunk_seconds
        self.sample_rate = sample_rate
        self._pending: list[np.ndarray] = []
        self._pending_samples = 0

    def process_pcm(self, pcm: np.ndarray) -> None:
        """Feed float32 PCM at 16 kHz; runs an ASR iteration per min-chunk."""
        self._pending.append(pcm.astype(np.float32))
        self._pending_samples += len(pcm)
        if self._pending_samples < self.min_chunk * self.sample_rate:
            return
        audio = np.concatenate(self._pending)
        self._pending, self._pending_samples = [], 0
        self.transcriber.insert_audio_chunk(audio)
        t0 = time.perf_counter()
        beg, end, text = self.transcriber.process_iter()
        metrics.latency("asr.process_iter").observe(time.perf_counter() - t0)
        if text:
            logger.info("asr committed %.2f-%.2f: %s", beg or 0, end or 0, text)
            if self.brain is not None:
                self.brain.text_produce(text)

    def process_pcm16(self, data: bytes) -> None:
        pcm = np.frombuffer(data, np.int16).astype(np.float32) / 32768.0
        self.process_pcm(pcm)

    def finish(self) -> None:
        _, _, text = self.transcriber.finish()
        if text and self.brain is not None:
            self.brain.text_produce(text)


class VideoUpstream:
    """Camera frames → perception summaries → brain.video_produce."""

    def __init__(self, perception, brain):
        self.perception = perception
        self.brain = brain

    def process_frame(self, frame_bgr: np.ndarray) -> None:
        summary = self.perception.process_frame(frame_bgr)
        if summary and self.brain is not None:
            self.brain.video_produce(summary)


def attach_upstream_track(session, track) -> asyncio.Task | None:
    """Start a reader task for an incoming aiortc track, or return None when
    the session has no upstream for the track's kind."""
    session.ensure_upstream()
    up = session.speech_upstream if track.kind == "audio" else session.video_upstream
    if up is None:
        return None

    async def read_audio():
        from mere_fusion_tpu_torch.tts import resample_pcm

        loop = asyncio.get_running_loop()
        while True:
            frame = await track.recv()
            pcm = frame.to_ndarray().flatten().astype(np.float32) / 32768.0
            if frame.sample_rate != 16000:
                pcm = resample_pcm(pcm, frame.sample_rate, 16000)
            # transcription takes 100s of ms a chunk: off the loop, so that
            # it cannot stall every session's pacing; awaited, so that the
            # session's transcriber state stays sequential
            await loop.run_in_executor(None, up.process_pcm, pcm)

    async def read_video():
        loop = asyncio.get_running_loop()
        while True:
            frame = await track.recv()
            await loop.run_in_executor(None, up.process_frame,
                                       frame.to_ndarray(format="bgr24"))

    return asyncio.ensure_future(read_audio() if track.kind == "audio" else read_video())
