"""The caller's incoming WebRTC tracks: readers that feed a session's
upstream.

Port of mere_fusion_tpu/server/upstream.py's ``attach_upstream_track``
(reference: app.py:233-273). The processors it feeds, ``SpeechUpstream``
(streaming ASR) and ``VideoUpstream`` (perception), are not ported yet
(ROADMAP: 'Streaming ASR', 'Perception'), so a session without an LLM has no
upstream and gets no reader: the JAX package starts one that dies at its
first frame on ``None.process_pcm`` (ROADMAP §3).
"""
from __future__ import annotations

import asyncio

import numpy as np


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
