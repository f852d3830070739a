"""Streaming TTS adapters.

Behavioral twin of the reference's ttsreal.py: a message-queue thread turns
text into 16 kHz float32 PCM and pushes 20 ms chunks to the parent engine via
``put_audio_frame`` (reference: ttsreal.py:22-57). Backends:

- EdgeTTS      (edge_tts streaming; requires edge_tts + an mp3 decoder)
- SovitsTTS    (GPT-SoVITS streaming HTTP, 32 kHz raw pcm — ttsreal.py:111-167)
- CosyVoiceTTS (zero-shot HTTP, 22.05 kHz — ttsreal.py:170-219)
- XTTS         (speaker-clone streaming HTTP, 24 kHz — ttsreal.py:222-281)
- ProceduralTTS (offline deterministic tone synth — test/demo backend with no
                 network or model deps; plays the silence-path role the
                 reference gets from its built-in silence short-circuit)

Resampling uses scipy polyphase filtering (resampy is not a dependency).
"""
from __future__ import annotations

import math
import queue
import time
from enum import Enum
from queue import Queue
from threading import Thread
from typing import Iterator

import numpy as np

from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.runtime.metrics import metrics


class State(Enum):
    RUNNING = 0
    PAUSE = 1


def resample_pcm(x: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    if sr_from == sr_to or x.size == 0:
        return x.astype(np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(sr_from, sr_to)
    return resample_poly(x.astype(np.float32), sr_to // g, sr_from // g).astype(
        np.float32
    )


class BaseTTS:
    def __init__(self, cfg: Config, parent):
        self.cfg = cfg
        self.parent = parent
        self.sample_rate = cfg.audio.sample_rate
        self.chunk = cfg.audio.chunk
        self.msgqueue: Queue[str] = Queue()
        self.state = State.RUNNING

    def put_msg_txt(self, msg: str) -> None:
        self.msgqueue.put(msg)

    def pause_talk(self) -> None:
        self.msgqueue.queue.clear()
        self.state = State.PAUSE

    def render(self, quit_event) -> None:
        Thread(target=self._process_loop, args=(quit_event,), daemon=True).start()

    def _process_loop(self, quit_event) -> None:
        while not quit_event.is_set():
            try:
                msg = self.msgqueue.get(block=True, timeout=1)
                self.state = State.RUNNING
            except queue.Empty:
                continue
            try:
                self.txt_to_audio(msg)
            except Exception as e:  # adapter errors must not kill the thread
                metrics.counter("tts.errors")
                print(f"[tts] {type(self).__name__} error: {e}")

    def txt_to_audio(self, msg: str) -> None:
        raise NotImplementedError

    def _push_stream(self, stream: np.ndarray) -> None:
        """Chop float32 16 kHz PCM into 20 ms chunks for the engine."""
        idx = 0
        while stream.shape[0] - idx >= self.chunk and self.state == State.RUNNING:
            self.parent.put_audio_frame(stream[idx : idx + self.chunk])
            idx += self.chunk


class ProceduralTTS(BaseTTS):
    """Deterministic offline synth: each character becomes a short tone.

    Used by tests and weightless demos; produces real speech-path traffic
    (type-0 audio frames) with zero external dependencies.
    """

    seconds_per_char = 0.05

    def txt_to_audio(self, msg: str) -> None:
        n = max(1, int(len(msg) * self.seconds_per_char * self.sample_rate))
        t = np.arange(n, dtype=np.float32) / self.sample_rate
        freq = 200.0 + (sum(map(ord, msg)) % 17) * 25.0
        stream = (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        self._push_stream(stream)


class _HTTPStreamTTS(BaseTTS):
    """Shared streaming-HTTP machinery: POST → iter_content → resample →
    20 ms chunks, with time-to-first-chunk metrics."""

    src_rate: int = 16000
    chunk_bytes: int = 16000

    def stream_tts(self, byte_iter: Iterator[bytes]) -> None:
        leftover = b""
        for chunk in byte_iter:
            if not chunk:
                continue
            buf = leftover + chunk
            usable = len(buf) - (len(buf) % 2)
            leftover = buf[usable:]
            pcm = np.frombuffer(buf[:usable], dtype=np.int16).astype(np.float32) / 32767
            stream = resample_pcm(pcm, self.src_rate, self.sample_rate)
            self._push_stream(stream)

    def _iter_http(self, method: str, url: str, **kw) -> Iterator[bytes]:
        import requests

        start = time.perf_counter()
        res = requests.request(method, url, stream=True, **kw)
        if res.status_code != 200:
            print(f"[tts] {url} error: {res.text[:200]}")
            return
        first = True
        for chunk in res.iter_content(chunk_size=self.chunk_bytes):
            if first:
                metrics.latency("tts.first_chunk").observe(time.perf_counter() - start)
                first = False
            if chunk and self.state == State.RUNNING:
                yield chunk


class SovitsTTS(_HTTPStreamTTS):
    """GPT-SoVITS streaming server, raw 32 kHz pcm16 (ttsreal.py:111-167)."""

    src_rate = 32000

    def txt_to_audio(self, msg: str) -> None:
        req = {
            "text": msg,
            "text_lang": "zh",
            "ref_audio_path": self.cfg.tts.ref_audio,
            "prompt_text": self.cfg.tts.ref_text,
            "prompt_lang": "zh",
            "media_type": "raw",
            "streaming_mode": True,
        }
        self.stream_tts(self._iter_http("POST", f"{self.cfg.tts.server_url}/tts", json=req))


class CosyVoiceTTS(_HTTPStreamTTS):
    """CosyVoice zero-shot with reference wav, 22.05 kHz (ttsreal.py:170-219)."""

    src_rate = 22050

    def txt_to_audio(self, msg: str) -> None:
        payload = {"tts_text": msg, "prompt_text": self.cfg.tts.ref_text}
        files = [
            ("prompt_wav", ("prompt_wav", open(self.cfg.tts.ref_audio, "rb"),
                            "application/octet-stream"))
        ]
        self.stream_tts(
            self._iter_http(
                "GET",
                f"{self.cfg.tts.server_url}/inference_zero_shot",
                data=payload,
                files=files,
            )
        )


class XTTS(_HTTPStreamTTS):
    """XTTS speaker-clone streaming, 24 kHz (ttsreal.py:222-281)."""

    src_rate = 24000
    chunk_bytes = 960

    def __init__(self, cfg: Config, parent):
        super().__init__(cfg, parent)
        self.speaker: dict | None = None

    def _get_speaker(self) -> dict:
        import requests

        with open(self.cfg.tts.ref_audio, "rb") as f:
            res = requests.post(
                f"{self.cfg.tts.server_url}/clone_speaker",
                files={"wav_file": ("reference.wav", f)},
            )
        return res.json()

    def txt_to_audio(self, msg: str) -> None:
        if self.speaker is None:
            self.speaker = self._get_speaker()
        body = dict(self.speaker)
        body.update({"text": msg, "language": "zh-cn", "stream_chunk_size": "20"})
        self.stream_tts(
            self._iter_http("POST", f"{self.cfg.tts.server_url}/tts_stream", json=body)
        )


class EdgeTTS(BaseTTS):
    """Microsoft Edge streaming TTS (ttsreal.py:61-108).

    Requires the optional ``edge_tts`` package plus an audio decoder
    (``soundfile``); raises a clear error otherwise.
    """

    def txt_to_audio(self, msg: str) -> None:
        import asyncio
        import io

        try:
            import edge_tts
            import soundfile as sf
        except ImportError as e:
            raise RuntimeError(
                "EdgeTTS backend needs the edge_tts and soundfile packages; "
                "use tts.backend='procedural' or an HTTP backend instead"
            ) from e

        buf = io.BytesIO()

        async def run():
            communicate = edge_tts.Communicate(msg, self.cfg.tts.voice)
            async for chunk in communicate.stream():
                if chunk["type"] == "audio" and self.state == State.RUNNING:
                    buf.write(chunk["data"])

        asyncio.new_event_loop().run_until_complete(run())
        if buf.getbuffer().nbytes <= 0:
            return
        buf.seek(0)
        stream, sr = sf.read(buf, dtype="float32")
        if stream.ndim > 1:
            stream = stream[:, 0]
        self._push_stream(resample_pcm(stream, sr, self.sample_rate))


_BACKENDS = {
    "edge": EdgeTTS,
    "edgetts": EdgeTTS,
    "gpt-sovits": SovitsTTS,
    "sovits": SovitsTTS,
    "cosyvoice": CosyVoiceTTS,
    "xtts": XTTS,
    "procedural": ProceduralTTS,
}


def make_tts(cfg: Config, parent) -> BaseTTS:
    try:
        cls = _BACKENDS[cfg.tts.backend]
    except KeyError:
        raise ValueError(
            f"unknown tts backend {cfg.tts.backend!r}; options: {sorted(_BACKENDS)}"
        ) from None
    return cls(cfg, parent)
