"""Offline / computationally-unaware / online ASR simulation harness.

Port of mere_fusion_tpu/asr/simulate.py: plain Python, copied.

Reproduces the reference's three CLI validation modes
(whisper_online.py:697-823): feed a WAV to the streaming transcriber in
min-chunk increments and log per-emission latency. Used both as a CLI and as
the ASR regression harness in tests.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Emission:
    emitted_at: float       # stream-time seconds when emitted
    beg: float
    end: float
    text: str

    @property
    def latency(self) -> float:
        return self.emitted_at - self.end


@dataclass
class SimulationResult:
    emissions: list[Emission] = field(default_factory=list)

    @property
    def transcript(self) -> str:
        return "".join(e.text for e in self.emissions)

    @property
    def mean_latency(self) -> float:
        lats = [e.latency for e in self.emissions if e.beg is not None]
        return float(np.mean(lats)) if lats else 0.0


def simulate_streaming(
    transcriber,
    audio: np.ndarray,
    min_chunk: float = 1.0,
    sample_rate: int = 16000,
    computationally_aware: bool = False,
    backend_offset_hook=None,
) -> SimulationResult:
    """Feed ``audio`` in min_chunk steps; collect committed emissions.

    computationally_aware=True advances stream time by real wall-clock spent
    in process_iter (the reference's 'online' mode); otherwise chunks arrive
    back-to-back ('computationally unaware').
    """
    result = SimulationResult()
    n = len(audio)
    step = int(min_chunk * sample_rate)
    now = 0.0
    for start in range(0, n, step):
        chunk = audio[start : start + step]
        now = (start + len(chunk)) / sample_rate
        transcriber.insert_audio_chunk(chunk)
        if backend_offset_hook is not None:
            backend_offset_hook(transcriber.buffer_time_offset)
        t0 = time.perf_counter()
        beg, end, text = transcriber.process_iter()
        if computationally_aware:
            now += time.perf_counter() - t0
        if text:
            result.emissions.append(Emission(now, beg, end, text))
    beg, end, text = transcriber.finish()
    if text:
        result.emissions.append(Emission(now, beg if beg is not None else now, end or now, text))
    return result
