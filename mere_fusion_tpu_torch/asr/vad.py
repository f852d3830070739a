"""Energy-gate voice activity detection.

A copy of mere_fusion_tpu/asr/vad.py.

The reference applies VAD per backend when ``--vad`` is given
(reference: whisper_online.py:628-629, 663-665 — silero for the local
backends, no_speech_prob segment filtering for the OpenAI API). silero isn't
available in this environment, so the local backends gate on frame log-energy
with an adaptive noise floor — deterministic, dependency-free, and good
enough to (a) skip whole-buffer decodes on silence and (b) drop words that
fall entirely inside non-speech spans.
"""
from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
FRAME = 320  # 20 ms


def frame_energies_db(audio: np.ndarray, frame: int = FRAME) -> np.ndarray:
    """Per-20ms-frame RMS energy in dBFS. [T] float32."""
    n = len(audio) // frame
    if n == 0:
        return np.zeros((0,), np.float32)
    frames = audio[: n * frame].reshape(n, frame)
    rms = np.sqrt((frames.astype(np.float64) ** 2).mean(axis=1))
    return (20.0 * np.log10(rms + 1e-10)).astype(np.float32)


def speech_segments(
    audio: np.ndarray,
    sample_rate: int = SAMPLE_RATE,
    abs_floor_db: float = -45.0,
    rel_margin_db: float = 6.0,
    always_speech_db: float = -35.0,
    hang_frames: int = 5,
    min_frames: int = 3,
) -> list[tuple[float, float]]:
    """Speech spans [(beg_s, end_s), ...] from an energy gate.

    A frame is speech when its energy exceeds both an absolute floor and the
    adaptive noise floor (10th percentile) plus a margin. The adaptive
    threshold is capped at ``always_speech_db``: when a buffer is
    wall-to-wall speech the 10th percentile IS speech energy, and an uncapped
    floor+margin would classify the whole buffer as silence and drop the
    transcript — frames this loud are speech no matter what the quietest
    frames look like. Speech runs are dilated by ``hang_frames`` on each side
    (onset/offset hangover) and runs shorter than ``min_frames`` are dropped
    as clicks.
    """
    e = frame_energies_db(audio)
    if len(e) == 0:
        return []
    floor = float(np.percentile(e, 10))
    thresh = max(abs_floor_db, min(floor + rel_margin_db, always_speech_db))
    mask = e > thresh

    segs: list[tuple[float, float]] = []
    frame_s = FRAME / sample_rate
    start = None
    for i, m in enumerate(mask):
        if m and start is None:
            start = i
        elif not m and start is not None:
            if i - start >= min_frames:
                segs.append((start, i))
            start = None
    if start is not None and len(mask) - start >= min_frames:
        segs.append((start, len(mask)))

    # hangover dilation + merge of overlapping spans
    out: list[tuple[float, float]] = []
    for b, t in segs:
        b = max(0, b - hang_frames)
        t = min(len(mask), t + hang_frames)
        if out and b <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((b, t))
    return [(b * frame_s, t * frame_s) for b, t in out]


def has_speech(audio: np.ndarray, **kw) -> bool:
    return bool(speech_segments(audio, **kw))


def filter_words(words, segs) -> list:
    """Drop words with zero overlap with every speech segment (the
    reference's no_speech segment filter, whisper_online.py:205-214)."""
    if segs is None:
        return list(words)
    return [
        w for w in words
        if any(w.beg < t and w.end > b for b, t in segs)
    ]
