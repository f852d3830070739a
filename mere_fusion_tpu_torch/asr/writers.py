"""Transcript output writers: txt / vtt / srt.

Port of mere_fusion_tpu/asr/writers.py: plain Python, copied.

Same formats and formatting rules as the reference's vendored whisper
utilities (reference: musetalk/whisper/whisper/utils.py:30-88):
timestamps as [hh:]mm:ss.mmm (vtt, '.' marker, hours only when nonzero) or
hh:mm:ss,mmm (srt, ',' marker, hours always), '-->' inside cue text replaced
with '->', srt cues numbered from 1. Segments are {start, end, text} dicts —
produced by the streaming simulation's emissions or the chunked batch mode.
"""
from __future__ import annotations

import zlib
from typing import IO, Iterable, Mapping


def compression_ratio(text: str) -> float:
    """len(text) / len(zlib(text)) — the repetition heuristic the reference
    thresholds at 2.4 (musetalk/whisper/whisper/utils.py:25-26)."""
    return len(text) / len(zlib.compress(text.encode("utf-8")))


def format_timestamp(seconds: float, always_include_hours: bool = False,
                     decimal_marker: str = ".") -> str:
    assert seconds >= 0, "non-negative timestamp expected"
    ms = round(seconds * 1000.0)
    hours, ms = divmod(ms, 3_600_000)
    minutes, ms = divmod(ms, 60_000)
    secs, ms = divmod(ms, 1_000)
    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


def write_txt(segments: Iterable[Mapping], file: IO[str]) -> None:
    for seg in segments:
        print(seg["text"].strip(), file=file, flush=True)


def write_vtt(segments: Iterable[Mapping], file: IO[str]) -> None:
    print("WEBVTT\n", file=file)
    for seg in segments:
        print(
            f"{format_timestamp(seg['start'])} --> "
            f"{format_timestamp(seg['end'])}\n"
            f"{seg['text'].strip().replace('-->', '->')}\n",
            file=file, flush=True,
        )


def write_srt(segments: Iterable[Mapping], file: IO[str]) -> None:
    for i, seg in enumerate(segments, start=1):
        print(
            f"{i}\n"
            f"{format_timestamp(seg['start'], True, ',')} --> "
            f"{format_timestamp(seg['end'], True, ',')}\n"
            f"{seg['text'].strip().replace('-->', '->')}\n",
            file=file, flush=True,
        )


WRITERS = {"txt": write_txt, "vtt": write_vtt, "srt": write_srt}


def emissions_to_segments(emissions) -> list[dict]:
    """Streaming-simulation emissions → writer segments (skip empty/
    timestampless commits)."""
    return [
        {"start": e.beg, "end": e.end, "text": e.text}
        for e in emissions
        if e.text and e.beg is not None and e.end is not None
    ]


def chunks_to_segments(chunks) -> list[dict]:
    """transcribe_long() chunks → writer segments."""
    return [{"start": c["start"], "end": c["end"], "text": c["text"]}
            for c in chunks]
