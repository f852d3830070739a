"""Paced media output tracks and the render-thread player.

Same pacing contract as the reference (video 25 fps on a 90 kHz clock, audio
20 ms on a 16 kHz clock, wall-clock sleeps in next_timestamp —
reference: webrtc.py:10-15, 44-71) with the aiortc dependency made optional:
when aiortc/av are installed ``PlayerStreamTrack`` is a real MediaStreamTrack
and converts engine frames to codec frames; otherwise the same class works as
a plain asyncio track for loopback transports and tests.
"""
from __future__ import annotations

import asyncio
import fractions
import threading
import time
from typing import Optional, Set

from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.transport.frames import AudioChunk, VideoImage

AUDIO_PTIME = 0.020
VIDEO_CLOCK_RATE = 90000
VIDEO_PTIME = 1 / 25
VIDEO_TIME_BASE = fractions.Fraction(1, VIDEO_CLOCK_RATE)
SAMPLE_RATE = 16000
AUDIO_TIME_BASE = fractions.Fraction(1, SAMPLE_RATE)

try:  # aiortc is optional — only needed for real WebRTC peers
    from aiortc import MediaStreamTrack as _TrackBase

    _HAVE_AIORTC = True
except ImportError:
    _HAVE_AIORTC = False

    class _TrackBase:  # minimal stand-in with the readyState/stop contract
        kind = "video"

        def __init__(self):
            self._ended = False

        @property
        def readyState(self) -> str:
            return "ended" if self._ended else "live"

        def stop(self) -> None:
            self._ended = True


class MediaClock:
    """Pure pacing arithmetic: pts sequence + wall-clock wait per frame."""

    def __init__(self, ptime: float, clock_rate: int):
        self.ptime = ptime
        self.clock_rate = clock_rate
        self.start: float | None = None
        self.timestamp: int = 0

    def next(self, now: float) -> tuple[int, float]:
        """Return (pts, seconds_to_wait) for the next frame at time ``now``."""
        if self.start is None:
            self.start = now
            self.timestamp = 0
            return 0, 0.0
        self.timestamp += int(self.ptime * self.clock_rate)
        wait = self.start + self.timestamp / self.clock_rate - now
        return self.timestamp, max(0.0, wait)


class PlayerStreamTrack(_TrackBase):
    """Output track fed by the engine's assembly thread via ``_queue``."""

    def __init__(self, player, kind: str, convert_av: bool | None = None):
        super().__init__()
        self.kind = kind
        self._player = player
        self._queue: asyncio.Queue = asyncio.Queue()
        if kind == "video":
            self._clock = MediaClock(VIDEO_PTIME, VIDEO_CLOCK_RATE)
            self._time_base = VIDEO_TIME_BASE
        else:
            self._clock = MediaClock(AUDIO_PTIME, SAMPLE_RATE)
            self._time_base = AUDIO_TIME_BASE
        self._convert_av = _HAVE_AIORTC if convert_av is None else convert_av

    async def next_timestamp(self) -> tuple[int, fractions.Fraction]:
        if self.readyState != "live":
            raise RuntimeError(f"{self.kind} track is not live")
        pts, wait = self._clock.next(time.time())
        if wait > 0:
            await asyncio.sleep(wait)
        return pts, self._time_base

    async def recv(self):
        if self._player is not None:
            self._player._start(self)
        frame = await self._queue.get()
        if frame is None:
            self.stop()
            raise ConnectionError(f"{self.kind} track ended")
        pts, time_base = await self.next_timestamp()
        if self._convert_av and isinstance(frame, (VideoImage, AudioChunk)):
            from mere_fusion_tpu_torch.transport.frames import to_av_audio, to_av_video

            frame = (
                to_av_video(frame) if isinstance(frame, VideoImage) else to_av_audio(frame)
            )
        frame.pts = pts
        try:
            frame.time_base = time_base
        except AttributeError:
            pass  # lightweight frames carry pts only
        metrics.rate(f"track.{self.kind}_fps").tick()
        return frame

    def stop(self) -> None:
        super().stop()
        if self._player is not None:
            self._player._stop(self)
            self._player = None


def player_worker_thread(quit_event, loop, container, audio_track, video_track):
    container.render(quit_event, loop, audio_track, video_track)


class HumanPlayer:
    """Owns the audio+video tracks and lazily spawns the single render
    worker thread on first ``recv`` (reference: webrtc.py:109-157)."""

    def __init__(self, model):
        self.__thread: Optional[threading.Thread] = None
        self.__thread_quit: Optional[threading.Event] = None
        self.__started: Set[PlayerStreamTrack] = set()
        self.__audio = PlayerStreamTrack(self, kind="audio")
        self.__video = PlayerStreamTrack(self, kind="video")
        self.__container = model

    @property
    def audio(self) -> PlayerStreamTrack:
        return self.__audio

    @property
    def video(self) -> PlayerStreamTrack:
        return self.__video

    def _start(self, track: PlayerStreamTrack) -> None:
        self.__started.add(track)
        if self.__thread is None:
            self.__thread_quit = threading.Event()
            self.__thread = threading.Thread(
                name="media-player",
                target=player_worker_thread,
                args=(
                    self.__thread_quit,
                    asyncio.get_event_loop(),
                    self.__container,
                    self.__audio,
                    self.__video,
                ),
                daemon=True,
            )
            self.__thread.start()

    def _stop(self, track: PlayerStreamTrack) -> None:
        self.__started.discard(track)
        if not self.__started and self.__thread is not None:
            self.__thread_quit.set()
            self.__thread.join(timeout=5)
            self.__thread = None
        if not self.__started:
            self.__container = None

    def stop(self) -> None:
        if self.__thread is not None and self.__thread_quit is not None:
            self.__thread_quit.set()
            self.__thread.join(timeout=5)
            self.__thread = None
