"""RTMP push: through an ffmpeg process, or the native publisher without it.

Port of mere_fusion_tpu/transport/rtmp.py. The reference exposes
`--transport rtmp` and calls ``stream_frame`` / ``stream_frame_audio`` on a
streamer it never ships (reference: nerfreal.py:89-124, app.py:699-701).
``RtmpStreamer`` keeps that two-call API:

- with ffmpeg on the PATH (or ``ffmpeg_path``), raw BGR frames go to its
  stdin and PCM16 through a named FIFO (ffmpeg needs two inputs and only
  one can be stdin); ffmpeg muxes H.264 and AAC into FLV and pushes it;
- without it, ``transport.rtmp_native.RtmpPublisher`` publishes Screen
  Video v1 and PCM16 from ``transport.flv``: more bitrate than H.264, and
  no dependency.
"""
from __future__ import annotations

import logging
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

logger = logging.getLogger(__name__)


class RtmpStreamer:
    """Push raw video frames and PCM audio to an RTMP endpoint.

    stream_frame(image)        — BGR uint8 [H, W, 3], paced by the caller
    stream_frame_audio(chunk)  — float32 PCM at ``sample_rate``, mono
    close()                    — flush and end the pipeline
    ``route`` is "ffmpeg" or "native".
    """

    def __init__(self, url: str, width: int, height: int, fps: int = 25,
                 sample_rate: int = 16000, bitrate: str = "2000k",
                 ffmpeg_path: str | None = None, force_native: bool = False):
        self.width, self.height = width, height
        self._lock = threading.Lock()
        ffmpeg = None if force_native else (ffmpeg_path or shutil.which("ffmpeg"))
        if ffmpeg is None:
            from mere_fusion_tpu_torch.transport.flv import FlvPacketizer
            from mere_fusion_tpu_torch.transport.rtmp_native import RtmpPublisher

            self.route = "native"
            self._proc = None
            self._pub = RtmpPublisher(url)
            self._pkt = FlvPacketizer(width, height, fps, sample_rate, gop=2 * fps)
            self._pub.send_metadata(self._pkt.metadata())
            return
        self.route = "ffmpeg"
        self._pub = None
        self._tmp = tempfile.mkdtemp(prefix="mf_rtmp_")
        self._fifo = os.path.join(self._tmp, "audio.pcm")
        os.mkfifo(self._fifo)
        self._proc = subprocess.Popen(
            [ffmpeg, "-loglevel", "error", "-re",
             # video: raw BGR frames on stdin
             "-f", "rawvideo", "-pix_fmt", "bgr24",
             "-s", f"{width}x{height}", "-r", str(fps), "-i", "pipe:0",
             # audio: raw PCM16 mono through the FIFO
             "-f", "s16le", "-ar", str(sample_rate), "-ac", "1", "-i", self._fifo,
             "-c:v", "libx264", "-preset", "ultrafast", "-tune", "zerolatency",
             "-b:v", bitrate, "-pix_fmt", "yuv420p", "-g", str(2 * fps),
             "-c:a", "aac", "-ar", str(sample_rate), "-f", "flv", url],
            stdin=subprocess.PIPE)
        # opening a FIFO for writing blocks until the reader opens it: do it
        # on a thread, so that a dead ffmpeg cannot hang the constructor
        self._audio_fh = None
        self._audio_ready = threading.Event()
        self._audio_failed = False

        def open_fifo():
            try:
                self._audio_fh = open(self._fifo, "wb")
            except OSError:
                self._audio_fh = None
            self._audio_ready.set()

        threading.Thread(target=open_fifo, daemon=True).start()

    def stream_frame(self, image: np.ndarray) -> None:
        if image.shape[:2] != (self.height, self.width):
            raise ValueError(f"frame {image.shape[:2]} != configured "
                             f"{(self.height, self.width)}")
        with self._lock:
            if self._pub is not None:
                _tag, ts, body = self._pkt.video_tag(image)
                self._pub.send_video(body, ts)
            elif self._proc.poll() is None:
                self._proc.stdin.write(np.ascontiguousarray(image).tobytes())

    def stream_frame_audio(self, chunk: np.ndarray) -> None:
        if self._pub is not None:
            with self._lock:
                _tag, ts, body = self._pkt.audio_tag(chunk)
                self._pub.send_audio(body, ts)
            return
        # wait for a cold ffmpeg to open the FIFO (dropping audio until then
        # would desynchronise the stream for good), but watch the process so
        # that a dead ffmpeg, which never opens it, fails a call in ~1 s
        if self._audio_failed:
            if self._proc.poll() is None and self._audio_ready.is_set():
                self._audio_failed = False   # a slow open came through: resume
            else:
                return
        deadline = 30.0
        while not self._audio_ready.wait(timeout=min(1.0, deadline)):
            deadline -= 1.0
            if self._proc.poll() is not None or deadline <= 0:
                self._audio_failed = True   # latched: no wait per chunk
                logger.warning("rtmp audio fifo not ready (ffmpeg %s): dropping audio",
                               "exited" if self._proc.poll() is not None else "slow")
                return
        if self._audio_fh is None:
            return
        pcm = np.clip(chunk, -1.0, 1.0)
        self._audio_fh.write((pcm * 32767).astype(np.int16).tobytes())

    def close(self) -> None:
        if self._pub is not None:
            self._pub.close()
            return
        with self._lock:
            if self._proc.stdin and not self._proc.stdin.closed:
                try:
                    self._proc.stdin.close()
                except BrokenPipeError:
                    pass
        # the opener thread may still be inside open(): give it a moment, so
        # that the reader sees a clean end of file and no writer leaks
        self._audio_ready.wait(timeout=1)
        if self._audio_fh is not None:
            try:
                self._audio_fh.close()
            except BrokenPipeError:
                pass
        try:
            self._proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self._proc.kill()
        shutil.rmtree(self._tmp, ignore_errors=True)


class RtmpTrackSink:
    """Drain a session's paced tracks (VideoImage and AudioChunk frames) into
    an RtmpStreamer, in place of WebRTC."""

    def __init__(self, streamer: RtmpStreamer):
        self.streamer = streamer

    async def run(self, video_track, audio_track, quit_event) -> None:
        import asyncio

        async def pump_video():
            while not quit_event.is_set():
                frame = await video_track.recv()
                self.streamer.stream_frame(frame.image)

        async def pump_audio():
            while not quit_event.is_set():
                chunk = await audio_track.recv()
                self.streamer.stream_frame_audio(chunk.samples.astype(np.float32) / 32768.0)

        await asyncio.gather(pump_video(), pump_audio())
