"""Shared engine state and services.

Port of mere_fusion_tpu/engines/base.py: 16 kHz / 20 ms audio clocking, TTS
construction, custom idle audio/video cycles keyed by audiotype, ping-pong
``mirror_index`` looping, the preview tap, and session recording: the
assembly loops tap each emitted frame and audio chunk into two queues that
a recorder thread drains into one file, chosen by the path's ending:

- ``.flv``: Screen Video and PCM16 (transport/flv.FLVWriter);
- ``.split.mp4``: ``cv2.VideoWriter`` MPEG-4 video beside a wav, merged by
  ffmpeg into ``<name>.mp4`` when it is on the PATH;
- anything else: one MP4 of MJPEG and PCM16 (transport/mp4.MP4Writer).

The recorder takes a frame, then up to two 20 ms chunks, waiting up to 1 s
for each, and drops whatever is still queued when the recording stops, as
the JAX package's does.
"""
from __future__ import annotations

import glob
import logging
import os
import queue
import subprocess
import time
import wave
from queue import Queue
from threading import Event, Thread

import cv2
import numpy as np

from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.device import device_scope
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.transport.frames import AudioChunk, VideoImage
from mere_fusion_tpu_torch.tts import make_tts

logger = logging.getLogger(__name__)


def track_put(loop, track, item) -> bool:
    """Schedule ``track._queue.put(item)`` on the session event loop from an
    engine thread. Returns False when the frame was dropped because the
    session is shutting down (the loop is closed or closing)."""
    import asyncio

    if loop is None or track is None:
        return False
    coro = track._queue.put(item)
    try:
        if loop.is_closed():
            raise RuntimeError("loop closed")
        asyncio.run_coroutine_threadsafe(coro, loop)
        return True
    except RuntimeError:
        coro.close()   # un-awaited coroutine would warn at GC
        return False


def read_imgs(img_list):
    return [cv2.imread(p) for p in img_list]


def _sorted_imgs(dirpath: str) -> list[str]:
    paths = glob.glob(os.path.join(dirpath, "*.[jpJP][pnPN]*[gG]"))
    return sorted(paths, key=lambda x: int(os.path.splitext(os.path.basename(x))[0]))


def _read_wav_f32(path: str) -> np.ndarray:
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32767
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483647
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data[:, 0]
    if sr != 16000:
        from mere_fusion_tpu_torch.tts import resample_pcm

        data = resample_pcm(data, sr, 16000)
    return data


class BaseReal:
    def __init__(self, cfg: Config, custom_opts: list[dict] | None = None,
                 device=None):
        self.cfg = cfg
        self.fps = cfg.audio.fps
        self.sample_rate = cfg.audio.sample_rate
        self.chunk = cfg.audio.chunk
        # the torch.device this engine's weights and launches live on
        self.device = device
        self.tts = make_tts(cfg, self)

        self.recording = False
        self.latest_frame = None         # most recent VideoImage (preview tap)
        self.recordq_video: Queue = Queue()
        self.recordq_audio: Queue = Queue()
        self._record_stop: Event | None = None
        self.record_thread: Thread | None = None
        self.record_error: str | None = None   # why the last recording ended early

        self.curr_state = 0  # 0 speech/silence-idle, >=2 custom track id
        self.custom_img_cycle: dict[int, list] = {}
        self.custom_audio_cycle: dict[int, np.ndarray] = {}
        self.custom_audio_index: dict[int, int] = {}
        self.custom_index: dict[int, int] = {}
        self.custom_opt: dict[int, dict] = {}
        self._load_custom(custom_opts or [])

    def device_scope(self):
        """Context manager making this engine's CUDA device the calling
        thread's current device (a thread's current device defaults to 0).
        Every engine thread that launches device work (render loop,
        inference loop, construction) runs under it. No-op on the CPU."""
        return device_scope(self.device)

    # ---- engine public API ---------------------------------------------------
    def first_video_frame_shape(self) -> tuple[int, int]:
        """(H, W) of the frames this engine emits: fixed-format transports
        (RTMP) size their pipelines from it before frames flow. LipReal and
        MuseReal read their avatar's frames, NeRFReal its full-body frames
        or its dataset."""
        if getattr(self, "avatar", None) is not None:
            return self.avatar.frame_cycle[0].shape[:2]
        if getattr(self, "fullbody_frames", None):
            return self.fullbody_frames[0].shape[:2]
        if getattr(self, "dataset", None) is not None:
            return (self.dataset.H, self.dataset.W)
        raise RuntimeError("engine has no frame source yet")

    def put_msg_txt(self, msg: str) -> None:
        self.tts.put_msg_txt(msg)

    def put_audio_frame(self, audio_chunk: np.ndarray) -> None:
        self.asr.put_audio_frame(audio_chunk)

    def pause_talk(self) -> None:
        self.tts.pause_talk()
        self.asr.pause_talk()

    def set_curr_state(self, audiotype: int, reinit: bool) -> None:
        self.curr_state = audiotype
        if reinit and audiotype in self.custom_audio_index:
            self.custom_audio_index[audiotype] = 0
            self.custom_index[audiotype] = 0

    # ---- custom idle tracks -------------------------------------------------
    def _load_custom(self, custom_opts: list[dict]) -> None:
        for item in custom_opts:
            atype = item["audiotype"]
            self.custom_img_cycle[atype] = read_imgs(_sorted_imgs(item["imgpath"]))
            self.custom_audio_cycle[atype] = _read_wav_f32(item["audiopath"])
            self.custom_audio_index[atype] = 0
            self.custom_index[atype] = 0
            self.custom_opt[atype] = item

    def init_customindex(self) -> None:
        self.curr_state = 0
        for key in self.custom_audio_index:
            self.custom_audio_index[key] = 0
        for key in self.custom_index:
            self.custom_index[key] = 0

    def get_audio_stream(self, audiotype: int) -> np.ndarray:
        idx = self.custom_audio_index[audiotype]
        stream = self.custom_audio_cycle[audiotype][idx : idx + self.chunk]
        self.custom_audio_index[audiotype] += self.chunk
        if self.custom_audio_index[audiotype] >= self.custom_audio_cycle[audiotype].shape[0]:
            self.curr_state = 1  # custom track exhausted → back to silence
        if stream.shape[0] < self.chunk:
            stream = np.pad(stream, (0, self.chunk - stream.shape[0]))
        return stream

    def put_res_frame(self, item, quit_event) -> bool:
        """Queue one frame's (image or None, index, audio pair) for the
        assembly thread, waiting while res_frame_queue is full; False
        (dropped) once quit_event is set. The assembly thread that drains
        the queue ends with the session, so a plain blocking put would hold
        the inference thread, its engine and its device buffers for good."""
        while True:
            try:
                self.res_frame_queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                if quit_event.is_set():
                    return False

    def mirror_index(self, size: int, index: int) -> int:
        """Ping-pong looping over a frame cycle."""
        turn, res = divmod(index, size)
        return res if turn % 2 == 0 else size - res - 1

    # ---- recording ------------------------------------------------------------
    def start_recording(self, path: str) -> None:
        if self.recording:
            return
        # empty the queues before the flag goes up: a frame tapped in between
        # is kept, not cleared. Each recording has its own stop event, so a
        # recorder still finishing the last frame of the previous one closes
        # its own file instead of draining into this one's.
        self.recordq_video.queue.clear()
        self.recordq_audio.queue.clear()
        self.record_error = None
        self._record_stop = stop = Event()
        self.recording = True
        self.record_thread = Thread(target=self._record_loop, args=(path, stop), daemon=True)
        self.record_thread.start()

    def stop_recording(self) -> None:
        self.recording = False
        if self._record_stop is not None:
            self._record_stop.set()

    def _record_loop(self, path: str, stop: Event) -> None:
        if path.endswith(".flv"):
            self._record_flv(path, stop)
        elif path.endswith(".split.mp4"):
            self._record_split(path, stop)
        else:
            self._record_mp4(path, stop)

    def _drain(self, open_writer, stop: Event) -> None:
        """Write queued frames until the recording stops, each followed by up
        to two 20 ms audio chunks (the assembly loops tap two a frame).
        ``open_writer(h, w)`` is called at the first frame and returns
        (write_video(image), write_audio(int16 samples)). The host time of
        each frame's writes goes to the ``record.frame`` meter."""
        meter = metrics.latency("record.frame")
        write_video = write_audio = None
        while not stop.is_set():
            try:
                frame: VideoImage = self.recordq_video.get(block=True, timeout=1)
            except queue.Empty:
                continue
            if write_video is None:
                write_video, write_audio = open_writer(*frame.image.shape[:2])
            t0 = time.perf_counter()
            write_video(frame.image)
            spent = time.perf_counter() - t0
            for _ in range(2):
                try:
                    chunk: AudioChunk = self.recordq_audio.get(block=True, timeout=1)
                except queue.Empty:
                    break
                t0 = time.perf_counter()
                write_audio(chunk.samples)
                spent += time.perf_counter() - t0
            meter.observe(spent)

    def _record_mp4(self, path: str, stop: Event) -> None:
        """One MP4 of MJPEG and PCM16 (transport/mp4): a single parseable
        file with no dependency beyond OpenCV's JPEG encoder."""
        from mere_fusion_tpu_torch.transport.mp4 import MP4Writer

        writer = None
        with open(path, "wb") as f:
            def open_writer(h, w):
                nonlocal writer
                writer = MP4Writer(f, w, h, fps=self.fps, sample_rate=self.sample_rate)
                return writer.write_video, writer.write_audio

            self._drain(open_writer, stop)
            if writer is not None:
                writer.close()

    def _record_flv(self, path: str, stop: Event) -> None:
        from mere_fusion_tpu_torch.transport.flv import FLVWriter

        writer = None
        with open(path, "wb") as f:
            def open_writer(h, w):
                nonlocal writer
                writer = FLVWriter(f, w, h, fps=self.fps, sample_rate=self.sample_rate)
                return (writer.write_video,
                        lambda s: writer.write_audio(s.astype(np.float32) / 32768.0))

            self._drain(open_writer, stop)
            if writer is not None:
                writer.close()

    def _record_split(self, path: str, stop: Event) -> None:
        """cv2.VideoWriter MPEG-4 video and a wav, merged by ffmpeg when it is
        present. A writer that does not open (no MPEG-4 encoder in this
        OpenCV build) ends the recording with ``record_error`` set and the
        two files removed; the JAX package's recorder writes on into the
        closed writer and leaves an empty video file without a word."""
        base = path[: -len(".split.mp4")] + ".mp4"
        vid_path, aud_path = base + ".video.mp4", base + ".audio.wav"
        writer = None
        wav = wave.open(aud_path, "wb")
        wav.setnchannels(1)
        wav.setsampwidth(2)
        wav.setframerate(self.sample_rate)

        def open_writer(h, w):
            nonlocal writer
            writer = cv2.VideoWriter(vid_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                     self.fps, (w, h))
            if not writer.isOpened():
                raise OSError(f"cv2.VideoWriter did not open {vid_path!r} with "
                              "fourcc mp4v: this OpenCV build has no MPEG-4 encoder")
            return writer.write, lambda s: wav.writeframes(s.tobytes())

        try:
            self._drain(open_writer, stop)
        except OSError as e:
            stop.set()
            if self._record_stop is stop:      # not a later recording's
                self.recording = False
                self.record_error = str(e)
            logger.error("recording to %s stopped: %s", path, e)
            failed = True
        else:
            failed = False
        finally:
            if writer is not None:
                writer.release()
            wav.close()
        if failed:
            for p in (vid_path, aud_path):
                if os.path.exists(p):
                    os.remove(p)
            return
        self._mux(vid_path, aud_path, base)

    @staticmethod
    def _mux(vid_path: str, aud_path: str, out_path: str) -> None:
        """Merge with ffmpeg when present; else keep the split files."""
        try:
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "error", "-i", vid_path, "-i", aud_path,
                 "-c:v", "copy", "-c:a", "aac", out_path],
                check=True, timeout=120,
            )
            os.remove(vid_path)
            os.remove(aud_path)
        except (FileNotFoundError, subprocess.SubprocessError):
            pass

    def record_video_frame(self, frame: VideoImage) -> None:
        # single-slot tap for the HTTP MJPEG preview
        self.latest_frame = frame
        if self.recording:
            self.recordq_video.put(frame)

    def record_audio_chunk(self, chunk: AudioChunk) -> None:
        if self.recording:
            self.recordq_audio.put(chunk)
