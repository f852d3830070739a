"""Shared engine state and services.

Port of mere_fusion_tpu/engines/base.py: 16 kHz / 20 ms audio clocking, TTS
construction, custom idle audio/video cycles keyed by audiotype, ping-pong
``mirror_index`` looping, and the preview tap. Session recording is not
ported yet (ROADMAP "Recording").
"""
from __future__ import annotations

import glob
import os

import cv2
import numpy as np

from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.device import device_scope
from mere_fusion_tpu_torch.transport.frames import VideoImage
from mere_fusion_tpu_torch.tts import make_tts


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

    def mirror_index(self, size: int, index: int) -> int:
        """Ping-pong looping over a frame cycle."""
        turn, res = divmod(index, size)
        return res if turn % 2 == 0 else size - res - 1

    # ---- recording ------------------------------------------------------------
    def start_recording(self, path: str) -> None:
        raise NotImplementedError(
            "session recording is not ported to the PyTorch package yet "
            "(ROADMAP: 'Recording')")

    def stop_recording(self) -> None:
        self.recording = False

    def record_video_frame(self, frame: VideoImage) -> None:
        # single-slot tap for the HTTP MJPEG preview
        self.latest_frame = frame
