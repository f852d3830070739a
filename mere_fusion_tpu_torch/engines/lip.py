"""Wav2Lip real-time engine on the GPU.

Port of mere_fusion_tpu/engines/lip.py:

    TTS ─▶ BaseASR queue ─▶ LipASR.run_step: mel windows (device)
    ─▶ feat_queue ─▶ inference thread: batch-16 Wav2Lip step
    ─▶ pinned one-deep readback ─▶ res_frame_queue
    ─▶ assembly: resize + bbox paste ─▶ tracks

Silence frames bypass the device entirely (reference: lipreal.py:102-105).
The face crops go to the device once; a batch gathers them by index.
"""
from __future__ import annotations

import copy
import os
import queue
import time
from queue import Queue
from threading import Event, Thread

import cv2
import numpy as np
import torch

from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.device import parse_dtype, random_init_, resolve_device
from mere_fusion_tpu_torch.engines.avatar import LipAvatar, load_lip_avatar
from mere_fusion_tpu_torch.engines.base import BaseReal, track_put
from mere_fusion_tpu_torch.engines.base_asr import BaseASR
from mere_fusion_tpu_torch.models.wav2lip import Wav2Lip, cast_convs_
from mere_fusion_tpu_torch.ops.mel import WAV2LIP_MEL, melspectrogram, num_mel_frames
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.transport.frames import AudioChunk, VideoImage


def mel_window_starts(
    n_chunks: int, chunk: int, batch: int, fps: int, stride_left: int
) -> list[int]:
    """Static mel-window start columns for one featurization step.

    Reproduces the reference's slicing (lipasr.py:23-36): windows of 16 mel
    columns at 80 Hz, stepped at 2 audio chunks (one video frame) apiece,
    clamped to the spectrogram tail.
    """
    total = num_mel_frames(n_chunks * chunk, WAV2LIP_MEL)
    left = max(0, int(stride_left * 80 / 50))
    mult = 80.0 * 2 / fps
    starts = []
    for i in range(batch):
        s = int(left + i * mult)
        starts.append(min(s, total - 16))
    return starts


def make_lip_feature_fn(cfg: Config, device=None):
    """(features, n_chunks): features maps the concatenated float32 audio
    of one step (n_chunks chunks) to its stacked mel windows [batch, 80, 16]
    on ``device``, through a static gather of the spectrogram's columns."""
    device = resolve_device(device)
    n_chunks = cfg.stride.left + cfg.stride.right + 2 * cfg.avatar.batch_size
    starts = np.asarray(
        mel_window_starts(
            n_chunks, cfg.audio.chunk, cfg.avatar.batch_size, cfg.audio.fps,
            cfg.stride.left,
        ),
        dtype=np.int64,
    )
    idx = torch.from_numpy(starts[:, None] + np.arange(16)[None, :]).to(device)  # [B, 16]

    def features(audio: np.ndarray) -> torch.Tensor:
        mel = melspectrogram(torch.from_numpy(audio).to(device), WAV2LIP_MEL)  # [80, T]
        return mel[:, idx].permute(1, 0, 2).contiguous()                       # [B, 80, 16]

    return features, n_chunks


def load_wav2lip(state=None, dtype: torch.dtype = torch.bfloat16, device=None) -> Wav2Lip:
    """The serving generator on ``device``: from ``state`` (the reference's
    names; tensors already on the device are taken over without a copy) or
    seeded weights, its convs stored in ``dtype`` (BatchNorm in float32),
    in eval mode with no gradients."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = Wav2Lip(dtype)
    if state is None:
        model.to_empty(device=device)
        random_init_(model, seed=0)
    else:
        model.load_state_dict(state, strict=True, assign=True)
        model.to(device)
    return cast_convs_(model, dtype).eval().requires_grad_(False)


def generator_inputs(faces_u8: torch.Tensor) -> torch.Tensor:
    """Face crops u8 [B, S, S, 3] → the generator's [B, S, S, 6] in [0, 1]:
    the crops with their lower half set to 0, then the crops."""
    # jitted JAX divides by 255 as a multiply by the f32 reciprocal
    faces = faces_u8.float() * (1.0 / 255.0)
    masked = faces.clone()
    masked[:, faces.shape[1] // 2:] = 0.0
    return torch.cat([masked, faces], dim=-1)


def make_lip_device_step(model: Wav2Lip):
    """step(mel windows [B, 80, 16], face crops u8 [B, S, S, 3]) → u8
    [B, S, S, 3] on the model's device: the generator on generator_inputs,
    then clip(pred · 255) truncated to uint8 (the JAX step's astype)."""

    @torch.no_grad()
    def step(mel: torch.Tensor, faces_u8: torch.Tensor) -> torch.Tensor:
        pred = model(mel, generator_inputs(faces_u8))
        return torch.clamp(pred * 255.0, 0.0, 255.0).to(torch.uint8)

    return step


class LipASR(BaseASR):
    """Accumulates 2×batch 20 ms chunks and emits per-frame mel windows
    (reference: lipasr.py:14-37), computed and kept on the device."""

    def __init__(self, cfg: Config, parent=None, device=None):
        super().__init__(cfg, parent)
        self._features, _ = make_lip_feature_fn(cfg, device)

    def run_step(self) -> None:
        for _ in range(self.batch_size * 2):
            frame, ftype = self.get_audio_frame()
            self.frames.append(frame)
            self.output_queue.put((frame, ftype, self.consumed_seq))
        if len(self.frames) <= self.stride_left_size + self.stride_right_size:
            return
        t0 = time.perf_counter()
        feats = self._features(np.concatenate(self.frames).astype(np.float32))
        metrics.latency("lip.featurize").observe(time.perf_counter() - t0)
        if not self.put_feat(feats):
            return
        self.frames = self.frames[-(self.stride_left_size + self.stride_right_size):]


class LipReal(BaseReal):
    def __init__(
        self,
        cfg: Config,
        state=None,
        avatar: LipAvatar | None = None,
        custom_opts: list[dict] | None = None,
        device=None,
    ):
        """state: the generator's state dict under the reference's names
        (None: seeded weights; the silence path is exact either way)."""
        device = resolve_device(device)
        super().__init__(cfg, custom_opts, device=device)
        self.batch_size = cfg.avatar.batch_size
        self.img_size = cfg.avatar.img_size
        self.res_frame_queue: Queue = Queue(self.batch_size * 2)

        if avatar is None:
            avatar = load_lip_avatar(
                os.path.join(cfg.avatar.avatar_dir, cfg.avatar.avatar_id),
                self.img_size,
            )
        self.avatar = avatar

        s = self.img_size
        with self.device_scope():
            # face crops on the device once: per batch only the index vector
            # crosses, and the gather runs on the device
            self._faces_dev = torch.from_numpy(np.stack(avatar.face_cycle)).to(device)
            self.model = load_wav2lip(state, parse_dtype(cfg.avatar.dtype), device)
            self._device_step = make_lip_device_step(self.model)
            # two pinned host slots for the one-deep readback: a batch's
            # device→host copy runs while the next batch is enqueued
            self._pinned = ([torch.empty((self.batch_size, s, s, 3), dtype=torch.uint8,
                                         pin_memory=True) for _ in range(2)]
                            if device.type == "cuda" else None)
            self._slot = 0
            # warm the generator (cuDNN plans, allocator) so the first
            # utterance does not stall behind them
            self._device_step(
                torch.zeros((self.batch_size, 80, 16), device=device),
                torch.zeros((self.batch_size, s, s, 3), dtype=torch.uint8, device=device),
            ).cpu()
            self.asr = LipASR(cfg, self, device)
        self.asr.warm_up()
        self.render_event = Event()

    @classmethod
    def from_checkpoint(cls, cfg: Config, ckpt_path: str, **kw) -> "LipReal":
        """An engine serving a reference ``wav2lip.pth``."""
        from mere_fusion_tpu_torch.utils.torch_convert import (
            convert_wav2lip,
            load_torch_checkpoint,
        )

        return cls(cfg, state=convert_wav2lip(load_torch_checkpoint(ckpt_path)), **kw)

    def _readback(self, img: torch.Tensor):
        """Start the device→host copy of a generated batch; returns (host
        tensor, CUDA event marking its completion or None on the CPU)."""
        if self._pinned is None:
            return img, None
        host = self._pinned[self._slot]
        self._slot ^= 1
        host.copy_(img, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(img.device))
        return host, done

    # ---- device inference stage --------------------------------------------
    def _inference_loop(self, quit_event) -> None:
        with self.device_scope():
            self._inference_loop_impl(quit_event)

    def _inference_loop_impl(self, quit_event) -> None:
        length = len(self.avatar)
        index = 0
        # one-deep generated-batch pipeline: the batch's device→host copy
        # overlaps the NEXT batch's launches. The pending batch is flushed
        # before any later (silence or generated) batch is emitted, so frame
        # order is FIFO, and immediately when the stream pauses.
        pending = None  # (done event, host tensor, t0, [(idx, audio_pair)])

        def flush():
            nonlocal pending
            if pending is None:
                return
            done, host, t0, metas = pending
            pending = None
            if done is not None:
                done.synchronize()
            # copy out: the pinned slot is reused two batches later while
            # these frames may still wait in res_frame_queue
            frames = host.numpy().copy()
            metrics.latency("lip.infer_batch").observe(time.perf_counter() - t0)
            metrics.rate("lip.infer_fps").tick(self.batch_size)
            for i, (idx, pair) in enumerate(metas):
                self.put_res_frame((frames[i], idx, pair), quit_event)

        while not quit_event.is_set():
            if not self.render_event.is_set():
                flush()
                time.sleep(0.1)
                continue
            try:
                mel_batch = self.asr.get_next_feat(timeout=0.02 if pending else 1)
            except queue.Empty:
                flush()    # stream pause: deliver the in-flight batch now
                continue
            audio_frames = [self.asr.get_audio_out() for _ in range(self.batch_size * 2)]
            if all(f[1] != 0 for f in audio_frames):
                flush()
                for i in range(self.batch_size):
                    self.put_res_frame(
                        (None, self.mirror_index(length, index),
                         audio_frames[i * 2 : i * 2 + 2]), quit_event)
                    index += 1
                continue
            t0 = time.perf_counter()
            idxs = [self.mirror_index(length, index + i) for i in range(self.batch_size)]
            faces = self._faces_dev[torch.tensor(idxs, device=self.device)]
            host, done = self._readback(self._device_step(mel_batch, faces))
            flush()    # the previous batch's copy ran under these launches
            metas = []
            for i in range(self.batch_size):
                metas.append((idxs[i], audio_frames[i * 2 : i * 2 + 2]))
                index += 1
            pending = (done, host, t0, metas)
            if self.asr.feat_queue.empty():
                # nothing queued behind this batch: deliver it now instead
                # of paying the next poll's 20 ms (the audio-to-first-frame
                # case is exactly this)
                flush()
        flush()

    # ---- frame assembly stage ----------------------------------------------
    def process_frames(self, quit_event, loop=None, audio_track=None, video_track=None):
        while not quit_event.is_set():
            try:
                res_frame, idx, audio_frames = self.res_frame_queue.get(
                    block=True, timeout=1)
            except queue.Empty:
                continue
            if audio_frames[0][1] != 0 and audio_frames[1][1] != 0:
                if self.asr.is_stale_silence(audio_frames):
                    # speech is queued behind this pre-buffered idle frame:
                    # drop it (video + silent audio) so speech ships sooner
                    continue
                # silence: emit the idle/custom full frame untouched
                audiotype = audio_frames[0][1]
                if self.custom_index.get(audiotype) is not None:
                    mirindex = self.mirror_index(
                        len(self.custom_img_cycle[audiotype]),
                        self.custom_index[audiotype])
                    combine_frame = self.custom_img_cycle[audiotype][mirindex]
                    self.custom_index[audiotype] += 1
                else:
                    combine_frame = self.avatar.frame_cycle[idx]
            else:
                if self.asr.speech_start_ts is not None:
                    metrics.latency("lip.first_frame").observe(
                        time.monotonic() - self.asr.speech_start_ts)
                    self.asr.speech_start_ts = None
                y1, y2, x1, x2 = self.avatar.coords[idx]
                combine_frame = copy.deepcopy(self.avatar.frame_cycle[idx])
                try:
                    res_frame = cv2.resize(res_frame, (x2 - x1, y2 - y1))
                except cv2.error:
                    continue
                combine_frame[y1:y2, x1:x2] = res_frame
                metrics.counter("lip.generated_frames")

            video_frame = VideoImage(image=combine_frame)
            track_put(loop, video_track, video_frame)
            self.record_video_frame(video_frame)
            for frame, _ftype, _seq in audio_frames:
                chunk = AudioChunk.from_float(frame, self.sample_rate)
                track_put(loop, audio_track, chunk)
                self.record_audio_chunk(chunk)

    # ---- render loop ---------------------------------------------------------
    def render(self, quit_event, loop=None, audio_track=None, video_track=None):
        self.tts.render(quit_event)
        self.init_customindex()
        self.asr.quit_event = quit_event
        Thread(target=self.process_frames,
               args=(quit_event, loop, audio_track, video_track), daemon=True).start()
        Thread(target=self._inference_loop, args=(quit_event,), daemon=True).start()
        self.render_event.set()
        with self.device_scope():  # asr.run_step launches the mel
            while not quit_event.is_set():
                self.asr.run_step()
                if (video_track is not None
                        and video_track._queue.qsize() >= self.cfg.avatar.max_track_queue):
                    time.sleep(0.04 * video_track._queue.qsize() * 0.8)
        self.render_event.clear()
