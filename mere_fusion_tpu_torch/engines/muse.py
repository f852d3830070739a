"""MuseTalk real-time engine on the GPU.

Port of mere_fusion_tpu/engines/muse.py:

    TTS ─▶ BaseASR queue ─▶ MuseASR.run_step: whisper embeddings (device)
    ─▶ feat_queue ─▶ inference thread: batch-16 UNet (t=0) + VAE decode
    ─▶ pinned one-deep readback ─▶ res_frame_queue
    ─▶ assembly: feathered-mask blend ─▶ tracks

The UNet's long self-attentions run kernel K1 (ops/attention.py). Only the
float step is ported: the int8 VAE tier (JAX ops/quant.py, ROADMAP K5) is
not, so ``vae_int8="on"`` raises and ``"auto"`` serves float.
"""
from __future__ import annotations

import copy
import logging
import os
import pickle
import queue
import time
from dataclasses import dataclass
from queue import Queue
from threading import Event, Thread

import cv2
import numpy as np
import torch

from mere_fusion_tpu_torch.audio.features import WhisperFeatureExtractor
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.device import parse_dtype, random_init_, resolve_device
from mere_fusion_tpu_torch.engines.base import BaseReal, _sorted_imgs, track_put
from mere_fusion_tpu_torch.engines.base_asr import BaseASR
from mere_fusion_tpu_torch.models.musetalk import (
    AutoencoderKL,
    UNet2DCondition,
    UNetConfig,
    VAEConfig,
    positional_encoding,
)
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.transport.frames import AudioChunk, VideoImage

logger = logging.getLogger(__name__)
_int8_notice_logged = False


def blend_face(image: np.ndarray, face: np.ndarray, face_box, mask: np.ndarray,
               crop_box) -> np.ndarray:
    """Feathered paste-back. face_box (x, y, x1, y1) is where the generated
    face goes; crop_box is the larger region the mask covers; mask is a BGR
    image whose gray level is the blend weight for the generated content."""
    from mere_fusion_tpu_torch import native

    x, y, x1, y1 = face_box
    x_s, y_s, x_e, y_e = crop_box
    face_large = np.ascontiguousarray(image[y_s:y_e, x_s:x_e])
    native.paste_u8(np.ascontiguousarray(face), face_large, y - y_s, x - x_s)
    w = (cv2.cvtColor(mask, cv2.COLOR_BGR2GRAY) / 255.0).astype(np.float32)
    image[y_s:y_e, x_s:x_e] = native.blend_linear_u8(
        face_large, np.ascontiguousarray(image[y_s:y_e, x_s:x_e]), w
    )
    return image


@dataclass
class MuseAvatar:
    frame_cycle: list[np.ndarray]            # full frames BGR u8
    coords: list[tuple]                      # (x1, y1, x2, y2) face boxes
    latent_cycle: np.ndarray                 # [N, h, w, 8] masked+ref latents
    mask_cycle: list[np.ndarray]             # blend masks (BGR u8)
    mask_coords: list[tuple]                 # (x_s, y_s, x_e, y_e) crop boxes

    def __len__(self) -> int:
        return len(self.frame_cycle)


def load_muse_avatar(avatar_path: str) -> MuseAvatar:
    """Load a musetalk avatar bundle (coords.pkl, latents.pt or latents.npy,
    full_imgs/, mask/, mask_coords.pkl). The pickles are trusted local
    files written by the avatar tools."""
    with open(os.path.join(avatar_path, "coords.pkl"), "rb") as f:
        coords = pickle.load(f)
    with open(os.path.join(avatar_path, "mask_coords.pkl"), "rb") as f:
        mask_coords = pickle.load(f)
    frames = [cv2.imread(p) for p in _sorted_imgs(os.path.join(avatar_path, "full_imgs"))]
    masks = [cv2.imread(p) for p in _sorted_imgs(os.path.join(avatar_path, "mask"))]
    lat_path = os.path.join(avatar_path, "latents.pt")
    if os.path.exists(lat_path):
        lat = torch.load(lat_path, map_location="cpu", weights_only=True)
        # list of [1, 8, h, w] → [N, h, w, 8]
        latents = np.stack([t[0].float().numpy().transpose(1, 2, 0) for t in lat])
    else:
        latents = np.load(os.path.join(avatar_path, "latents.npy"))
    return MuseAvatar(frames, coords, latents.astype(np.float32), masks, mask_coords)


def preprocess_face(img_bgr: np.ndarray, size: int, half_mask: bool) -> np.ndarray:
    """BGR u8 → normalized RGB float in [-1, 1], lower half −1 when masked."""
    img = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB)
    img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LANCZOS4)
    x = img.astype(np.float32) / 255.0
    if half_mask:
        x[size // 2 :] = 0.0
    return (x - 0.5) / 0.5


def _materialise(module: torch.nn.Module, state, seed: int, device, dtype):
    """A module built on the meta device, filled from ``state`` (strict key
    match; tensors are taken over without a copy where device and dtype
    already match) or from a seeded generator on ``device``."""
    if state is None:
        module.to_empty(device=device)
        random_init_(module, seed)
    else:
        module.load_state_dict(state, strict=True, assign=True)
    return module.to(device=device, dtype=dtype).eval().requires_grad_(False)


class MuseModels:
    """VAE + UNet pair with the fused generation step."""

    def __init__(self, vae_cfg: VAEConfig | None = None,
                 unet_cfg: UNetConfig | None = None,
                 vae_state=None, unet_state=None, face_size: int = 256,
                 dtype: torch.dtype = torch.float32, device=None,
                 vae_int8: bool | str = "auto"):
        """vae_state / unet_state: diffusers-named state dicts; None means
        random weights (seeds 0 and 1). vae_int8: "off" is the float step;
        "on" raises (the int8 tier is not ported); "auto" serves float."""
        global _int8_notice_logged
        if isinstance(vae_int8, bool):
            vae_int8 = "on" if vae_int8 else "off"
        if vae_int8 == "on":
            raise NotImplementedError(
                "the int8 VAE decode tier is not ported to the PyTorch package "
                "(ROADMAP K5 ops/quant.py::int8_conv); use vae_int8='off'")
        if vae_int8 not in ("auto", "off"):
            raise ValueError(f"vae_int8 must be auto|on|off, got {vae_int8!r}")
        if vae_int8 == "auto" and not _int8_notice_logged:
            _int8_notice_logged = True
            logger.info("vae_int8=auto: no int8 rung is ported (ROADMAP K5); "
                        "serving the float step")
        self.int8_tier = "off"
        self.int8_gate_probes: dict = {}

        self.device = resolve_device(device)
        self.dtype = dtype
        self.vae_cfg = vae_cfg or VAEConfig()
        self.unet_cfg = unet_cfg or UNetConfig()
        self.face_size = face_size
        self.latent_size = face_size // 2 ** (len(self.vae_cfg.block_out_channels) - 1)
        with torch.device("meta"):
            vae = AutoencoderKL(self.vae_cfg)
            unet = UNet2DCondition(self.unet_cfg)
        self.vae = _materialise(vae, vae_state, 0, self.device, dtype)
        self.unet = _materialise(unet, unet_state, 1, self.device, dtype)
        self.scaling_factor = self.vae_cfg.scaling_factor

    @torch.no_grad()
    def generate(self, latents: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        """[B,h,w,8] latents + [B,W,384] whisper features (NHWC, as the JAX
        twin) → [B,S,S,3] BGR uint8 faces on the device."""
        lat = latents.to(self.device).permute(0, 3, 1, 2).to(self.dtype)
        ctx = positional_encoding(feats.to(self.device, torch.float32))
        t = torch.zeros(lat.shape[0], device=self.device)
        pred = self.unet(lat, t, ctx)
        img = self.vae.decode(pred / self.scaling_factor)
        img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
        img = torch.round(img * 255.0).to(torch.uint8)
        return img.permute(0, 2, 3, 1).flip(-1).contiguous()   # RGB → BGR

    @torch.no_grad()
    def encode_pair(self, faces: torch.Tensor) -> torch.Tensor:
        """[B,H,W,3] in [-1,1] (unmasked) → [B,h,w,8] scaled latents
        (lower-half-masked latents, then reference latents)."""
        x = faces.to(self.device, torch.float32).permute(0, 3, 1, 2)
        masked = x.clone()
        masked[:, :, x.shape[2] // 2 :] = -1.0
        sf = self.scaling_factor
        zm = self.vae.encode(masked.to(self.dtype)) * sf
        zr = self.vae.encode(x.to(self.dtype)) * sf
        return torch.cat([zm, zr], dim=1).permute(0, 2, 3, 1).float()


def synthesize_muse_avatar(models: MuseModels, n_frames: int = 6,
                           frame_hw=(240, 320)) -> MuseAvatar:
    """Procedural avatar for tests/demos: real latents from the given VAE and
    feathered box blend masks."""
    h, w = frame_hw
    s = models.face_size
    y1, x1 = h // 4, w // 4
    y2, x2 = y1 + h // 2, x1 + w // 2
    frames, coords, faces, masks, mask_coords = [], [], [], [], []
    for i in range(n_frames):
        yy, xx = np.mgrid[0:h, 0:w]
        frame = np.stack(
            [((xx * 255) // w).astype(np.uint8),
             ((yy * 255) // h).astype(np.uint8),
             np.full((h, w), (i * 37) % 255, np.uint8)],
            axis=-1,
        )
        frames.append(frame)
        coords.append((x1, y1, x2, y2))
        faces.append(preprocess_face(frame[y1:y2, x1:x2], s, half_mask=False))
        pad = 8
        xs, ys = max(0, x1 - pad), max(0, y1 - pad)
        xe, ye = min(w, x2 + pad), min(h, y2 + pad)
        mask = np.zeros((ye - ys, xe - xs), np.uint8)
        mask[y1 - ys : y2 - ys, x1 - xs : x2 - xs] = 255
        mask = cv2.GaussianBlur(mask, (15, 15), 0)
        masks.append(cv2.cvtColor(mask, cv2.COLOR_GRAY2BGR))
        mask_coords.append((xs, ys, xe, ye))
    latents = models.encode_pair(torch.from_numpy(np.stack(faces))).cpu().numpy()
    return MuseAvatar(frames, coords, latents, masks, mask_coords)


class MuseASR(BaseASR):
    """Whisper-embedding feeder."""

    def __init__(self, cfg: Config, parent, feature_extractor: WhisperFeatureExtractor):
        super().__init__(cfg, parent)
        self.features = feature_extractor

    def run_step(self) -> None:
        for _ in range(self.batch_size * 2):
            frame, ftype = self.get_audio_frame()
            self.frames.append(frame)
            self.output_queue.put((frame, ftype, self.consumed_seq))
        if len(self.frames) <= self.stride_left_size + self.stride_right_size:
            return
        t0 = time.perf_counter()
        # device-resident features: the whisper embeddings never cross back
        # to the host, the [B, W, D] chunks feed the generator directly
        emb, n_frames = self.features.audio2feat_device(np.concatenate(self.frames))
        chunks = self.features.chunks_device(
            emb, n_frames,
            fps=self.fps / 2,
            batch_size=self.batch_size,
            start=self.stride_left_size / 2,
        )
        metrics.latency("muse.featurize").observe(time.perf_counter() - t0)
        if not self.put_feat(chunks):
            return
        self.frames = self.frames[-(self.stride_left_size + self.stride_right_size):]


class MuseReal(BaseReal):
    def __init__(self, cfg: Config, models: MuseModels | None = None,
                 avatar: MuseAvatar | None = None,
                 feature_extractor: WhisperFeatureExtractor | None = None,
                 custom_opts: list[dict] | None = None,
                 device=None):
        if device is None and models is not None:
            device = models.device
        device = resolve_device(device)
        super().__init__(cfg, custom_opts, device=device)
        self.batch_size = cfg.avatar.batch_size
        with self.device_scope():
            self.models = models or MuseModels(
                dtype=parse_dtype(cfg.avatar.dtype), device=device,
                vae_int8=cfg.avatar.vae_int8)
            if avatar is None:
                avatar = load_muse_avatar(
                    os.path.join(cfg.avatar.avatar_dir, cfg.avatar.avatar_id))
            self.avatar = avatar
            # latents on the device once: per batch only the index vector
            # crosses, and the gather runs on the device
            self._latents_dev = torch.from_numpy(
                np.asarray(avatar.latent_cycle, dtype=np.float32)).to(device)
            self.res_frame_queue: Queue = Queue(self.batch_size * 2)
            self.asr = MuseASR(cfg, self, feature_extractor
                               or WhisperFeatureExtractor(device=device))
            # two pinned host slots for the one-deep readback: a batch's
            # device→host copy runs while the next batch is enqueued
            s = self.models.face_size
            self._pinned = ([torch.empty((self.batch_size, s, s, 3), dtype=torch.uint8,
                                         pin_memory=True) for _ in range(2)]
                            if device.type == "cuda" else None)
            self._slot = 0
        self.asr.warm_up()
        # warm the generator (K1 build and load, cuDNN plans) at the
        # extractor's window shape so the first utterance does not stall
        m = self.models
        seq = 10 * (self.asr.features.dims.n_audio_layer + 1)
        with self.device_scope():
            m.generate(
                torch.zeros((self.batch_size, m.latent_size, m.latent_size,
                             m.unet_cfg.in_channels), device=device),
                torch.zeros((self.batch_size, seq, m.unet_cfg.cross_attention_dim),
                            device=device),
            ).cpu()
        self.render_event = Event()

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

    # ---- device inference stage ---------------------------------------------
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
            metrics.latency("muse.infer_batch").observe(time.perf_counter() - t0)
            metrics.rate("muse.infer_fps").tick(self.batch_size)
            for i, (idx, pair) in enumerate(metas):
                self.put_res_frame((frames[i], idx, pair), quit_event)

        while not quit_event.is_set():
            if not self.render_event.is_set():
                flush()
                time.sleep(0.1)
                continue
            try:
                chunks = self.asr.get_next_feat(timeout=0.02 if pending else 1)
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
            latents = self._latents_dev[torch.tensor(idxs, device=self.device)]
            host, done = self._readback(self.models.generate(latents, chunks))
            flush()    # the previous batch's copy ran under these launches
            metas = []
            for i in range(self.batch_size):
                metas.append((idxs[i], audio_frames[i * 2 : i * 2 + 2]))
                index += 1
            pending = (done, host, t0, metas)
            if self.asr.feat_queue.empty():
                # nothing queued behind this batch: deliver it now instead
                # of paying the next poll's 20 ms
                flush()
        flush()

    # ---- frame assembly -------------------------------------------------------
    def process_frames(self, quit_event, loop=None, audio_track=None, video_track=None):
        while not quit_event.is_set():
            try:
                res_frame, idx, audio_frames = self.res_frame_queue.get(
                    block=True, timeout=1)
            except queue.Empty:
                continue
            if audio_frames[0][1] != 0 and audio_frames[1][1] != 0:
                if self.asr.is_stale_silence(audio_frames):
                    # speech queued behind this pre-buffered idle frame:
                    # drop it (video + silent audio) so speech ships sooner
                    continue
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
                    metrics.latency("muse.first_frame").observe(
                        time.monotonic() - self.asr.speech_start_ts)
                    self.asr.speech_start_ts = None
                x1, y1, x2, y2 = self.avatar.coords[idx]
                ori = copy.deepcopy(self.avatar.frame_cycle[idx])
                face = cv2.resize(res_frame, (x2 - x1, y2 - y1))
                combine_frame = blend_face(
                    ori, face, (x1, y1, x2, y2),
                    self.avatar.mask_cycle[idx], self.avatar.mask_coords[idx])
                metrics.counter("muse.generated_frames")
            video_frame = VideoImage(image=combine_frame)
            track_put(loop, video_track, video_frame)
            self.record_video_frame(video_frame)
            for frame, _t, _seq in audio_frames:
                chunk = AudioChunk.from_float(frame, self.sample_rate)
                track_put(loop, audio_track, chunk)
                self.record_audio_chunk(chunk)

    # ---- render loop -----------------------------------------------------------
    def render(self, quit_event, loop=None, audio_track=None, video_track=None):
        self.tts.render(quit_event)
        self.init_customindex()
        self.asr.quit_event = quit_event
        Thread(target=self.process_frames,
               args=(quit_event, loop, audio_track, video_track), daemon=True).start()
        Thread(target=self._inference_loop, args=(quit_event,), daemon=True).start()
        self.render_event.set()
        with self.device_scope():  # asr.run_step launches the whisper encoder
            while not quit_event.is_set():
                self.asr.run_step()
                if (video_track is not None
                        and video_track._queue.qsize()
                        >= max(self.cfg.avatar.max_track_queue, 1.5 * self.batch_size)):
                    time.sleep(0.04 * video_track._queue.qsize() * 0.8)
        self.render_event.clear()
