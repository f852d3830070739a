"""ER-NeRF real-time engine on the GPU.

Port of mere_fusion_tpu/engines/nerf.py (the twin of the reference's
nerfreal.py/nerfasr.py) on its default serving path: a render loop that runs
two 20 ms ASR steps per video frame, pulls the looped camera pose, feeds the
live audio features through a circular feature ring with an 8-window
attention context, and renders the talking head through the K2 frame step
(engines/nerf_step.py) from triplanes baked at construction.

Ported: the fake featurizer (``nerf.asr_model = ""``), ``NerfASR`` with its
device-resident feature ring, the audio-code EMA (in the frame step) and ``NeRFReal`` with
``nerf.sample_mode = "pallas"``, on random weights from a fixed seed. Not
yet ported, each raising and naming its ROADMAP item: the DeepSpeech and
wav2vec featurizers (and with them device-side featurizer flushes), the
other sample modes, the torso net, the orbit camera, the fullbody paste
and checkpoint loading.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import cv2
import numpy as np
import torch

from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.data.provider import NeRFTestDataset
from mere_fusion_tpu_torch.device import resolve_device
from mere_fusion_tpu_torch.engines.base import BaseReal, track_put
from mere_fusion_tpu_torch.engines.base_asr import BaseASR
from mere_fusion_tpu_torch.engines.nerf_step import make_render_step
from mere_fusion_tpu_torch.models.ernerf.network import (
    NeRFNetConfig,
    NeRFNetwork,
    init_ernerf_,
)
from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
from mere_fusion_tpu_torch.ops.triplane_bake import bake_triplanes
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.transport.frames import AudioChunk, VideoImage


def fake_logits_fn(audio_dim: int) -> Callable[[np.ndarray], np.ndarray]:
    """Deterministic energy-based CTC-logit stand-in: one row per 20 ms frame."""

    def fn(audio: np.ndarray) -> np.ndarray:
        frames = audio.reshape(-1, 320)
        energy = np.sqrt((frames**2).mean(axis=1, keepdims=True))
        base = np.linspace(0, 1, audio_dim, dtype=np.float32)[None]
        return (energy * base).astype(np.float32)[:-1]  # T-1 rows like wav2vec

    return fn


class NerfASR(BaseASR):
    """Sliding-window CTC featurizer with a circular feature ring.

    Feature ring: [4 × context] rows of [audio_dim]; per step one 20 ms frame
    is consumed and, once l+m+r frames accumulate, the middle m logit rows
    are written to the ring. get_next_feat returns an [8, audio_dim, 16]
    attention stack advancing 2 rows (one video frame) per call.
    """

    def __init__(self, cfg: Config, parent, logits_fn: Callable, device=None):
        super().__init__(cfg, parent)
        self.audio_dim = cfg.nerf.audio_in_dim
        self.context_size = cfg.stride.mid
        self.logits_fn = logits_fn
        self.device = device if device is not None else torch.device("cpu")
        self.frames.extend([np.zeros(self.chunk, np.float32)] * self.stride_left_size)
        self.feat_buffer_size = 4
        self.feat_buffer_idx = 0
        self.feat_ring = np.zeros(
            (self.feat_buffer_size * self.context_size, self.audio_dim), np.float32)
        self.front = self.feat_buffer_size * self.context_size - 8
        self.tail = 8
        self.att_feats: list[np.ndarray] = [np.zeros((self.audio_dim, 16), np.float32)] * 4
        self.warm_up_steps = (self.context_size + self.stride_left_size
                              + self.stride_right_size)
        # device mirror of the feature ring (lazy; see get_next_feat_device):
        # per flush only the [context, dim] block moves to the device, not an
        # [8, dim, 16] window per frame
        self._ring_dev: Optional[torch.Tensor] = None
        self._att_dev: Optional[list] = None

    # non-blocking pull: NerfASR runs inside the render loop and must
    # synthesize silence at once rather than wait
    queue_timeout = None

    def run_step(self) -> None:
        frame, ftype = self.get_audio_frame()
        self.frames.append(frame)
        self.output_queue.put((frame, ftype, self.consumed_seq))
        window = self.stride_left_size + self.context_size + self.stride_right_size
        if len(self.frames) < window:
            return
        audio = np.concatenate(self.frames)
        self.frames = self.frames[-(self.stride_left_size + self.stride_right_size):]
        start = self.feat_buffer_idx * self.context_size
        self.feat_buffer_idx = (self.feat_buffer_idx + 1) % self.feat_buffer_size
        ctx = self.context_size
        logits = self.logits_fn(audio)  # [T, audio_dim]
        feats = logits[self.stride_left_size:self.stride_left_size + ctx]
        self.feat_ring[start:start + feats.shape[0]] = feats
        if self._ring_dev is not None:
            # the ring length is a multiple of context: the block never wraps
            self._ring_dev[start:start + ctx] = torch.from_numpy(
                self.feat_ring[start:start + ctx]).to(self.device)

    def _ring_indices(self) -> np.ndarray:
        """Row indices of the next window; advances the front/tail counters
        (one engine uses one of get_next_feat / get_next_feat_device)."""
        nrows = self.feat_ring.shape[0]
        if self.front < self.tail:
            idx = np.arange(self.front, self.tail)
        else:
            idx = np.concatenate([np.arange(self.front, nrows), np.arange(0, self.tail)])
        self.front = (self.front + 2) % nrows
        self.tail = (self.tail + 2) % nrows
        return idx

    def get_next_feat(self) -> np.ndarray:
        """[8, audio_dim, 16] attention stack, on the host. Each window is a
        copy: a later ring write must not change a window already taken."""
        while len(self.att_feats) < 8:
            self.att_feats.append(self.feat_ring[self._ring_indices()].T)
        out = np.stack(self.att_feats)
        self.att_feats = self.att_feats[1:]
        return out

    def get_next_feat_device(self) -> torch.Tensor:
        """get_next_feat computed on the device from the mirrored ring: only
        a [16] index vector moves per window. Each window is a snapshot taken
        at capture time, like the host list."""
        if self._ring_dev is None:
            self._ring_dev = torch.from_numpy(self.feat_ring.copy()).to(self.device)
            zero = torch.zeros(self.audio_dim, 16, device=self.device)
            self._att_dev = [zero] * len(self.att_feats)
        while len(self._att_dev) < 8:
            idx = torch.from_numpy(self._ring_indices()).to(self.device)
            self._att_dev.append(self._ring_dev.index_select(0, idx).T.contiguous())
        out = torch.stack(self._att_dev)
        self._att_dev = self._att_dev[1:]
        return out

    def warm_up(self) -> None:
        for _ in range(self.warm_up_steps):
            self.run_step()


def net_config(cfg: Config) -> NeRFNetConfig:
    nc = cfg.nerf
    return NeRFNetConfig(
        bound=nc.bound, audio_in_dim=nc.audio_in_dim, audio_dim=nc.audio_dim,
        exp_eye=nc.exp_eye, num_levels=nc.num_levels, base_resolution=nc.base_resolution,
        log2_hashmap_size=nc.log2_hashmap_size, desired_resolution=nc.desired_resolution,
        torso=nc.torso, level_dim=nc.level_dim)


class NeRFReal(BaseReal):
    """The ER-NeRF engine: network with seeded random weights (seed 0),
    fully occupied density grid, planes baked at 2× the finest hash level
    (at most 1024²), and the K2 frame step (engines/nerf_step.py)."""

    def __init__(self, cfg: Config, dataset: NeRFTestDataset,
                 custom_opts: list[dict] | None = None, device=None):
        nc = cfg.nerf
        if nc.sample_mode != "pallas":
            raise NotImplementedError(
                f"nerf.sample_mode={nc.sample_mode!r} is not ported to the PyTorch "
                "package yet (ROADMAP: 'ER-NeRF sample modes'); use 'pallas' (K2)")
        if nc.asr_model:
            raise NotImplementedError(
                f"nerf.asr_model={nc.asr_model!r}: the DeepSpeech and wav2vec "
                "featurizers are not ported yet (ROADMAP: 'ER-NeRF featurizers')")
        super().__init__(cfg, custom_opts, device=resolve_device(device))
        dev = self.device
        with self.device_scope():
            self.network = init_ernerf_(NeRFNetwork(net_config(cfg)).to(dev), 0).eval()
            self.dataset = dataset
            self.loader = iter(dataset)
            # the background is static per dataset: uploaded once
            self._bg_dev = torch.from_numpy(
                np.asarray(dataset.bg_img, np.float32).reshape(-1, 3)).to(dev)
            self.density = DensityGrid.create(nc.grid_size, device=dev)
            tables = {n: getattr(self.network, n).detach()
                      for n in ("plane_xy", "plane_yz", "plane_xz")}
            baked = bake_triplanes(
                tables, self.network.cfg.plane_spec, self.network.cfg.bound,
                resolution=min(1024, 2 * nc.desired_resolution),
                dtype=torch.bfloat16 if nc.texture_dtype == "bfloat16" else None)
            self._render_step = make_render_step(self.network, dataset, cfg, baked)
            if dev.type == "cuda":
                # prefill the span cache for the pose track and build K2 now,
                # so the live loop never waits on a probe readback or nvcc
                self._render_step.warmup(self.density)
            self.asr = NerfASR(cfg, self, fake_logits_fn(nc.audio_in_dim), device=dev)
            self.asr.warm_up()
        # frames until the next active/overflow gauge readback (see test_step)
        self._telemetry_countdown = 0

    def set_orbit_camera(self, enable: bool = True):
        raise NotImplementedError(
            "the orbit camera is not ported to the PyTorch package yet "
            "(ROADMAP: 'ER-NeRF orbit camera')")

    def test_step(self, loop=None, audio_track=None, video_track=None) -> bool:
        data = next(self.loader)
        auds = self.asr.get_next_feat_device()
        audio_frames = [self.asr.get_audio_out() for _ in range(2)]
        if self.asr.is_stale_silence(audio_frames):
            # speech is queued behind this pre-buffered idle output: drop the
            # frame and its silence so the first speech frame ships sooner
            return False
        audiotypes = []
        for frame, ftype, _seq in audio_frames:
            audiotypes.append(ftype)
            chunk = AudioChunk.from_float(frame, self.sample_rate)
            track_put(loop, audio_track, chunk)
        if (audiotypes[0] != 0 and audiotypes[1] != 0
                and self.custom_index.get(audiotypes[0]) is not None):
            atype = audiotypes[0]
            mirindex = self.mirror_index(len(self.custom_img_cycle[atype]),
                                         self.custom_index[atype])
            image = self.custom_img_cycle[atype][mirindex]
            self.custom_index[atype] += 1
        else:
            if self.asr.speech_start_ts is not None and 0 in audiotypes:
                metrics.latency("nerf.first_frame").observe(
                    time.monotonic() - self.asr.speech_start_ts)
                self.asr.speech_start_ts = None
            t0 = time.perf_counter()
            rgb, n_active, n_overflow = self._render_step(
                data["pose"], auds, data["eye"], self.density, self._bg_dev,
                pose_key=data["index"])
            rgb = rgb.cpu().numpy()
            # 1 Hz gauges: each int() is a device → host sync
            self._telemetry_countdown -= 1
            if self._telemetry_countdown <= 0:
                self._telemetry_countdown = self.fps
                metrics.gauge("nerf.active_tiles", int(n_active))
                metrics.gauge("nerf.overflow_jobs", int(n_overflow))
                # the step compacts to exactly the active tiles: none drop
                metrics.gauge("nerf.dropped_tiles", 0)
            metrics.latency("nerf.render").observe(time.perf_counter() - t0)
            metrics.rate("nerf.render_fps").tick()
            image = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
        vf = VideoImage(image=image)
        track_put(loop, video_track, vf)
        self.record_video_frame(vf)
        return True

    def render(self, quit_event, loop=None, audio_track=None, video_track=None):
        self.init_customindex()
        self.tts.render(quit_event)
        with self.device_scope():
            while not quit_event.is_set():
                for _ in range(2):
                    self.asr.run_step()
                self.test_step(loop, audio_track, video_track)
                if (video_track is not None
                        and video_track._queue.qsize() >= self.cfg.avatar.max_track_queue):
                    time.sleep(0.04 * video_track._queue.qsize() * 0.8)
