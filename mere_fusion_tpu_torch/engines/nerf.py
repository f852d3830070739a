"""ER-NeRF real-time engine on the GPU.

Port of mere_fusion_tpu/engines/nerf.py (the twin of the reference's
nerfreal.py/nerfasr.py) on its default serving path: a render loop that runs
two 20 ms ASR steps per video frame, pulls the looped camera pose, feeds the
live audio features through a circular feature ring with an 8-window
attention context, and renders the talking head through the K2 frame step
(engines/nerf_step.py) from triplanes baked at construction.

The featurizer is the deterministic fake (``nerf.asr_model = ""``), the
DeepSpeech net of a frozen graph (a ``.pb``, audio/deepspeech.py; its bf16
device form flushes its logits straight into the device feature ring) or a
local transformers CTC model (``wav2vec_logits_fn``); ``make_engine``
builds it. ``NeRFReal`` renders with ``nerf.sample_mode`` "pallas" (the K2
step) or "nearest"/"bilinear" (the baked-texture step,
engines/nerf_baked.py), or with ``bake_planes=False`` the unbaked per-frame
hash-encode step (engines/nerf_baked.py, kernel K3), on random weights from
a fixed seed or on a trained avatar that ``load_nerf_checkpoint`` reads
(``nerf.ckpt``: a reference ``.pth``, the port's training workspace, a
directory that tools/convert_ckpt.py wrote, or the JAX package's orbax
directory: a converted tree or a training workspace), with the torso net
when ``nerf.torso`` is set, from the dataset's camera path or a free orbit
camera (engines/orbit.py), pasted into full-body frames when given.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import cv2
import numpy as np
import torch

from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.convert import ernerf_from_flax, individual_code_sizes, split_density
from mere_fusion_tpu_torch.data.provider import NeRFTestDataset
from mere_fusion_tpu_torch.device import resolve_device
from mere_fusion_tpu_torch.engines.base import BaseReal, track_put
from mere_fusion_tpu_torch.engines.base_asr import BaseASR
from mere_fusion_tpu_torch.engines.nerf_baked import (
    make_baked_render_step,
    make_unbaked_render_step,
)
from mere_fusion_tpu_torch.engines.nerf_step import make_render_step
from mere_fusion_tpu_torch.models.ernerf.network import (
    TORSO_PARAMS,
    NeRFNetConfig,
    NeRFNetwork,
    init_ernerf_,
    is_torso_param,
)
from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
from mere_fusion_tpu_torch.ops.triplane_bake import bake_triplanes
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.transport.frames import AudioChunk, VideoImage
from mere_fusion_tpu_torch.utils.checkpoint import Checkpointer
from mere_fusion_tpu_torch.utils.torch_convert import (
    convert_ernerf,
    density_from_ernerf,
    load_torch_checkpoint,
    strip_prefix,
)


def fake_logits_fn(audio_dim: int) -> Callable[[np.ndarray], np.ndarray]:
    """Deterministic energy-based CTC-logit stand-in: one row per 20 ms frame."""

    def fn(audio: np.ndarray) -> np.ndarray:
        frames = audio.reshape(-1, 320)
        energy = np.sqrt((frames**2).mean(axis=1, keepdims=True))
        base = np.linspace(0, 1, audio_dim, dtype=np.float32)[None]
        return (energy * base).astype(np.float32)[:-1]  # T-1 rows like wav2vec

    return fn


def wav2vec_logits_fn(model_dir: str, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """A transformers CTC model (wav2vec2, HuBERT) as the featurizer
    (reference nerfasr.py:39-45, 128-143): fn(pcm_float32_16k) → [T,
    vocab] logits on the host. The model and its processor load from a
    local directory only; the model runs on ``device`` (None: the current
    CUDA device). ``fn.width`` is the logit width."""
    try:
        from transformers import AutoModelForCTC, AutoProcessor
    except ImportError as e:
        raise ImportError(f"nerf.asr_model={model_dir!r} names a transformers CTC model, "
                          "and the 'transformers' package is not installed") from e
    dev = resolve_device(device)
    processor = AutoProcessor.from_pretrained(model_dir, local_files_only=True)
    model = AutoModelForCTC.from_pretrained(model_dir, local_files_only=True).to(dev).eval()

    @torch.no_grad()
    def fn(audio: np.ndarray) -> np.ndarray:
        inputs = processor(audio, sampling_rate=16000, return_tensors="pt", padding=True)
        return model(inputs.input_values.to(dev)).logits[0].float().cpu().numpy()

    fn.width = model.config.vocab_size
    return fn


class NerfASR(BaseASR):
    """Sliding-window CTC featurizer with a circular feature ring.

    Feature ring: [4 × context] rows of [audio_dim]; per step one 20 ms frame
    is consumed and, once l+m+r frames accumulate, the middle m logit rows
    are written to the ring. get_next_feat returns an [8, audio_dim, 16]
    attention stack (att > 0) or one [1, audio_dim, 16] window (att = 0),
    advancing 2 rows (one video frame) per call.

    device_logits_fn: logits_fn's twin returning a tensor on ``device``.
    Once the device ring is live (the first get_next_feat_device), each
    flush writes its rows straight into the device ring with no host
    readback, and the host ring goes stale.
    """

    def __init__(self, cfg: Config, parent, logits_fn: Callable, att: int = 2,
                 device_logits_fn: Optional[Callable] = None, device=None):
        super().__init__(cfg, parent)
        self.audio_dim = cfg.nerf.audio_in_dim
        self.context_size = cfg.stride.mid
        self.logits_fn = logits_fn
        self.device_logits_fn = device_logits_fn
        self.att = att
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
        self._host_ring_stale = False

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
        ctx, left = self.context_size, self.stride_left_size
        if self._ring_dev is not None and self.device_logits_fn is not None:
            # the logits stay on the device and slide into the ring there
            feats = self.device_logits_fn(audio)[left:left + ctx]
            self._ring_dev[start:start + feats.shape[0]] = feats.float()
            self._host_ring_stale = True
            return
        logits = self.logits_fn(audio)  # [T, audio_dim]
        feats = logits[left:left + ctx]
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
        """[8, audio_dim, 16] attention stack (att > 0) or [1, audio_dim, 16]
        (att = 0), on the host. Each window is a copy: a later ring write
        must not change a window already taken."""
        if self._host_ring_stale:
            raise RuntimeError(
                "host feature ring is stale: this NerfASR flushes features "
                "device-side (device_logits_fn); use get_next_feat_device()")
        if self.att == 0:
            return self.feat_ring[self._ring_indices()].T[None]
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


def net_config(cfg: Config, state: dict | None = None) -> NeRFNetConfig:
    """The network of ``cfg.nerf``; given a loaded state (parameter name →
    tensor), its individual-code tables size the codes (none when absent)."""
    nc = cfg.nerf
    net = NeRFNetConfig(
        bound=nc.bound, audio_in_dim=nc.audio_in_dim, audio_dim=nc.audio_dim,
        exp_eye=nc.exp_eye, num_levels=nc.num_levels, base_resolution=nc.base_resolution,
        log2_hashmap_size=nc.log2_hashmap_size, desired_resolution=nc.desired_resolution,
        torso=nc.torso, level_dim=nc.level_dim)
    if state is None:
        return net
    return dataclasses.replace(net, **individual_code_sizes(state))


def load_nerf_checkpoint(cfg: Config) -> tuple[dict, DensityGrid | None]:
    """The serving weights named by ``cfg.nerf.ckpt``, on the CPU.

    ``*.pth``: a reference Trainer checkpoint (``ngp_kf.pth``): its ``model``
    state dict (``state_dict``-wrapped or ``module.``-prefixed keys too)
    through ``convert_ernerf`` and ``convert.ernerf_from_flax``, and its
    Morton-order density grid with the top-level ``mean_density``. A
    directory of the port's ``ckpt-<step>.pt`` (``ernerf_cli``'s workspace;
    the newest step) or one such file: its EMA parameters and its density
    grid, as the JAX package serves a training state's EMA. Any other
    directory is read by ``tools.convert_ckpt.convert``: a directory that
    tools/convert_ckpt.py wrote (family ``ernerf``), or the JAX package's
    orbax directory, either its converter's tree or its training
    workspace, whose EMA parameters and density grid are served
    (``convert.split_checkpoint_tree``). Reading orbax needs ``tensorstore``;
    without it an ImportError names it. A file of any other kind raises
    ValueError.

    Returns (the port's network state dict, DensityGrid or None). Raises
    ValueError when the hash tables, ``audio_in_dim`` or the density grid do
    not fit the ``nerf.*`` fields, or when ``nerf.torso`` is set and the
    checkpoint has no torso; with ``nerf.torso`` unset a torso checkpoint
    serves its head."""
    nc = cfg.nerf
    path = nc.ckpt
    if path.endswith(".pth"):
        state, density = read_reference_pth(path, nc.grid_size, nc.density_thresh)
    elif os.path.isdir(path) and not Checkpointer(path).steps():
        from mere_fusion_tpu_torch.tools.convert_ckpt import convert

        state, density = split_density(convert("ernerf", path))
    else:
        if os.path.isdir(path):
            raw = Checkpointer(path).restore(map_location="cpu")
        elif os.path.isfile(path) and os.path.basename(path).startswith("ckpt-"):
            raw = torch.load(path, map_location="cpu", weights_only=True)["state"]
        else:
            raise ValueError(
                f"nerf.ckpt {path!r} is neither a reference .pth, a ckpt-<step>.pt of the "
                "port's workspace nor a directory")
        state = {k: v.float() for k, v in raw["ema"].items()}
        density = DensityGrid(**raw["density"])

    spec = net_config(cfg).plane_spec
    got = tuple(state["plane_xy"].shape)
    want = (spec.total_params, nc.level_dim)
    if got != want:
        raise ValueError(
            f"checkpoint hash tables are {got} but the serving config expects {want}: "
            "pass the training run's --num_levels/--base_resolution/--desired_resolution/"
            "--log2_hashmap_size via the matching nerf.* fields")
    aud_in = state["audio_net.conv_0.weight"].shape[1]
    if aud_in != nc.audio_in_dim:
        raise ValueError(f"checkpoint audio_in_dim {aud_in} != nerf.audio_in_dim "
                         f"{nc.audio_in_dim}")
    if density is not None and density.grid.numel() != nc.grid_size ** 3:
        raise ValueError(f"checkpoint density grid has {density.grid.numel()} cells but "
                         f"nerf.grid_size={nc.grid_size} expects {nc.grid_size ** 3}")
    if nc.torso:
        # every torso parameter but its codes, which appear only when trained
        found = {n.split(".")[0] for n in state}
        missing = sorted(TORSO_PARAMS - {"individual_codes_torso"} - found)
        if missing:
            raise ValueError(f"nerf.torso is set but checkpoint {path!r} has no torso "
                             f"parameters {missing}: pass a workspace of the torso stage "
                             "(ernerf_cli --torso) or unset nerf.torso")
    else:
        state = {k: v for k, v in state.items() if not is_torso_param(k)}
    return state, density


def read_reference_pth(path: str, grid_size: int | None = None,
                       density_thresh: float = 10.0) -> tuple[dict, DensityGrid | None]:
    """(the port's network state dict, DensityGrid or None) of a reference
    Trainer checkpoint (``ngp_kf.pth``): its ``model`` state dict
    (``state_dict``-wrapped or ``module.``-prefixed keys too) through
    ``convert_ernerf`` and ``convert.ernerf_from_flax``, and its Morton-order
    density grid with the top-level ``mean_density``, of ``grid_size``³
    cells (None: the cube its cells make)."""
    top = load_torch_checkpoint(path)
    model = top.get("model", top)
    model = strip_prefix(model.get("state_dict", model))
    state = ernerf_from_flax(convert_ernerf(model))
    if "density_grid" not in model:
        return state, None
    if grid_size is None:
        grid_size = round(np.shape(model["density_grid"])[-1] ** (1 / 3))
    return state, density_from_ernerf(model, grid_size, density_thresh,
                                      mean_density=top.get("mean_density"))


class NeRFReal(BaseReal):
    """The ER-NeRF engine: the network with the given weights (``state``,
    a state dict as ``load_nerf_checkpoint`` returns it) or seeded random
    ones (seed 0), the given density grid or a fully occupied one, planes
    baked at 2× the finest hash level (at most 1024²), and the frame step of
    ``nerf.sample_mode``: K2's (engines/nerf_step.py) for "pallas", the
    baked-texture step (engines/nerf_baked.py) for "nearest" and
    "bilinear". With ``bake_planes=False`` nothing is baked and every mode
    renders through the unbaked step (engines/nerf_baked.py), which
    hash-encodes each frame's samples. The build's seconds go to the
    latency meters ``nerf.build.bake`` and ``nerf.build.prefill``.

    logits_fn, device_logits_fn: the featurizer and its device form (see
    NerfASR; ``make_nerf_featurizer`` builds them for ``nerf.asr_model``),
    the fake when ``nerf.asr_model`` is empty. fullbody_frames: BGR frames
    the rendered head is pasted into at fullbody_offset (x, y), one a
    frame in the pose track's order."""

    def __init__(self, cfg: Config, dataset: NeRFTestDataset,
                 custom_opts: list[dict] | None = None, device=None,
                 bake_planes: bool = True, state: dict | None = None,
                 density: DensityGrid | None = None,
                 logits_fn: Callable | None = None,
                 device_logits_fn: Callable | None = None,
                 fullbody_frames: list | None = None, fullbody_offset=(0, 0)):
        nc = cfg.nerf
        if nc.sample_mode not in ("pallas", "nearest", "bilinear"):
            raise ValueError(f"nerf.sample_mode {nc.sample_mode!r} is not 'pallas', "
                             "'nearest' or 'bilinear'")
        if logits_fn is None and nc.asr_model:
            raise ValueError(f"nerf.asr_model={nc.asr_model!r} needs its featurizer: pass "
                             "logits_fn from make_nerf_featurizer (make_engine does)")
        super().__init__(cfg, custom_opts, device=resolve_device(device))
        dev = self.device
        with self.device_scope():
            if state is None:
                self.network = init_ernerf_(NeRFNetwork(net_config(cfg)).to(dev), 0)
            else:
                self.network = NeRFNetwork(net_config(cfg, state)).to(dev)
                self.network.load_state_dict(state, strict=True)
            self.network.eval()
            self.dataset = dataset
            self.loader = iter(dataset)
            # the background is static per dataset: uploaded once
            self._bg_dev = torch.from_numpy(
                np.asarray(dataset.bg_img, np.float32).reshape(-1, 3)).to(dev)
            # made once: the K2 step's span cache keys on this grid's occupancy
            self.density = (DensityGrid.create(nc.grid_size, device=dev) if density is None
                            else DensityGrid(grid=density.grid.to(dev),
                                             occupancy=density.occupancy.to(dev),
                                             mean_density=density.mean_density.to(dev)))
            t0 = self._clock()
            if bake_planes:
                tables = {n: getattr(self.network, n).detach()
                          for n in ("plane_xy", "plane_yz", "plane_xz")}
                baked = bake_triplanes(
                    tables, self.network.cfg.plane_spec, self.network.cfg.bound,
                    resolution=min(1024, 2 * nc.desired_resolution),
                    dtype=torch.bfloat16 if nc.texture_dtype == "bfloat16" else None)
                make_step = (make_render_step if nc.sample_mode == "pallas"
                             else make_baked_render_step)
                self._render_step = make_step(self.network, dataset, cfg, baked)
            else:
                self._render_step = make_unbaked_render_step(self.network, dataset, cfg)
            t1 = self._clock()
            if dev.type == "cuda":
                # K2's step prefills the span and torso caches for the pose
                # track and builds K2 now, the unbaked step builds K3, so the
                # live loop never waits on a probe readback, a torso pass or
                # nvcc (the baked step has nothing to prefill)
                self._render_step.warmup(self.density, self._bg_dev)
            metrics.latency("nerf.build.bake").observe(t1 - t0)
            metrics.latency("nerf.build.prefill").observe(self._clock() - t1)
            self.asr = NerfASR(cfg, self, logits_fn or fake_logits_fn(nc.audio_in_dim),
                               device_logits_fn=device_logits_fn, device=dev)
            self.asr.warm_up()
        self.fullbody_frames = fullbody_frames
        self.fullbody_offset = tuple(fullbody_offset)
        # the free camera (engines/orbit.py); None follows the dataset's path
        self.orbit = None
        # frames until the next active/overflow gauge readback (see test_step)
        self._telemetry_countdown = 0

    def _clock(self) -> float:
        """Host seconds once the device's queued work is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def set_orbit_camera(self, enable: bool = True):
        """Toggle the free orbit camera. Returns the OrbitCamera (None when
        disabled); move it with orbit/scale/pan between frames. It adopts
        the dataset's first pose as the JAX package's does: that rotation,
        at the pose's position mirrored through the origin (ROADMAP §3)."""
        if not enable:
            self.orbit = None
            return None
        if self.orbit is None:
            from mere_fusion_tpu_torch.engines.orbit import OrbitCamera

            cam = OrbitCamera(self.dataset.W, self.dataset.H)
            cam.update_pose(np.asarray(self.dataset.poses[0]))
            self.orbit = cam
        return self.orbit

    def test_step(self, loop=None, audio_track=None, video_track=None) -> bool:
        data = next(self.loader)
        # the dataset's pose is a key of the step's span and torso caches;
        # an orbit pose is planned, and its torso drawn, live
        pose, pose_key = data["pose"], data["index"]
        if self.orbit is not None:
            pose, pose_key = self.orbit.pose, None
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
            self.record_audio_chunk(chunk)
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
                pose, auds, data["eye"], self.density, self._bg_dev, pose_key=pose_key)
            rgb = rgb.cpu().numpy()
            # 1 Hz gauges of K2's tiles (the baked step has none): each int()
            # is a device → host sync
            self._telemetry_countdown -= 1
            if n_active is not None and self._telemetry_countdown <= 0:
                self._telemetry_countdown = self.fps
                metrics.gauge("nerf.active_tiles", int(n_active))
                metrics.gauge("nerf.overflow_jobs", int(n_overflow))
                # the step compacts to exactly the active tiles: none drop
                metrics.gauge("nerf.dropped_tiles", 0)
            metrics.latency("nerf.render").observe(time.perf_counter() - t0)
            metrics.rate("nerf.render_fps").tick()
            image = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
            if self.fullbody_frames is not None:
                full = self.fullbody_frames[data["index"] % len(self.fullbody_frames)].copy()
                ox, oy = self.fullbody_offset
                full[oy:oy + image.shape[0], ox:ox + image.shape[1]] = image
                image = full
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
