"""Typed, layered configuration.

Replaces the reference's untyped ``opt`` argparse namespace that is threaded
through every constructor (reference: app.py:550-707, ernerf/main.py:18-124).
Here each subsystem owns a frozen dataclass; the top-level ``Config`` nests
them and supports dict/CLI overrides with dotted keys.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any


@dataclass(frozen=True)
class AudioConfig:
    """Global audio clocking. Reference: basereal.py:36, webrtc.py:10-15."""

    sample_rate: int = 16_000
    fps: int = 25                     # video frames per second

    @property
    def chunk(self) -> int:
        """Samples per 20 ms audio frame (two per video frame at 25 fps)."""
        return self.sample_rate // (self.fps * 2)

    @property
    def chunks_per_video_frame(self) -> int:
        return 2


@dataclass(frozen=True)
class StrideConfig:
    """Sliding-window featurization strides, in 20 ms audio frames.

    Reference: baseasr.py:23-26, app.py:667-670 (defaults l=10, m=8/50, r=10).
    """

    left: int = 10
    mid: int = 8
    right: int = 10


@dataclass(frozen=True)
class AvatarConfig:
    """Which avatar engine to run and its batching."""

    kind: str = "wav2lip"             # wav2lip | musetalk | ernerf
    avatar_id: str = "avator_1"
    avatar_dir: str = "./data/avatars"
    batch_size: int = 16              # frames per device dispatch
    img_size: int = 96                # face crop size (wav2lip 96, musetalk 256)
    dtype: str = "bfloat16"           # compute dtype on device
    vae_int8: str = "auto"            # int8 VAE decode (musetalk speed
                                      # tier): auto = enable when the
                                      # load-time PSNR gate passes on the
                                      # actual weights | on | off
    max_track_queue: int = 5          # render backpressure threshold (frames)
    # serving weights (reference loads these at engine start:
    # ./models/wav2lip.pth at lipreal.py:76; sd-vae + musetalk UNet + whisper
    # tiny at musetalk/utils/utils.py:18-24). Each accepts a reference torch
    # file (.pth/.pt/.bin) converted on the fly, or an orbax dir written by
    # tools/convert_ckpt. Empty = random weights (silence-path/demo mode).
    ckpt: str = ""                    # wav2lip generator weights
    vae_ckpt: str = ""                # musetalk: sd-vae-ft-mse weights
    unet_ckpt: str = ""               # musetalk: UNet weights
    unet_config: str = ""             # musetalk.json architecture (unet.py:35-37)
    whisper_ckpt: str = ""            # musetalk: whisper-tiny for MuseASR features


@dataclass(frozen=True)
class TTSConfig:
    backend: str = "edge"             # edge | sovits | cosyvoice | xtts | pyttsx3
    voice: str = "zh-CN-YunxiaNeural"
    server_url: str = "http://127.0.0.1:9880"
    ref_audio: str = ""
    ref_text: str = ""


@dataclass(frozen=True)
class ASRConfig:
    backend: str = "jax-whisper"      # jax-whisper | faster-whisper | openai-api
    model_size: str = "tiny"
    language: str = "en"              # ISO code, or "auto" (detect on the
                                      # first speech buffer, decoding.py:19)
    beam_size: int = 5                # reference default: "b5 is faster and
                                      # better than b1" (whisper_online.py:137)
    min_chunk_seconds: float = 1.0
    buffer_trim_seconds: float = 15.0
    vad: bool = False


@dataclass(frozen=True)
class PerceptionConfig:
    """Camera-frame scene understanding (reference: yolo_opencv.py:36-42,
    136-221 — YOLOv10x every 10th frame, DeepFace when a person is seen,
    EasyOCR text)."""

    backend: str = "stub"             # stub | yolo-tpu (flax) | yolo (ultralytics)
    ckpt: str = ""                    # yolov10*.pt (either backend; tpu path
                                      # extracts tensors without ultralytics)
    scale: str = "x"                  # yolo-tpu model scale (n/s/m/b/l/x)
    fps_throttle: int = 10            # analyze every Nth frame
    conf: float = 0.25                # detection confidence threshold
    face_attrs: str = ""              # "" (deepface fallback) | "random" |
                                      # "age=age.h5,gender=gender.h5,..."
                                      # (TPU VGG-Face heads, models/face_attrs)
    ocr: str = ""                     # "" (easyocr fallback) | "random" |
                                      # "craft=craft.pth,crnn=english_g2.pth"
                                      # (TPU CRAFT+CRNN reader, models/ocr)


@dataclass(frozen=True)
class TransportConfig:
    mode: str = "webrtc"              # webrtc | rtmp | rtp | loopback
    push_url: str = "http://localhost:1985/rtc/v1/publish/"
    pull_url: str = "http://localhost:1985/rtc/v1/play/"
    # --transport rtp: dependency-free RTP/UDP output (L16 audio + RFC 4175
    # video; RTCP sender reports on port+1). Reference exposes rtmp/rtcpush
    # transports (app.py:699); this is the ffmpeg/aiortc-free live leg.
    rtp_host: str = "127.0.0.1"
    rtp_audio_port: int = 5004
    rtp_video_port: int = 5006
    # webrtc: the produce (push) negotiation only starts once the consume
    # (pull) pc actually reaches connectionState "connected"; timeout tears
    # the session down (reference app.py:471-478, 15 s wait_for)
    connect_timeout: float = 15.0


@dataclass(frozen=True)
class ServerConfig:
    listen_host: str = "0.0.0.0"
    listen_port: int = 8010
    max_sessions: int = 10


@dataclass(frozen=True)
class NeRFConfig:
    """ER-NeRF model + render settings (reference: ernerf/main.py:18-124)."""

    bound: float = 1.0
    scale: float = 4.0
    offset: tuple = (0.0, 0.0, 0.0)
    grid_size: int = 128
    density_thresh: float = 10.0
    num_levels: int = 12
    base_resolution: int = 64
    desired_resolution: int = 512
    log2_hashmap_size: int = 14
    level_dim: int = 1                # features per hash level (reference network.py:123)
    audio_in_dim: int = 44            # esperanto CTC logits (29 for deepspeech)
    # live audio featurizer (reference --asr_model, app.py:596/nerfasr.py:39):
    # "" = deterministic fake (demo/silence); a *.pb path = our DeepSpeech
    # (29-dim, audio/deepspeech.py); anything else = a transformers CTC model
    # name (wav2vec2/hubert) run via FlaxWav2Vec2ForCTC on device
    asr_model: str = ""
    audio_dim: int = 32
    eye_dim: int = 1                  # AU45 blink scalar
    max_steps: int = 16               # marching steps per ray at inference
    num_rays: int = 65536
    n_candidates: int = 32            # occupancy probes per ray
    max_active_rays: int = 65536      # static ray-compaction budget (0 = off)
    # Baked-texture filtering. "pallas" = windowed two-hot MXU sampler
    # (ops/pallas_sampler): exact bilinear at ~2.5× the XLA gather rate,
    # per-ray spans from a pose-keyed cache, tile compaction. "nearest" is
    # the XLA-gather path (one gather/plane; at a 2× oversampled bake the
    # snap error is sub-texel); "bilinear" its 4-gather exact variant.
    sample_mode: str = "pallas"       # pallas | nearest | bilinear
    tile_budget: int = 1024           # active 8×8 tiles per frame (pallas;
                                      # the eager torch step compacts
                                      # exactly and does not read it)
    span_cache_poses: int = 2048      # max poses with cached spans (~1.3 MB
                                      # each at 512²); bounds warmup prefill
                                      # time and HBM. Poses past the cap
                                      # render via the uncached full-budget
                                      # path (no host sync). 0 = unlimited.
    pallas_window_u: int = 64         # texture window, contract (depth) axis
    pallas_window_v: int = 16         # texture window, lateral axis. 16
                                      # halves the per-window VPU chain and
                                      # drops the lateral mip one level
                                      # sooner: with the 2× oversampled
                                      # bake that is bilinear at the
                                      # network's NATIVE resolution — the
                                      # same error class as the accepted
                                      # nearest-path texel snap (measured
                                      # 37.6→36.0 ms dense 512²; quality
                                      # bound: test_window_v16_quality)
    pallas_depth_groups: int = 4      # depth groups per ray (even, divides K)
    # pixel tile shape per sampler job. 16×8 halves the grid-step count vs
    # 8×8 (same FLOPs, half the per-step fixed cost: measured 40.1→35.9 ms
    # on the dense 512² job set) at the price of a wider lateral footprint
    # per window — the LOD ladder absorbs it one mip sooner.
    pallas_tile_w: int = 16
    pallas_tile_h: int = 8
    texture_dtype: str = "bfloat16"   # baked-texture storage dtype
    shade_dtype: str = "bfloat16"     # head-MLP compute dtype at inference
    probe_block: int = 8              # pixels per shared occupancy probe (0 = per-ray)
    smooth_path_window: int = 7
    torso: bool = False
    exp_eye: bool = True
    pose_path: str = "data/transforms.json"
    au_path: str = "data/au.csv"
    bg_img: str = "white"
    data_range: tuple = (0, -1)       # frame range of the pose loop
    smooth_path: bool = True
    smooth_eye: bool = True           # 3-frame blink smoothing
    smooth_lips: bool = True          # EMA the audio code across frames
                                      # (serving preset, app.py:355-371)
    fix_eye: float = -1.0             # >=0 forces a constant blink area
    fullbody_imgs: str = ""           # dir of full-body frames to paste into
    fullbody_offset: tuple = (0, 0)   # (x, y) of the head crop in the body
    ckpt: str = ""                    # trained avatar: a reference .pth (ngp_kf.pth) or
                                      # an ernerf_cli workspace of ckpt-<step>.pt (its
                                      # EMA weights); empty = seeded random weights


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    lr_net: float = 1e-3
    iters: int = 200_000
    ckpt: str = "latest"
    workspace: str = "workspace"
    ema_decay: float = 0.95
    seed: int = 0
    # mesh axes for multi-chip training; product must equal device count
    mesh_dp: int = 1
    mesh_tp: int = 1


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    stride: StrideConfig = field(default_factory=StrideConfig)
    avatar: AvatarConfig = field(default_factory=AvatarConfig)
    tts: TTSConfig = field(default_factory=TTSConfig)
    asr: ASRConfig = field(default_factory=ASRConfig)
    perception: PerceptionConfig = field(default_factory=PerceptionConfig)
    transport: TransportConfig = field(default_factory=TransportConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    nerf: NeRFConfig = field(default_factory=NeRFConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def override(self, **dotted: Any) -> "Config":
        """Return a new Config with dotted-key overrides.

        ``cfg.override(**{"avatar.batch_size": 8, "tts.backend": "xtts"})``
        """
        updates: dict[str, dict[str, Any]] = {}
        for key, value in dotted.items():
            group, _, name = key.partition(".")
            if not name:
                raise KeyError(f"override key must be 'group.field', got {key!r}")
            updates.setdefault(group, {})[name] = value
        changed = {}
        for group, kv in updates.items():
            sub = getattr(self, group)
            valid = {f.name for f in fields(sub)}
            unknown = set(kv) - valid
            if unknown:
                raise KeyError(f"unknown fields {unknown} in config group {group!r}")
            changed[group] = dataclasses.replace(sub, **kv)
        return dataclasses.replace(self, **changed)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        flat = {
            f"{group}.{name}": value
            for group, kv in d.items()
            for name, value in kv.items()
        }
        return cls().override(**flat)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
