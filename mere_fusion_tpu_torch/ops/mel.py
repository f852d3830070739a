"""Mel-spectrogram front-ends in PyTorch.

Port of mere_fusion_tpu/ops/mel.py: framing with a reflect pad, a windowed
real DFT as two products against precomputed cos/sin matrices, and a mel
projection. The DFT and the mel projection run in float64 on the device, so
no TF32 setting of the process can reach them and the result is at least
true float32 (the JAX twin runs them at Precision.HIGHEST).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 16_000
    n_fft: int = 800
    hop: int = 200
    win: int = 800
    n_mels: int = 80
    fmin: float = 55.0
    fmax: float = 7600.0
    power: float = 1.0            # 1 = magnitude (wav2lip), 2 = power (whisper)
    preemph: float | None = 0.97  # None disables
    drop_last_frame: bool = False # whisper drops the final STFT column
    log_style: str = "db_norm"    # "db_norm" (wav2lip) | "log10" (whisper)
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    max_abs_value: float = 4.0


WAV2LIP_MEL = MelConfig()

WHISPER_MEL = MelConfig(
    n_fft=400,
    hop=160,
    win=400,
    fmin=0.0,
    fmax=8000.0,
    power=2.0,
    preemph=None,
    drop_last_frame=True,
    log_style="log10",
)

WHISPER_MEL_128 = dataclasses.replace(WHISPER_MEL, n_mels=128)


def whisper_mel_config(n_mels: int) -> MelConfig:
    """Whisper log-mel config for a checkpoint's dims.n_mels (80 for
    tiny…large-v2, 128 for large-v3)."""
    if n_mels == 80:
        return WHISPER_MEL
    if n_mels == 128:
        return WHISPER_MEL_128
    return dataclasses.replace(WHISPER_MEL, n_mels=n_mels)


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa default, htk=False)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = mels * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape [n_mels, n_bins]."""
    n_bins = cfg.n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, cfg.sample_rate / 2, n_bins)
    mel_pts = np.linspace(_hz_to_mel(cfg.fmin), _hz_to_mel(cfg.fmax), cfg.n_mels + 2)
    mel_f = _mel_to_hz(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : cfg.n_mels + 2] - mel_f[: cfg.n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_window_matrices(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT matrices [n_fft, n_bins] for the cos and -sin
    parts, with the periodic hann window folded in (float32 values, as in
    the JAX twin)."""
    n = cfg.n_fft
    n_bins = n // 2 + 1
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(cfg.win) / cfg.win)
    if cfg.win < n:  # center-pad window to n_fft (librosa semantics)
        pad = (n - cfg.win) // 2
        window = np.pad(window, (pad, n - cfg.win - pad))
    angle = 2.0 * np.pi * (np.arange(n)[:, None] * np.arange(n_bins)[None, :]) / n
    cos_m = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_m = (-np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_m, sin_m


def num_mel_frames(n_samples: int, cfg: MelConfig) -> int:
    """Frames produced for an input of n_samples (center-padded STFT)."""
    frames = 1 + n_samples // cfg.hop
    return frames - 1 if cfg.drop_last_frame else frames


def melspectrogram(wav: torch.Tensor, cfg: MelConfig = WAV2LIP_MEL) -> torch.Tensor:
    """Mel spectrogram [..., n_mels, n_frames] (float32) of PCM [..., N] in
    [-1, 1] at cfg.sample_rate, on the tensor's device; each row of a batch
    is its own signal (its own padding and, for log10, its own floor)."""
    x = wav.to(torch.float32)
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if cfg.preemph is not None:
        # y[n] = x[n] - k x[n-1], y[0] = x[0] (scipy lfilter([1,-k],[1]))
        x = torch.cat([x[:, :1], x[:, 1:] - cfg.preemph * x[:, :-1]], 1)
    pad = cfg.n_fft // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, cfg.n_fft, cfg.hop).to(torch.float64)   # [R, T, n_fft]

    cos_m, sin_m = _dft_window_matrices(cfg)
    f64 = dict(device=x.device, dtype=torch.float64)
    re = frames @ torch.as_tensor(cos_m, **f64)
    im = frames @ torch.as_tensor(sin_m, **f64)
    power = re * re + im * im                                     # [R, T, n_bins]
    if cfg.drop_last_frame:
        power = power[:, :-1]
    spec = torch.sqrt(power.clamp_min(0.0)) if cfg.power == 1.0 else power
    fb = torch.as_tensor(mel_filterbank(cfg), **f64)
    mel = (spec @ fb.T).transpose(1, 2).to(torch.float32)         # [R, n_mels, T]

    if cfg.log_style == "db_norm":
        min_level = float(np.exp(cfg.min_level_db / 20.0 * np.log(10.0)))
        db = 20.0 * torch.log10(mel.clamp_min(min_level)) - cfg.ref_level_db
        v = cfg.max_abs_value
        out = torch.clamp(
            2.0 * v * ((db - cfg.min_level_db) / (-cfg.min_level_db)) - v, -v, v)
        return out.reshape(*lead, *out.shape[1:])
    if cfg.log_style == "log10":
        log_spec = torch.log10(mel.clamp_min(1e-10))
        log_spec = torch.maximum(log_spec, log_spec.amax((1, 2), keepdim=True) - 8.0)
        out = (log_spec + 4.0) / 4.0
        return out.reshape(*lead, *out.shape[1:])
    raise ValueError(f"unknown log_style {cfg.log_style!r}")
