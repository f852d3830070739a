"""Real-time avatar engines.

Each engine owns a TTS adapter feeding 20 ms PCM chunks, an ASR feeder that
featurizes audio for its model, and device work launched on the engine's
GPU. Port of mere_fusion_tpu/engines: the MuseTalk engine (an inference
thread and a frame-assembly thread) and the ER-NeRF engine (one render
loop over kernel K2) are ported; Wav2Lip is not yet.
"""
from __future__ import annotations

import os
import threading

import torch

from mere_fusion_tpu_torch.config import Config

# serving-weight caches. Host state dicts are cached per file so N sessions
# pay one torch.load; device state dicts are cached per (file, device,
# dtype), so same-device sessions share one copy of the weights in device
# memory. Entries live for the process. The lock serializes loads: session
# starts run make_engine on executor threads.
_HOST_TREES: dict = {}
_DEVICE_TREES: dict = {}
_TREE_LOCK = threading.RLock()

_TORCH_SUFFIXES = (".pth", ".pt", ".bin")

# legacy diffusers VAE attention names → the current ones the port uses
_LEGACY_VAE_ATTN = {".query.": ".to_q.", ".key.": ".to_k.", ".value.": ".to_v.",
                    ".proj_attn.": ".to_out.0."}


def _native_state(family: str, raw) -> tuple[dict, dict]:
    """(state dict under the port's module names, metadata) from a loaded
    torch checkpoint of ``family``."""
    if family == "whisper":
        # OpenAI whisper .pt: {"dims": ..., "model_state_dict": ...}; the
        # feature extractor needs the encoder only
        sd = raw.get("model_state_dict", raw)
        enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
        return enc, {"dims": raw.get("dims")}
    sd = raw.get("state_dict", raw)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    if family == "vae":
        renamed = {}
        for k, v in sd.items():
            if ".mid_block.attentions." in k:
                for old, new in _LEGACY_VAE_ATTN.items():
                    k = k.replace(old, new)
            renamed[k] = v
        sd = renamed
    return sd, {}


def load_serving_tree(family: str, path: str):
    """(host state dict, metadata) for serving: a torch checkpoint
    (.pth/.pt/.bin) whose keys the port's modules carry natively. Cached
    per path."""
    key = (family, os.path.abspath(path))
    with _TREE_LOCK:
        hit = _HOST_TREES.get(key)
        if hit is not None:
            return hit
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path!r} is an orbax directory; the PyTorch package loads "
                "torch checkpoints only (ROADMAP: 'Checkpoints' — "
                "utils/checkpoint.py and tools/convert_ckpt.py)")
        elif path.endswith(_TORCH_SUFFIXES):
            tree, meta = _native_state(
                family, torch.load(path, map_location="cpu", weights_only=True))
        else:
            raise ValueError(f"serving checkpoint {path!r} is not a torch file "
                             f"({'/'.join(_TORCH_SUFFIXES)})")
        _HOST_TREES[key] = (tree, meta)
        return tree, meta


def shared_device_tree(family: str, path: str, device=None, dtype=None):
    """State dict on ``device`` (float32 entries cast to ``dtype`` when
    given), shared by every session placed on that device."""
    key = (family, os.path.abspath(path), str(device), str(dtype))
    with _TREE_LOCK:
        tree = _DEVICE_TREES.get(key)
        if tree is not None:
            return tree
        tree, _ = load_serving_tree(family, path)
        tree = {k: v.to(device=device,
                        dtype=dtype if dtype is not None and v.dtype == torch.float32
                        else v.dtype)
                for k, v in tree.items()}
        _DEVICE_TREES[key] = tree
        return tree


def make_engine(cfg: Config, **kw):
    """Engine factory keyed by cfg.avatar.kind. ``device=`` (threaded in by
    the SessionManager's placement) is forwarded to the engine, whose
    weights live there."""
    kind = cfg.avatar.kind
    ac = cfg.avatar
    if kind == "musetalk":
        from mere_fusion_tpu_torch.device import parse_dtype, resolve_device
        from mere_fusion_tpu_torch.engines.muse import MuseModels, MuseReal

        device = resolve_device(kw.get("device"))
        kw["device"] = device
        dtype = parse_dtype(ac.dtype)
        cast = dtype if dtype != torch.float32 else None
        if "models" not in kw and (ac.vae_ckpt or ac.unet_ckpt):
            if not (ac.vae_ckpt and ac.unet_ckpt):
                raise ValueError("musetalk serving needs BOTH avatar.vae_ckpt "
                                 "and avatar.unet_ckpt")
            from mere_fusion_tpu_torch.models.musetalk import UNetConfig

            unet_cfg = UNetConfig.from_json(ac.unet_config) if ac.unet_config else None
            kw["models"] = MuseModels(
                vae_cfg=kw.pop("vae_cfg", None),
                unet_cfg=unet_cfg,
                vae_state=shared_device_tree("vae", ac.vae_ckpt, device, cast),
                unet_state=shared_device_tree("musetalk-unet", ac.unet_ckpt, device, cast),
                face_size=kw.pop("face_size", 256),
                dtype=dtype, device=device, vae_int8=ac.vae_int8,
            )
        if "feature_extractor" not in kw and ac.whisper_ckpt:
            from mere_fusion_tpu_torch.audio.features import WhisperFeatureExtractor
            from mere_fusion_tpu_torch.models.whisper import TINY, WhisperDims

            _, meta = load_serving_tree("whisper", ac.whisper_ckpt)
            fields = WhisperDims.__dataclass_fields__
            dims = (WhisperDims(**{k: v for k, v in meta["dims"].items() if k in fields})
                    if meta.get("dims") else TINY)
            kw["feature_extractor"] = WhisperFeatureExtractor(
                shared_device_tree("whisper", ac.whisper_ckpt, device), dims,
                device=device)
        return MuseReal(cfg, **kw)
    if kind == "wav2lip":
        raise NotImplementedError(
            "the wav2lip engine is not ported to the PyTorch package yet "
            "(ROADMAP: 'Wav2Lip session')")
    if kind == "ernerf":
        from mere_fusion_tpu_torch.data.provider import NeRFTestDataset
        from mere_fusion_tpu_torch.device import resolve_device
        from mere_fusion_tpu_torch.engines.nerf import NeRFReal

        nc = cfg.nerf
        kw["device"] = resolve_device(kw.get("device"))
        if nc.ckpt:
            raise NotImplementedError(
                "ER-NeRF checkpoint loading (load_nerf_checkpoint) is not ported "
                "to the PyTorch package yet (ROADMAP: 'ER-NeRF checkpoints')")
        if nc.fullbody_imgs:
            raise NotImplementedError(
                "the ER-NeRF fullbody paste is not ported to the PyTorch package "
                "yet (ROADMAP: 'ER-NeRF fullbody')")
        if "dataset" not in kw:
            kw["dataset"] = NeRFTestDataset.load(
                nc.pose_path, nc.au_path, bg_img=nc.bg_img, scale=nc.scale,
                offset=tuple(nc.offset), smooth_path=nc.smooth_path,
                smooth_path_window=nc.smooth_path_window, smooth_eye=nc.smooth_eye,
                data_range=tuple(nc.data_range))
        if nc.fix_eye >= 0:
            kw["dataset"].eye_area[:] = nc.fix_eye
        return NeRFReal(cfg, **kw)
    raise ValueError(f"unknown avatar kind {kind!r}")
