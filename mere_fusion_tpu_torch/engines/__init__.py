"""Real-time avatar engines.

Each engine owns a TTS adapter feeding 20 ms PCM chunks, an ASR feeder that
featurizes audio for its model, and device work launched on the engine's
GPU. Port of mere_fusion_tpu/engines: the MuseTalk engine (an inference
thread and a frame-assembly thread) and the ER-NeRF engine (one render
loop over kernel K2, with its live featurizer) are ported; Wav2Lip is not
yet.
"""
from __future__ import annotations

import os
import threading
import time

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


def load_serving_tree(family: str, path: str, loader=None):
    """(host state dict, metadata) for serving: a torch checkpoint
    (.pth/.pt/.bin) whose keys the port's modules carry natively, or what
    a custom ``loader(path)`` returns. Cached per path."""
    key = (family, os.path.abspath(path))
    with _TREE_LOCK:
        hit = _HOST_TREES.get(key)
        if hit is not None:
            return hit
        if loader is not None:
            tree, meta = loader(path), {}
        elif os.path.isdir(path):
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


def shared_device_tree(family: str, path: str, device=None, dtype=None, loader=None,
                       cast=None):
    """State dict on ``device`` (float32 entries cast to ``dtype`` when
    given, only those for which ``cast(tensor)`` holds when that is given),
    shared by every session placed on that device. ``loader`` as in
    load_serving_tree; its arrays may be numpy."""
    key = (family, os.path.abspath(path), str(device), str(dtype))
    with _TREE_LOCK:
        tree = _DEVICE_TREES.get(key)
        if tree is not None:
            return tree
        tree, _ = load_serving_tree(family, path, loader)
        out = {}
        for k, v in tree.items():
            v = torch.as_tensor(v)
            to = (dtype if dtype is not None and v.dtype == torch.float32
                  and (cast is None or cast(v)) else v.dtype)
            out[k] = v.to(device=device, dtype=to)
        _DEVICE_TREES[key] = out
        return out


def make_nerf_featurizer(asr_model: str, device=None, audio_in_dim: int | None = None):
    """(logits_fn, device_logits_fn or None) for the ER-NeRF live featurizer
    named by ``asr_model`` (reference --asr_model, app.py:596): a DeepSpeech
    frozen graph (.pb), or a local directory of a transformers CTC model,
    which runs on ``device`` and returns host logits (no device form).

    A graph's weights live on ``device`` once per (graph, device), the 2-D
    ones in bf16, shared by both forms and every session there: both live
    forms run bf16 products (float32 sums and gate math), so the feature
    ring never mixes precisions. Offline training features
    (``deepspeech_logits_fn`` with its defaults) stay float32. Raises
    ValueError when the logits are not ``audio_in_dim`` wide."""
    from mere_fusion_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if asr_model.endswith(".pb"):
        from mere_fusion_tpu_torch.audio import deepspeech

        params = shared_device_tree(
            "deepspeech", asr_model, device, dtype=torch.bfloat16,
            loader=lambda p: deepspeech.params_from_graph(deepspeech.read_graph_constants(p)),
            cast=lambda t: t.ndim == 2)
        fns = (deepspeech.deepspeech_logits_fn(params=params, device=device,
                                               compute_dtype="bfloat16"),
               deepspeech.deepspeech_logits_fn(params=params, device=device,
                                               return_device=True))
    else:
        from mere_fusion_tpu_torch.engines.nerf import wav2vec_logits_fn

        fns = (wav2vec_logits_fn(asr_model, device), None)
    width = fns[0].width
    if audio_in_dim is not None and width != audio_in_dim:
        raise ValueError(f"nerf.asr_model {asr_model!r} gives {width}-wide logits but "
                         f"nerf.audio_in_dim is {audio_in_dim}: set nerf.audio_in_dim="
                         f"{width} (the avatar's audio net must be trained on them)")
    return fns


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
        if "logits_fn" not in kw and nc.asr_model:
            from mere_fusion_tpu_torch.runtime.metrics import metrics

            t0 = time.perf_counter()
            kw["logits_fn"], kw["device_logits_fn"] = make_nerf_featurizer(
                nc.asr_model, kw["device"], nc.audio_in_dim)
            metrics.latency("nerf.build.featurizer").observe(time.perf_counter() - t0)
        if "dataset" not in kw:
            kw["dataset"] = NeRFTestDataset.load(
                nc.pose_path, nc.au_path, bg_img=nc.bg_img, scale=nc.scale,
                offset=tuple(nc.offset), smooth_path=nc.smooth_path,
                smooth_path_window=nc.smooth_path_window, smooth_eye=nc.smooth_eye,
                data_range=tuple(nc.data_range))
        if nc.fix_eye >= 0:
            kw["dataset"].eye_area[:] = nc.fix_eye
        if nc.ckpt:
            from mere_fusion_tpu_torch.engines.nerf import load_nerf_checkpoint
            from mere_fusion_tpu_torch.runtime.metrics import metrics

            t0 = time.perf_counter()
            kw["state"], density = load_nerf_checkpoint(cfg)
            metrics.latency("nerf.build.load").observe(time.perf_counter() - t0)
            if density is not None:
                kw["density"] = density
        if nc.fullbody_imgs and "fullbody_frames" not in kw:
            from mere_fusion_tpu_torch.engines.base import _sorted_imgs, read_imgs

            frames = read_imgs(_sorted_imgs(nc.fullbody_imgs))
            if not frames:
                raise ValueError(f"nerf.fullbody_imgs {nc.fullbody_imgs!r} holds no images")
            kw["fullbody_frames"] = frames
            kw["fullbody_offset"] = tuple(nc.fullbody_offset)
        return NeRFReal(cfg, **kw)
    raise ValueError(f"unknown avatar kind {kind!r}")
