"""Checkpoint conversion CLI: reference weights, or the JAX package's orbax
directories, → a directory the port serves.

    python -m mere_fusion_tpu_torch.tools.convert_ckpt wav2lip models/wav2lip.pth out/
    python -m mere_fusion_tpu_torch.tools.convert_ckpt whisper models/whisper/tiny.pt out/
    python -m mere_fusion_tpu_torch.tools.convert_ckpt vae sd-vae-ft-mse/diffusion_pytorch_model.bin out/
    python -m mere_fusion_tpu_torch.tools.convert_ckpt musetalk-unet pytorch_model.bin out/ \\
        --unet-config musetalk.json
    python -m mere_fusion_tpu_torch.tools.convert_ckpt ernerf ngp_kf.pth out/
    python -m mere_fusion_tpu_torch.tools.convert_ckpt face-age age_model_weights.h5 out/
    python -m mere_fusion_tpu_torch.tools.convert_ckpt ernerf jax_workspace/ out/

Port of mere_fusion_tpu/tools/convert_ckpt.py, with its families and
arguments. ``input`` is one of:

- a reference torch file (``.pth``/``.pt``/``.bin``), through the port's
  utils/torch_convert.py, utils/yolo_convert.py (an ultralytics
  ``yolov10*.pt``) or convert.py's ``native_state`` (wav2lip, vae,
  musetalk-unet, whisper, whose modules carry the reference's names);
- a DeepFace Keras ``.h5`` for the ``face-*`` families (needs ``h5py``);
- the JAX package's orbax directory: a tree its converter wrote (with its
  ``family.json``), or for ``ernerf`` a training workspace
  (``NeRFTrainState``), whose EMA parameters and density grid are served.
  It is read by utils/checkpoint.py's ``restore_orbax_raw`` (needs
  ``tensorstore``, not JAX) and translated by ``convert.state_from_flax``;
- a directory this tool wrote, read back as it is.

``out_dir`` gets ``family.json`` (``family``, ``source`` and the metadata,
e.g. whisper's ``dims``, as the JAX converter writes it) and ``weights.pt``,
the weights-only state dict under the port's module names (for ``ernerf``
with the density grid as ``density.*`` entries). ``make_engine``
(avatar.ckpt, avatar.vae_ckpt, avatar.unet_ckpt, avatar.whisper_ckpt),
``nerf.ckpt``, ``ernerf_cli --head_ckpt``, ``perception --ckpt`` and
``genavatar --vae_ckpt`` serve it on any machine with PyTorch: conversion
from orbax runs on a host that has tensorstore, serving on the card.
"""
from __future__ import annotations

import argparse
import os

# the JAX CLI's choices, in its order
FAMILIES = ("wav2lip", "wav2lip-disc", "syncnet", "whisper", "vae", "musetalk-unet",
            "s3fd", "bisenet", "fan", "ernerf", "yolo", "face-age", "face-gender",
            "face-race", "face-emotion", "craft", "crnn", "rtmpose")
# families whose modules carry the reference's names (convert.native_state)
_NATIVE = ("wav2lip", "vae", "musetalk-unet", "whisper")


def convert(family: str, in_path: str, unet_config: str | None = None) -> dict:
    return convert_with_meta(family, in_path, unet_config)[0]


def convert_with_meta(family: str, in_path: str,
                      unet_config: str | None = None) -> tuple[dict, dict]:
    """(state dict under the port's module names, metadata) of ``in_path``.
    Metadata holds what the weights do not show (whisper's ``dims``), so a
    converted directory rebuilds the right model. ``unet_config`` is a
    UNetConfig JSON (musetalk-unet from orbax: the translation needs the
    UNet's layout; default UNetConfig())."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    if os.path.isdir(in_path):
        return _convert_dir(family, in_path, unet_config)
    if family.startswith("face-"):
        from mere_fusion_tpu_torch.convert import FACE_CLASSES
        from mere_fusion_tpu_torch.utils import keras_convert as kc

        n_cls = FACE_CLASSES[family]
        if n_cls is None:
            return kc.convert_emotion_h5(in_path), {}
        return kc.convert_vggface_h5(in_path, n_classes=n_cls), {}
    if family in _NATIVE:
        import torch

        from mere_fusion_tpu_torch.convert import native_state

        return native_state(family, torch.load(in_path, map_location="cpu",
                                                weights_only=True))
    if family == "yolo":
        from mere_fusion_tpu_torch.utils.yolo_convert import convert_yolo_file

        return convert_yolo_file(in_path), {}
    if family == "ernerf":
        from mere_fusion_tpu_torch.convert import density_state
        from mere_fusion_tpu_torch.engines.nerf import read_reference_pth

        state, density = read_reference_pth(in_path)
        return {**state, **(density_state(density) if density is not None else {})}, {}
    from mere_fusion_tpu_torch.utils import torch_convert as tc

    sd = tc.load_torch_checkpoint(in_path)
    if family in ("s3fd", "bisenet", "fan"):
        from mere_fusion_tpu_torch.models.bisenet import BiSeNet
        from mere_fusion_tpu_torch.models.fan import FAN
        from mere_fusion_tpu_torch.models.s3fd import S3FD

        return tc.reference_state(sd, {"s3fd": S3FD, "bisenet": BiSeNet, "fan": FAN}[family]), {}
    return {"wav2lip-disc": tc.convert_wav2lip_disc, "syncnet": tc.convert_syncnet,
            "craft": tc.convert_craft, "crnn": tc.convert_crnn,
            "rtmpose": tc.convert_rtmpose}[family](sd), {}


def _convert_dir(family: str, path: str, unet_config: str | None) -> tuple[dict, dict]:
    """A directory this tool wrote, or the JAX package's orbax directory."""
    from mere_fusion_tpu_torch.utils.checkpoint import (
        is_converted,
        load_converted,
        read_family_json,
        restore_orbax_raw,
    )

    if is_converted(path):
        state, info = load_converted(path)
    else:
        info = read_family_json(path)
        state = None
    if info.get("family", family) != family:
        raise ValueError(f"{path!r} holds {info['family']!r} weights, not {family!r}")
    meta = {k: v for k, v in info.items() if k not in ("family", "source")}
    if state is None:
        from mere_fusion_tpu_torch.convert import state_from_flax
        from mere_fusion_tpu_torch.models.musetalk.unet import UNetConfig

        ucfg = UNetConfig.from_json(unet_config) if unet_config else None
        state = state_from_flax(family, restore_orbax_raw(path), meta, unet_config=ucfg)
    return state, meta


def main(argv=None) -> None:
    p = argparse.ArgumentParser("convert-ckpt")
    p.add_argument("family", choices=FAMILIES)
    p.add_argument("input")
    p.add_argument("out_dir")
    p.add_argument("--unet-config", default=None)
    args = p.parse_args(argv)

    state, meta = convert_with_meta(args.family, args.input, args.unet_config)

    from mere_fusion_tpu_torch.utils.checkpoint import save_converted

    save_converted(args.out_dir, args.family, state, meta, args.input)
    n = sum(v.numel() for v in state.values())
    print(f"converted {args.family}: {n/1e6:.1f}M params → {args.out_dir}")


if __name__ == "__main__":
    main()
