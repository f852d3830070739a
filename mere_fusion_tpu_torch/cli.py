"""Server CLI: flag surface mapped onto the typed Config.

Port of mere_fusion_tpu/cli.py for the slices the PyTorch package carries:

    python -m mere_fusion_tpu_torch.cli --avatar_ckpt models/wav2lip.pth \\
        --tts procedural --transport loopback
    python -m mere_fusion_tpu_torch.cli --model musetalk --tts procedural \\
        --transport loopback
    python -m mere_fusion_tpu_torch.cli --model ernerf --pose data/transforms.json \\
        --au data/au.csv --tts procedural --transport loopback

Sessions are placed on the host's CUDA devices; ``--device cpu`` runs them
on the CPU instead.
"""
from __future__ import annotations

import argparse
import json

from mere_fusion_tpu_torch.config import Config

_FLAG_TO_KEY = {
    "fps": "audio.fps",
    "l": "stride.left",
    "m": "stride.mid",
    "r": "stride.right",
    "model": "avatar.kind",
    "avatar_id": "avatar.avatar_id",
    "avatar_dir": "avatar.avatar_dir",
    "batch_size": "avatar.batch_size",
    "dtype": "avatar.dtype",
    "tts": "tts.backend",
    "tts_server": "tts.server_url",
    "ref_file": "tts.ref_audio",
    "ref_text": "tts.ref_text",
    "transport": "transport.mode",
    "max_session": "server.max_sessions",
    "listenport": "server.listen_port",
    "vae_ckpt": "avatar.vae_ckpt",
    "unet_ckpt": "avatar.unet_ckpt",
    "unet_config": "avatar.unet_config",
    "vae_int8": "avatar.vae_int8",
    "whisper_ckpt": "avatar.whisper_ckpt",
    "avatar_ckpt": "avatar.ckpt",
    "pose": "nerf.pose_path",
    "au": "nerf.au_path",
    "bg_img": "nerf.bg_img",
    "fix_eye": "nerf.fix_eye",
    "torso": "nerf.torso",
    "nerf_ckpt": "nerf.ckpt",
    "asr_model": "nerf.asr_model",
    "audio_in_dim": "nerf.audio_in_dim",
    "fullbody_img": "nerf.fullbody_imgs",
    "sample_mode": "nerf.sample_mode",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mere-fusion-tpu-torch server")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("-l", type=int, default=10, help="left stride (20 ms frames)")
    p.add_argument("-m", type=int, default=8, help="context size")
    p.add_argument("-r", type=int, default=10, help="right stride")
    p.add_argument("--model", default="wav2lip",
                   choices=["wav2lip", "musetalk", "ernerf"])
    p.add_argument("--avatar_id", default="avator_1")
    p.add_argument("--avatar_dir", default="./data/avatars")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--tts", default="edge",
                   choices=["edge", "gpt-sovits", "cosyvoice", "xtts", "procedural"])
    p.add_argument("--tts_server", default="http://127.0.0.1:9880")
    p.add_argument("--ref_file", default="")
    p.add_argument("--ref_text", default="")
    p.add_argument("--transport", default="loopback",
                   choices=["webrtc", "rtmp", "rtp", "loopback"],
                   help="only loopback is ported so far")
    p.add_argument("--max_session", type=int, default=10)
    p.add_argument("--listenport", type=int, default=8010)
    p.add_argument("--customopt", default="", help="path to custom idle-track json")
    p.add_argument("--avatar_ckpt", default="",
                   help="wav2lip generator weights (reference wav2lip.pth)")
    p.add_argument("--vae_ckpt", default="",
                   help="musetalk sd-vae weights (diffusers .bin/.pth)")
    p.add_argument("--unet_ckpt", default="",
                   help="musetalk UNet weights (diffusers .bin/.pth)")
    p.add_argument("--unet_config", default="", help="musetalk.json UNet architecture")
    p.add_argument("--vae_int8", default="auto", choices=["auto", "on", "off"],
                   help="int8 VAE decode tier: not ported, auto serves float")
    p.add_argument("--whisper_ckpt", default="",
                   help="whisper-tiny weights for MuseASR features (OpenAI .pt)")
    # ER-NeRF serving flags
    p.add_argument("--pose", default="data/transforms.json")
    p.add_argument("--au", default="data/au.csv")
    p.add_argument("--bg_img", default="white")
    p.add_argument("--fix_eye", type=float, default=-1.0)
    p.add_argument("--torso", action="store_true",
                   help="serve the ER-NeRF torso (the checkpoint must hold one)")
    p.add_argument("--nerf_ckpt", default="",
                   help="trained ER-NeRF avatar: a reference .pth (ngp_kf.pth) or an "
                        "ernerf_cli workspace")
    p.add_argument("--asr_model", default="",
                   help="ER-NeRF live featurizer: a DeepSpeech frozen graph (.pb), a "
                        "local directory of a transformers CTC model, or empty for the "
                        "fake")
    p.add_argument("--audio_in_dim", type=int, default=None,
                   help="the featurizer's logit width the avatar was trained on "
                        "(29 for a DeepSpeech .pb; default 44)")
    p.add_argument("--fullbody_img", default="",
                   help="directory of full-body frames (<index>.jpg/png) to paste "
                        "the rendered head into")
    p.add_argument("--fullbody_offset_x", type=int, default=0)
    p.add_argument("--fullbody_offset_y", type=int, default=0)
    p.add_argument("--sample_mode", default="pallas", choices=["pallas", "nearest", "bilinear"],
                   help="ER-NeRF texture sampling: the K2 kernel (pallas) or the baked "
                        "textures' nearest/bilinear gathers")
    p.add_argument("--device", default="",
                   help="place sessions on this device (e.g. cpu); default: "
                        "every CUDA device")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    overrides = {key: getattr(args, flag) for flag, key in _FLAG_TO_KEY.items()
                 if getattr(args, flag, None) is not None}
    if getattr(args, "fullbody_img", ""):
        overrides["nerf.fullbody_offset"] = (args.fullbody_offset_x, args.fullbody_offset_y)
    return Config().override(**overrides)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    custom_opts = []
    if args.customopt:
        with open(args.customopt) as f:
            custom_opts = json.load(f)

    import torch

    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.server.app import run_server

    devices = [torch.device(args.device)] if args.device else None
    # **kw forwards the SessionManager's device= placement to the engine
    run_server(cfg, lambda c, **kw: make_engine(c, custom_opts=custom_opts, **kw),
               devices=devices)


if __name__ == "__main__":
    main()
