"""Server CLI: flag surface mapped onto the typed Config.

Port of mere_fusion_tpu/cli.py for the slices the PyTorch package carries:

    python -m mere_fusion_tpu_torch.cli --avatar_ckpt models/wav2lip.pth \\
        --tts procedural --transport rtp --rtp_host 10.0.0.2
    python -m mere_fusion_tpu_torch.cli --model musetalk --tts procedural \\
        --transport loopback
    python -m mere_fusion_tpu_torch.cli --model ernerf --pose data/transforms.json \\
        --au data/au.csv --tts procedural --transport loopback

Sessions are placed on the host's CUDA devices; ``--device cpu`` runs them
on the CPU instead. ``--transport`` defaults to webrtc against an SRS relay
(``--push_url``, ``--pull_url``), which needs aiortc; ``rtp`` (L16 audio and
RFC 4175 video over UDP to ``--rtp_host``) and ``rtmp`` (an FLV push to
``--push_url``, native when ffmpeg is absent) need neither.

``--llm`` (openai, chatgpt, vllm, qwen, gemini, echo) gives every session a
brain: the caller's speech is transcribed by ``--asr_backend`` (jax-whisper,
the name the config shares with the JAX package, runs the port's Whisper on
the session's card), the LLM answers, and the avatar speaks the answer;
``--perception yolo-tpu`` (with ``--yolo_ckpt``, ``--yolo_scale``,
``--perception_fps``, ``--face_attrs``, ``--ocr``) summarizes the caller's
camera for it with the port's YOLOv10 on the session's card.
API keys come from the environment or a ``.env`` file in the working
directory.
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
    "asr_backend": "asr.backend",
    "transport": "transport.mode",
    "push_url": "transport.push_url",
    "pull_url": "transport.pull_url",
    "rtp_host": "transport.rtp_host",
    "rtp_audio_port": "transport.rtp_audio_port",
    "rtp_video_port": "transport.rtp_video_port",
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
    "perception": "perception.backend",
    "yolo_ckpt": "perception.ckpt",
    "yolo_scale": "perception.scale",
    "perception_fps": "perception.fps_throttle",
    "face_attrs": "perception.face_attrs",
    "ocr": "perception.ocr",
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
    p.add_argument("--asr_backend", default="jax-whisper",
                   choices=["jax-whisper", "faster-whisper", "openai-api"],
                   help="the caller's speech recognizer in a session with --llm: the "
                        "port's Whisper on the card (jax-whisper), faster-whisper or "
                        "the OpenAI API")
    p.add_argument("--transport", default="webrtc",
                   choices=["webrtc", "rtmp", "rtp", "loopback"])
    p.add_argument("--push_url", default="http://localhost:1985/rtc/v1/publish/")
    p.add_argument("--pull_url", default="http://localhost:1985/rtc/v1/play/")
    p.add_argument("--rtp_host", default="127.0.0.1",
                   help="--transport rtp: destination host")
    p.add_argument("--rtp_audio_port", type=int, default=5004,
                   help="--transport rtp: L16 audio UDP port (RTCP on +1)")
    p.add_argument("--rtp_video_port", type=int, default=5006,
                   help="--transport rtp: RFC4175 video UDP port (RTCP on +1)")
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
    p.add_argument("--perception", default="stub", choices=["stub", "yolo-tpu", "yolo"],
                   help="the caller's camera in a session with --llm: the port's YOLOv10 "
                        "on the session's card (yolo-tpu, the config's name), ultralytics "
                        "(yolo), or the stub")
    p.add_argument("--yolo_ckpt", default="",
                   help="yolov10*.pt weights (yolo-tpu reads it without the ultralytics "
                        "package); empty: seeded random weights")
    p.add_argument("--yolo_scale", default="x", choices=["n", "s", "m", "b", "l", "x"])
    p.add_argument("--perception_fps", type=int, default=10,
                   help="analyze every Nth camera frame")
    p.add_argument("--face_attrs", default="",
                   help="face attributes for yolo-tpu on the card: 'random' or "
                        "'age=age.h5,gender=gender.h5,...' (DeepFace .h5 weights); "
                        "empty = the deepface library when importable")
    p.add_argument("--ocr", default="",
                   help="scene-text OCR for yolo-tpu on the card: 'random' or "
                        "'craft=craft_mlt_25k.pth,crnn=english_g2.pth'; "
                        "empty = the easyocr library when importable")
    p.add_argument("--llm", default="",
                   help="LLM backend that answers the caller (openai|chatgpt|vllm|qwen|"
                        "gemini|echo); empty: sessions have no brain")
    p.add_argument("--llm_url", default="",
                   help="--llm openai/chatgpt: an OpenAI-compatible base URL")
    p.add_argument("--llm_model", default="gpt-3.5-turbo",
                   help="--llm openai/chatgpt: the model name, with --llm_url")
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


def make_llm_from_args(args: argparse.Namespace):
    """The LLM adapter ``--llm`` names, or None without one."""
    if not args.llm:
        return None
    from mere_fusion_tpu_torch.llm import make_llm

    kw = {}
    if args.llm in ("openai", "chatgpt") and args.llm_url:
        kw = {"base_url": args.llm_url, "model": args.llm_model}
    return make_llm(args.llm, **kw)


def main(argv=None) -> None:
    # API keys from a .env file in the working directory (the environment wins)
    from mere_fusion_tpu_torch.utils.env import load_dotenv

    load_dotenv()
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
               llm=make_llm_from_args(args), devices=devices)


if __name__ == "__main__":
    main()
