"""Standalone streaming ER-NeRF audio featurizer.

Port of mere_fusion_tpu/tools/nerf_asr.py, the twin of the reference's
standalone ASR (ernerf/nerf_triplane/asr.py:36-114, 184-268): stream audio
through the NerfASR ring the live engine uses, optionally saving the
per-video-frame feature windows a user's avatar is trained on
(--save_feats, the reference's --asr_save_feats).

Live input is raw PCM16 at 16 kHz on stdin or a FIFO, so anything that
writes PCM to a pipe is a microphone:

    arecord -f S16_LE -r 16000 -c 1 | \\
        python -m mere_fusion_tpu_torch.tools.nerf_asr - --asr_model ds.pb --audio_dim 29

File mode:

    python -m mere_fusion_tpu_torch.tools.nerf_asr speech.wav --asr_model ds.pb \\
        --audio_dim 29 --save_feats aud.npy     # [N, 16, audio_dim] float32

The featurizer runs on the current CUDA device, or on the CPU with
--device cpu. --play mirrors the reference's play-out thread and needs
pyaudio.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np

CHUNK = 320  # 20 ms @ 16 kHz
SR = 16000


def wav_chunks(path: str):
    """20 ms float32 chunks of a wav file (mono, resampled to 16 kHz), the
    last one zero-padded."""
    from mere_fusion_tpu_torch.engines.base import _read_wav_f32

    pcm = _read_wav_f32(path)
    n = (len(pcm) + CHUNK - 1) // CHUNK
    pcm = np.pad(pcm, (0, n * CHUNK - len(pcm)))
    for i in range(n):
        yield pcm[i * CHUNK:(i + 1) * CHUNK]


def pcm16_chunks(fileobj):
    """20 ms float32 chunks of raw little-endian PCM16 at 16 kHz mono from a
    byte stream (stdin or a FIFO)."""
    while True:
        buf = fileobj.read(CHUNK * 2)
        if not buf:
            return
        if len(buf) < CHUNK * 2:
            buf = buf + b"\x00" * (CHUNK * 2 - len(buf))
        yield np.frombuffer(buf, np.int16).astype(np.float32) / 32768.0


def stream_features(chunks, cfg, logits_fn, realtime: bool = False,
                    on_window=None) -> np.ndarray:
    """Run the engine's NerfASR (one window a video frame, att=0) over a
    chunk stream; returns the stacked windows [N, 16, audio_dim].
    on_window(i, window) is called for each frame as it comes."""
    from mere_fusion_tpu_torch.engines.nerf import NerfASR

    asr = NerfASR(cfg, None, logits_fn, att=0)
    asr.warm_up()
    windows = []
    step = 0

    def one_step():
        nonlocal step
        asr.run_step()
        asr.get_audio_out()  # drain the play-out queue (no sink here)
        step += 1
        if step % 2 == 0:
            w = asr.get_next_feat()[0].T  # [16, audio_dim]
            if on_window is not None:
                on_window(len(windows), w)
            windows.append(w)

    next_t = time.perf_counter()
    for chunk in chunks:
        asr.put_audio_frame(np.asarray(chunk, np.float32))
        one_step()
        if realtime:
            next_t += CHUNK / SR
            delay = next_t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
    # the ring lags the input by its context: silence flushes the tail (the
    # ASR synthesizes it when its queue is empty)
    for _ in range(cfg.stride.left + cfg.stride.right + cfg.stride.mid):
        one_step()
    return np.stack(windows) if windows else np.zeros((0, 16, asr.audio_dim))


def main(argv=None) -> dict:
    """Featurize the input; returns {"frames", "seconds", "audio_seconds"}."""
    p = argparse.ArgumentParser("nerf-asr", description="streaming ER-NeRF audio featurizer")
    p.add_argument("input", help=".wav path, '-' for PCM16 stdin, or a FIFO")
    p.add_argument("--asr_model", default="",
                   help="DeepSpeech .pb or a local transformers CTC model directory; "
                        "empty = the fake featurizer")
    p.add_argument("--audio_dim", type=int, default=44,
                   help="the featurizer's logit width (29 for a DeepSpeech .pb)")
    p.add_argument("-l", type=int, default=10)
    p.add_argument("-m", type=int, default=8)
    p.add_argument("-r", type=int, default=10)
    p.add_argument("--save_feats", default="",
                   help="write the [N, 16, audio_dim] windows to this .npy")
    p.add_argument("--realtime", action="store_true",
                   help="pace chunks at 20 ms (live simulation for files)")
    p.add_argument("--play", action="store_true",
                   help="play audio out while featurizing (needs pyaudio)")
    p.add_argument("--device", default=None,
                   help="where the featurizer runs (default: the current CUDA device)")
    args = p.parse_args(argv)

    if args.play:
        try:
            import pyaudio  # noqa: F401
        except ImportError as e:
            raise SystemExit("--play needs the 'pyaudio' package, which is not "
                             "installed; featurization itself runs without it") from e

    from mere_fusion_tpu_torch.config import Config

    cfg = Config().override(**{
        "nerf.audio_in_dim": args.audio_dim,
        "stride.left": args.l, "stride.mid": args.m, "stride.right": args.r,
    })
    if args.asr_model:
        from mere_fusion_tpu_torch.engines import make_nerf_featurizer

        logits_fn, _ = make_nerf_featurizer(args.asr_model, args.device, args.audio_dim)
    else:
        from mere_fusion_tpu_torch.engines.nerf import fake_logits_fn

        logits_fn = fake_logits_fn(args.audio_dim)

    with contextlib.ExitStack() as stack:
        if args.input == "-":
            chunks = pcm16_chunks(sys.stdin.buffer)
        elif args.input.endswith(".wav"):
            chunks = wav_chunks(args.input)
        else:  # FIFO / raw PCM file
            chunks = pcm16_chunks(stack.enter_context(open(args.input, "rb")))
        print(f"expected live latency ≈ ({args.m} + {args.r}) × 20 ms = "
              f"{(args.m + args.r) * 20} ms", file=sys.stderr)
        t0 = time.perf_counter()
        feats = stream_features(chunks, cfg, logits_fn, realtime=args.realtime)
        dt = time.perf_counter() - t0
    audio_s = feats.shape[0] / cfg.audio.fps
    print(f"featurized {feats.shape[0]} video frames ({audio_s:.1f} s of audio) "
          f"in {dt:.2f} s", file=sys.stderr)
    if args.save_feats:
        np.save(args.save_feats, feats.astype(np.float32))
        print(f"saved {feats.shape} -> {args.save_feats}", file=sys.stderr)
    return {"frames": int(feats.shape[0]), "seconds": dt, "audio_seconds": audio_s}


if __name__ == "__main__":
    main()
