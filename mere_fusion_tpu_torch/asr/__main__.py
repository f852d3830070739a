"""ASR simulation CLI (reference: whisper_online.py:697-823).

Port of mere_fusion_tpu/asr/__main__.py:

    python -m mere_fusion_tpu_torch.asr path/to/audio.wav --min-chunk-size 1.0 \
        --backend jax-whisper --mode online
    python -m mere_fusion_tpu_torch.asr file.wav --mode batch --output-format srt

Modes: offline (whole file at once), unaware (chunked, instant compute),
online (chunked, wall-clock accounted), batch (30 s windows decoded in
device batches — the reference's InsanelyFastWhisper chunked mode). The
backend name ``jax-whisper`` (the config's) is the port's Whisper, on the
current CUDA device unless ``--device`` names another (``--device cpu``).
"""
from __future__ import annotations

import argparse

import numpy as np


def load_wav_16k(path: str) -> np.ndarray:
    from scipy.io import wavfile

    from mere_fusion_tpu_torch.tts import resample_pcm

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    if data.ndim > 1:
        data = data[:, 0]
    return resample_pcm(data.astype(np.float32), sr, 16000)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("asr-simulate")
    p.add_argument("audio")
    p.add_argument("--backend", default="jax-whisper")
    p.add_argument("--min-chunk-size", type=float, default=1.0)
    p.add_argument("--mode", default="online",
                   choices=["offline", "unaware", "online", "batch"])
    p.add_argument("--batch-size", type=int, default=24)
    p.add_argument("--buffer-trim", type=float, default=15.0)
    p.add_argument("--language", default="en",
                   help="ISO language code, or 'auto' to detect on the "
                        "first buffer (reference decoding.py:19)")
    p.add_argument("--beam-size", type=int, default=5,
                   help="beam width for the t=0 decode "
                        "(reference whisper_online.py:137-139)")
    p.add_argument("--vad", action="store_true", default=False,
                   help="voice activity detection on the backend "
                        "(reference whisper_online.py:628-629)")
    p.add_argument("--output-format", default="",
                   choices=["", "txt", "vtt", "srt"],
                   help="also write the transcript in this format "
                        "(reference musetalk/whisper/whisper/utils.py:47-88)")
    p.add_argument("--output-file", default="-",
                   help="destination for --output-format ('-' = stdout)")
    p.add_argument("--device", default=None,
                   help="where jax-whisper runs (default: the current CUDA device; "
                        "'cpu' to run on the CPU)")
    args = p.parse_args(argv)

    from mere_fusion_tpu_torch.utils.env import load_dotenv

    load_dotenv()  # openai-api backend reads OPENAI_API_KEY (ref app.py:10)

    from mere_fusion_tpu_torch.asr import StreamingTranscriber, make_backend
    from mere_fusion_tpu_torch.asr.simulate import simulate_streaming

    audio = load_wav_16k(args.audio)
    bk_kw = {}
    if args.backend == "jax-whisper":
        bk_kw = {"language": args.language, "beam_size": args.beam_size,
                 "device": args.device}
    backend = make_backend(args.backend, **bk_kw)
    if args.vad:
        backend.use_vad()

    def write_out(segments):
        if not args.output_format:
            return
        import sys

        from mere_fusion_tpu_torch.asr.writers import WRITERS

        writer = WRITERS[args.output_format]
        if args.output_file == "-":
            writer(segments, sys.stdout)
        else:
            with open(args.output_file, "w", encoding="utf-8") as f:
                writer(segments, f)

    if args.mode == "batch":
        import time

        from mere_fusion_tpu_torch.asr.writers import chunks_to_segments

        t0 = time.time()
        res = backend.transcribe_long(audio, batch_size=args.batch_size)
        dt = time.time() - t0
        for ch in res["chunks"]:
            print(f"[{ch['start']:7.1f}-{ch['end']:7.1f}] {ch['text']}")
        print(f"-- {res['duration']:.1f} s audio in {dt:.1f} s "
              f"({res['duration']/max(dt,1e-9):.1f}x realtime)")
        write_out(chunks_to_segments(res["chunks"]))
        return

    if args.mode == "offline":
        res = backend.transcribe(audio)
        words = backend.ts_words(res)
        print(backend.sep.join(w.text for w in words))
        if words:
            write_out([{"start": words[0].beg, "end": words[-1].end,
                        "text": backend.sep.join(w.text for w in words)}])
        return

    st = StreamingTranscriber(backend, buffer_trimming=("segment", args.buffer_trim))
    result = simulate_streaming(
        st, audio, min_chunk=args.min_chunk_size,
        computationally_aware=args.mode == "online",
    )
    for e in result.emissions:
        print(f"{e.emitted_at*1000:8.0f} ms  [{e.beg}-{e.end}]  {e.text}")
    print(f"-- transcript: {result.transcript}")
    print(f"-- mean emission latency: {result.mean_latency*1000:.0f} ms")
    from mere_fusion_tpu_torch.asr.writers import emissions_to_segments

    write_out(emissions_to_segments(result.emissions))


if __name__ == "__main__":
    main()
