"""ASR backends: device transcription behind a uniform protocol.

Port of mere_fusion_tpu/asr/backends.py. Mirrors the reference's
interchangeable backend design (whisper_online.py:33-302: whisper_timestamped
/ faster-whisper / OpenAI API / insanely-fast-whisper). The primary backend,
``TorchWhisperBackend``, runs the port's Whisper on the card: a fixed
30-second window, the beam-5 decode with KV caches, the temperature-fallback
ladder, language detection and DTW word times. faster-whisper and the OpenAI
API remain available when their packages/keys exist, and FakeBackend drives
deterministic streaming-logic tests.

``transcribe_long`` is the offline long-file path: fixed 30-second windows,
their mels in one call, encoded and decoded a group of windows at a time
(the beam search runs one search a window on the batch).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional, Protocol, Sequence

import numpy as np

from mere_fusion_tpu_torch.asr.streaming import Word

SAMPLE_RATE = 16000
N_SAMPLES_30S = 30 * SAMPLE_RATE


class ASRBackend(Protocol):
    sep: str

    def transcribe(self, audio: np.ndarray, init_prompt: str = "") -> Any: ...
    def ts_words(self, res: Any) -> list[Word]: ...
    def segments_end_ts(self, res: Any) -> list[float]: ...


@dataclass
class FakeSegment:
    words: list[Word]
    end: float


class FakeBackend:
    """Deterministic scripted backend for streaming-logic tests.

    Configure with a word script [(beg, end, text), ...] in stream seconds;
    transcribe() returns the words whose span lies inside the given buffer,
    with per-call jitter on the trailing word to exercise LCP commits.
    """

    sep = " "

    def __init__(self, script: Sequence[tuple[float, float, str]], jitter_last: bool = True):
        self.script = [Word(*w) for w in script]
        self.jitter_last = jitter_last
        self.calls = 0
        self.offset = 0.0  # StreamingTranscriber passes buffer-relative audio

    def set_offset(self, offset: float) -> None:
        self.offset = offset

    def transcribe(self, audio: np.ndarray, init_prompt: str = "") -> list[Word]:
        self.calls += 1
        dur = len(audio) / SAMPLE_RATE
        inside = [
            Word(w.beg - self.offset, w.end - self.offset, w.text)
            for w in self.script
            if w.beg >= self.offset and w.end <= self.offset + dur
        ]
        if self.jitter_last and inside and self.calls % 2 == 1:
            # mutate the most recent word — it must not commit yet
            last = inside[-1]
            inside[-1] = Word(last.beg, last.end, last.text + "~")
        return inside

    def ts_words(self, res: list[Word]) -> list[Word]:
        return res

    def segments_end_ts(self, res: list[Word]) -> list[float]:
        return [w.end for w in res]


def timestamp_segments(tokens: list, ts_begin: int | None, window_s: float,
                       precision: float = 0.02):
    """Split one decoded window's tokens at whisper timestamp tokens.

    Returns [(start_s, end_s, [text tokens]), ...] covering the window —
    the segmentation step of the reference's vendored-whisper long-form
    decode (musetalk/whisper/whisper/transcribe.py:103-127: slices between
    consecutive timestamp pairs become segments; their seek-by-timestamp is
    replaced by fixed windows so decodes stay batchable). Timestamps are
    clamped monotonic and into [0, window_s]; ts_begin=None (or a window
    with no timestamp tokens) yields one window-spanning segment."""
    if ts_begin is None:
        return [(0.0, window_s, list(tokens))]
    segs = []
    cur_start = None
    cur_text: list = []
    last_t = 0.0
    for t in tokens:
        if t >= ts_begin:
            ts = min(max((t - ts_begin) * precision, last_t), window_s)
            if cur_text:
                segs.append((cur_start if cur_start is not None else last_t,
                             ts, cur_text))
                cur_text = []
                cur_start = None
            else:
                cur_start = ts
            last_t = ts
        else:
            cur_text.append(t)
    if cur_text:
        segs.append((cur_start if cur_start is not None else last_t,
                     window_s, cur_text))
    return segs or [(0.0, window_s, [])]


class TorchWhisperBackend:
    """The port's Whisper on the card (twin of the JAX package's
    JaxWhisperBackend).

    Word timestamps come from cross-attention DTW alignment (asr/align.py,
    the whisper-timestamped technique) when a tokenizer is present. Text is
    emitted as token-id strings when no tokenizer vocabulary is found.
    """

    sep = ""

    def __init__(self, state_dict=None, dims=None, tokenizer=None,
                 language_index: int | None = None, language: str = "en",
                 beam_size: int = 5, best_of: int = 5,
                 temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                 compression_ratio_threshold: float | None = 2.4,
                 logprob_threshold: float | None = -1.0,
                 no_speech_threshold: float | None = 0.6,
                 prompt_bucket: int = 96,
                 word_timestamps: bool = True, use_vad: bool = False,
                 device=None):
        """Defaults mirror the reference pipeline: beam 5 ("b5 is faster
        and better than b1", whisper_online.py:137-139), the temperature
        fallback ladder (0.0→1.0 by 0.2) gated on gzip compression ratio
        2.4 / avg logprob -1.0 / no-speech 0.6 (reference
        transcribe.py:25-57,156-176), and previous-text conditioning via
        <|startofprev|> + up to ``prompt_bucket`` prompt tokens
        (decoding.py:515-530). language="auto" detects on the first speech
        buffer (decoding.py:19 detect_language).

        state_dict: the model's weights under OpenAI whisper names; None
        means seeded random weights (``init_whisper(dims)``). The
        weights go on ``device``; None means the current CUDA device, and
        with no GPU present the constructor raises."""
        from mere_fusion_tpu_torch.device import resolve_device
        from mere_fusion_tpu_torch.models.whisper import (
            TINY,
            Whisper,
            init_whisper,
            make_cached_beam_decoder,
            make_cached_greedy_decoder,
            sot_sequence,
        )
        from mere_fusion_tpu_torch.models.whisper import (
            language_index as lang_code_index,
        )

        self.device = resolve_device(device)
        self.dims = dims or TINY
        if state_dict is None:
            model = init_whisper(self.dims)
        else:
            model = Whisper(self.dims)
            model.load_state_dict(state_dict, strict=True)
        self.model = model.eval().to(self.device)
        if tokenizer is None:
            try:
                from mere_fusion_tpu_torch.utils.bpe import load_whisper_tokenizer

                tokenizer = load_whisper_tokenizer()
            except (FileNotFoundError, OSError):
                tokenizer = None  # token-id text
        self.tokenizer = tokenizer
        self.language = language   # sentence-splitter default (asr/streaming)
        self.language_auto = language == "auto" and language_index is None
        self.detected_language: Optional[str] = None
        if language_index is None:
            language_index = (0 if language in ("auto", None)
                              else lang_code_index(language, self.dims.n_vocab))
        self._sot = sot_sequence(language_index)
        suppress = None
        if self.tokenizer is not None:
            from mere_fusion_tpu_torch.models.whisper import non_speech_token_ids

            suppress = non_speech_token_ids(self.tokenizer)
        self._suppress = suppress
        self.temperatures = tuple(temperatures)
        self.compression_ratio_threshold = compression_ratio_threshold
        self.logprob_threshold = logprob_threshold
        self.no_speech_threshold = no_speech_threshold
        # prompt tokens are capped at n_ctx//2 - 1 (decoding.py:529); the
        # fixed bucket below that keeps one decode length per mode
        self.prompt_bucket = min(prompt_bucket, self.dims.n_text_ctx // 2 - 1)
        self.beam_size = beam_size
        self.best_of = best_of
        self._sample_seed = 0
        self._sampler = None      # lazy: fallback rungs are rare with trained weights
        self._detector = None     # lazy: language auto-detect
        self._ts_decode = None    # lazy: the offline path's timestamp decoder
        if beam_size > 1:
            self._decode = make_cached_beam_decoder(
                self.model, beam_size=beam_size, max_new_tokens=128,
                suppress_tokens=suppress, return_scores=True)
        else:
            self._decode = make_cached_greedy_decoder(
                self.model, max_new_tokens=128, suppress_tokens=suppress,
                return_scores=True)
        self.word_timestamps = word_timestamps and self.tokenizer is not None
        self.use_vad_opt = use_vad

    def use_vad(self) -> None:
        """Energy-gate VAD (reference whisper_online.py:663-665 enables VAD
        on the chosen backend; see asr/vad.py). Silence-only buffers skip
        the encode/decode entirely and words with no speech overlap are
        dropped."""
        self.use_vad_opt = True

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "TorchWhisperBackend":
        """An OpenAI whisper ``.pt`` ({"dims", "model_state_dict"})."""
        from mere_fusion_tpu_torch.convert import load_whisper_checkpoint

        model = load_whisper_checkpoint(path)
        return cls(state_dict=model.state_dict(), dims=model.dims, **kw)

    def _encode(self, audio: np.ndarray):
        """The encoded fixed window [1, n_audio_ctx, D] of ``audio``: the
        first 30 s (for the published dims), zero-padded."""
        import torch

        from mere_fusion_tpu_torch.ops.mel import melspectrogram, whisper_mel_config

        window = self.dims.n_audio_ctx * 2 * 160
        padded = np.zeros(window, dtype=np.float32)
        padded[: min(len(audio), window)] = audio[:window]
        with torch.no_grad():
            mel = melspectrogram(torch.from_numpy(padded).to(self.device),
                                 whisper_mel_config(self.dims.n_mels))[None]
            return self.model.encode(mel)

    def _build_prompt(self, init_prompt: str) -> tuple[list[int], int]:
        """Decode prompt: [<|startofprev|>] + prompt tokens (≤ bucket,
        right-truncated like the reference's ``[-(n_ctx//2 - 1):]``,
        decoding.py:527-529) + sot_sequence, EOT-padded to a FIXED bucket
        length so that prompted decodes share one length. Returns
        (buffer, prompt_len)."""
        from mere_fusion_tpu_torch.models.whisper import EOT, SOT_PREV

        if not init_prompt or self.tokenizer is None:
            return list(self._sot), len(self._sot)
        toks = self.tokenizer.encode(" " + init_prompt.strip())
        toks = toks[-self.prompt_bucket:]
        seq = [SOT_PREV] + toks + list(self._sot)
        plen = len(seq)
        seq = seq + [EOT] * (1 + self.prompt_bucket + len(self._sot) - plen)
        return seq, plen

    def detect_language(self, audio: np.ndarray | None = None,
                        xa=None) -> tuple[str, float]:
        """Language id over the encoder output (reference decoding.py:19-66
        detect_language): one decoder pass on [<|sot|>], softmax over the
        language tokens. Returns (language code, probability)."""
        from mere_fusion_tpu_torch.models.whisper import (
            LANGUAGE_CODES,
            make_language_detector,
        )

        if self._detector is None:
            self._detector = make_language_detector(self.model)
        if xa is None:
            xa = self._encode(audio)
        idx_dev, probs_dev = self._detector(xa)
        idx = int(idx_dev[0])
        prob = float(probs_dev[0, idx])
        return LANGUAGE_CODES[idx], prob

    @staticmethod
    def _compression_ratio(text: str) -> float:
        """gzip compressibility of the decoded text — the reference's
        repetition-loop detector (whisper utils.py compression_ratio)."""
        import zlib

        data = text.encode("utf-8")
        if not data:
            return 0.0
        return len(data) / len(zlib.compress(data))

    def transcribe(self, audio: np.ndarray, init_prompt: str = "") -> dict:
        import torch

        from mere_fusion_tpu_torch.models.whisper import (
            EOT,
            make_cached_sampling_decoder,
            sot_sequence,
        )
        from mere_fusion_tpu_torch.models.whisper import (
            language_index as lang_code_index,
        )

        duration = len(audio) / SAMPLE_RATE
        speech = None
        if self.use_vad_opt:
            from mere_fusion_tpu_torch.asr.vad import speech_segments

            speech = speech_segments(audio)
            if not speech:  # pure silence/noise: skip the device round-trip
                return {"tokens": [], "duration": duration, "starts": None,
                        "speech": speech}
        xa = self._encode(audio)

        if self.language_auto and self.detected_language is None:
            code, _prob = self.detect_language(xa=xa)
            self.detected_language = code
            self._sot = sot_sequence(lang_code_index(code, self.dims.n_vocab))

        prompt_seq, plen = self._build_prompt(init_prompt)
        prompt = torch.tensor([prompt_seq], dtype=torch.long, device=self.device)

        # temperature-fallback ladder (reference transcribe.py
        # decode_with_fallback): t=0 beam/greedy, t>0 best-of sampling;
        # retry while the compression ratio or avg logprob gate trips
        tokens = avg_lp = ns_prob = None
        temperature = 0.0
        for t in self.temperatures:
            temperature = t
            if t == 0:
                toks_d, avg_d, ns_d = self._decode(xa, prompt, plen)
                tokens = toks_d[0].cpu().numpy()
                avg_lp = float(avg_d[0])
                ns_prob = float(ns_d[0])
            else:
                if self._sampler is None:
                    self._sampler = make_cached_sampling_decoder(
                        self.model, best_of=self.best_of, max_new_tokens=128,
                        suppress_tokens=self._suppress)
                self._sample_seed += 1
                toks_d, avg_d, ns_d = self._sampler(
                    xa, prompt, plen, t, self._sample_seed)
                avgs = avg_d.cpu().numpy()
                best = int(avgs.argmax())
                tokens = toks_d[best].cpu().numpy()
                avg_lp = float(avgs[best])
                ns_prob = float(ns_d[best])
            text_tokens = [int(tok) for tok in tokens[plen:] if tok != EOT]
            needs_fallback = False
            if self.compression_ratio_threshold is not None:
                text = "".join(self._token_text(tok) for tok in text_tokens)
                if (self._compression_ratio(text)
                        > self.compression_ratio_threshold):
                    needs_fallback = True   # too repetitive
            if (self.logprob_threshold is not None
                    and avg_lp < self.logprob_threshold):
                needs_fallback = True       # average log probability too low
            if not needs_fallback:
                break

        # no-speech gate (reference transcribe.py: skip the segment when
        # no_speech_prob > threshold unless avg_logprob clears its bar)
        if (self.no_speech_threshold is not None
                and ns_prob > self.no_speech_threshold
                and (self.logprob_threshold is None
                     or avg_lp < self.logprob_threshold)):
            text_tokens = []

        starts = None
        if self.word_timestamps and text_tokens:
            # DTW word alignment over the final sequence's cross-attention
            # (one full causal pass)
            with torch.no_grad():
                attn = self.model.cross_attentions(
                    torch.as_tensor(tokens[None], device=self.device), xa).cpu().numpy()
            n_frames = int(duration / 0.02)
            starts = self._align_starts(attn, plen, n_frames, len(text_tokens))
        return {"tokens": text_tokens, "duration": duration, "starts": starts,
                "speech": speech, "avg_logprob": avg_lp,
                "no_speech_prob": ns_prob, "temperature": temperature,
                "language": self.detected_language}

    def _align_starts(self, attn, n_prompt, n_frames, n_text):
        from mere_fusion_tpu_torch.asr.align import token_times

        starts = token_times(attn, n_prompt, n_frames)
        return starts[:n_text]

    def _ts_decoder(self):
        """Decoder variant for timestamp-mode decoding: the same search as
        the main decoder, with <|notimestamps|> suppressed (the published
        whisper rule while timestamps are being predicted; no other
        timestamp rule is applied, as in the JAX package); lazy — the
        offline long-file path is the only caller."""
        if self._ts_decode is None:
            from mere_fusion_tpu_torch.models.whisper import (
                NO_TIMESTAMPS,
                make_cached_beam_decoder,
                make_cached_greedy_decoder,
            )

            suppress = tuple(sorted(set(self._suppress or ()) | {NO_TIMESTAMPS}))
            if self.beam_size > 1:
                self._ts_decode = make_cached_beam_decoder(
                    self.model, beam_size=self.beam_size, max_new_tokens=128,
                    suppress_tokens=suppress, return_scores=True)
            else:
                self._ts_decode = make_cached_greedy_decoder(
                    self.model, max_new_tokens=128, suppress_tokens=suppress,
                    return_scores=True)
        return self._ts_decode

    def transcribe_long(self, audio: np.ndarray, batch_size: int = 24,
                        timestamps: bool = True) -> dict:
        """Offline long-file transcription: split into 30 s windows and
        decode them in device batches — the reference's active backend's
        chunked mode (InsanelyFastWhisperASR, whisper_online.py:254-302:
        chunk_length_s=30, batch_size=24).

        The windows' mels are made in one call; each group of
        ``batch_size`` windows is encoded in one call and decoded in one
        batched search (the beam decoder runs one n-beam search a window).
        The last group is not padded to ``batch_size``: a window's tokens do
        not depend on the others in its group.

        timestamps=True decodes WITH whisper timestamp tokens (the SOT
        sequence without <|notimestamps|>, <|notimestamps|> suppressed) and
        segments each window at the predicted timestamps — sub-window
        boundaries in the spirit of the reference's vendored-whisper
        seek-by-timestamp segmentation (musetalk/whisper/whisper/
        transcribe.py:103-127), while the windows stay fixed at 30 s so that
        decodes batch. Off on vocabs without timestamp tokens.

        Returns {"chunks": [{start, end, tokens, text}...], "text", "duration"}.
        """
        import torch

        from mere_fusion_tpu_torch.models.whisper import (
            EOT,
            NO_TIMESTAMPS,
            TIMESTAMP_BEGIN,
        )
        from mere_fusion_tpu_torch.ops.mel import melspectrogram, whisper_mel_config

        window = self.dims.n_audio_ctx * 2 * 160
        duration = len(audio) / SAMPLE_RATE
        n_chunks = max(1, -(-len(audio) // window))
        padded = np.zeros(n_chunks * window, dtype=np.float32)
        padded[: len(audio)] = audio

        use_ts = (timestamps and self.dims.n_vocab > TIMESTAMP_BEGIN
                  and NO_TIMESTAMPS in self._sot)
        sot = (tuple(t for t in self._sot if t != NO_TIMESTAMPS)
               if use_ts else tuple(self._sot))
        decode = self._ts_decoder() if use_ts else self._decode
        prompt = torch.tensor([sot], dtype=torch.long, device=self.device)
        all_tokens = []
        with torch.no_grad():
            mels = melspectrogram(torch.from_numpy(padded).to(self.device).view(n_chunks, window),
                                  whisper_mel_config(self.dims.n_mels))
            for i in range(0, n_chunks, batch_size):
                xa = self.model.encode(mels[i:i + batch_size])
                toks = decode(xa, prompt.expand(xa.shape[0], -1), len(sot))[0]
                all_tokens.extend(toks.cpu().numpy())

        window_s = window / SAMPLE_RATE
        chunks = []
        for c, toks in enumerate(all_tokens):
            seq = [int(t) for t in toks[len(sot):] if t != EOT]
            off = c * window_s
            wend = min((c + 1) * window_s, duration)
            for s0, s1, seg_toks in timestamp_segments(
                    seq, TIMESTAMP_BEGIN if use_ts else None, window_s):
                chunks.append({
                    "start": off + s0,
                    "end": min(off + s1, wend),
                    "tokens": seg_toks,
                    "text": "".join(self._token_text(t) for t in seg_toks),
                })
        return {"chunks": chunks,
                "text": "".join(ch["text"] for ch in chunks),
                "duration": duration}

    def _token_text(self, tok: int) -> str:
        if self.tokenizer is not None:
            return self.tokenizer.decode([tok])
        return f"<{tok}>"

    def ts_words(self, res: dict) -> list[Word]:
        toks = res["tokens"]
        if not toks:
            return []
        if res.get("starts") is not None and self.tokenizer is not None:
            from mere_fusion_tpu_torch.asr.align import words_with_times

            triples = words_with_times(toks, res["starts"], self.tokenizer,
                                       res["duration"])
            words = [Word(s, e, " " + t) for s, e, t in triples]
        else:
            dt = res["duration"] / len(toks)
            words = [
                Word(i * dt, (i + 1) * dt, self._token_text(t))
                for i, t in enumerate(toks)
            ]
        if self.use_vad_opt:
            from mere_fusion_tpu_torch.asr.vad import filter_words

            words = filter_words(words, res.get("speech"))
        return words

    def segments_end_ts(self, res: dict) -> list[float]:
        return [res["duration"]]


class FasterWhisperBackend:
    """CTranslate2 faster-whisper (whisper_online.py:101-162), if installed."""

    sep = ""

    def __init__(self, model_size: str = "tiny", language: str = "en", **kw):
        from faster_whisper import WhisperModel

        self.language = language
        self.transcribe_kargs: dict = {}
        self.model = WhisperModel(model_size, device="cpu", compute_type="int8", **kw)

    def use_vad(self) -> None:
        # faster-whisper ships its own VAD (reference whisper_online.py:158-159)
        self.transcribe_kargs["vad_filter"] = True

    def transcribe(self, audio: np.ndarray, init_prompt: str = ""):
        segments, _info = self.model.transcribe(
            audio,
            language=self.language,
            initial_prompt=init_prompt,
            beam_size=5,
            word_timestamps=True,
            condition_on_previous_text=True,
            **self.transcribe_kargs,
        )
        return list(segments)

    def ts_words(self, segments) -> list[Word]:
        out = []
        for seg in segments:
            if getattr(seg, "no_speech_prob", 0) > 0.9:
                continue
            for w in seg.words:
                out.append(Word(w.start, w.end, w.word))
        return out

    def segments_end_ts(self, segments) -> list[float]:
        return [s.end for s in segments]


class OpenAIApiBackend:
    """OpenAI cloud transcription API (whisper_online.py:165-246
    OpenaiApiASR): verbose_json with word+segment timestamps, optional
    translate task, VAD filtering of words inside no_speech_prob>0.8
    segments, and cost accounting in whole transcribed seconds.

    transport: callable(files, data) -> dict — injectable for tests;
    defaults to an HTTP multipart POST against ``base_url`` with
    ``OPENAI_API_KEY``.
    """

    sep = ""

    def __init__(self, language: str | None = "en", model: str = "whisper-1",
                 temperature: float = 0.0, base_url: str | None = None,
                 api_key: str | None = None, transport=None):
        self.modelname = model
        self.original_language = None if language == "auto" else language
        self.temperature = temperature
        self.task = "transcribe"
        self.use_vad_opt = False
        self.transcribed_seconds = 0
        self.base_url = (base_url or os.environ.get("OPENAI_BASE_URL")
                         or "https://api.openai.com/v1")
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.transport = transport or self._http_transport

    def use_vad(self) -> None:
        self.use_vad_opt = True

    def set_translate_task(self) -> None:
        self.task = "translate"

    def _http_transport(self, files: dict, data: dict) -> dict:
        import requests

        endpoint = ("translations" if self.task == "translate"
                    else "transcriptions")
        r = requests.post(
            f"{self.base_url}/audio/{endpoint}",
            headers={"Authorization": f"Bearer {self.api_key}"},
            files=files, data=data, timeout=120,
        )
        r.raise_for_status()
        return r.json()

    @staticmethod
    def _wav_bytes(audio: np.ndarray) -> bytes:
        import io
        import wave

        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SAMPLE_RATE)
            pcm = np.clip(audio, -1.0, 1.0)
            w.writeframes((pcm * 32767).astype("<i2").tobytes())
        return buf.getvalue()

    def transcribe(self, audio: np.ndarray, init_prompt: str = "") -> dict:
        import math

        self.transcribed_seconds += math.ceil(len(audio) / SAMPLE_RATE)
        data = {
            "model": self.modelname,
            "response_format": "verbose_json",
            "temperature": str(self.temperature),
            "timestamp_granularities[]": ["word", "segment"],
        }
        if self.task != "translate" and self.original_language:
            data["language"] = self.original_language
        if init_prompt:
            data["prompt"] = init_prompt
        files = {"file": ("audio.wav", self._wav_bytes(audio), "audio/wav")}
        return self.transport(files, data)

    def ts_words(self, res: dict) -> list[Word]:
        no_speech = []
        if self.use_vad_opt:
            for seg in res.get("segments", []) or []:
                if seg.get("no_speech_prob", 0.0) > 0.8:
                    no_speech.append((seg.get("start"), seg.get("end")))
        out = []
        for w in res.get("words", []) or []:
            if any(s[0] <= w["start"] <= s[1] for s in no_speech):
                continue
            out.append(Word(w["start"], w["end"], w["word"]))
        return out

    def segments_end_ts(self, res: dict) -> list[float]:
        return [w["end"] for w in res.get("words", []) or []]


def make_backend(name: str, **kw) -> ASRBackend:
    """The backend ``name`` names. "jax-whisper" (``ASRConfig.backend``'s
    default and the CLI's) builds TorchWhisperBackend: the name is the
    config's, kept so that one config drives both packages. An unknown name
    raises; no other backend is picked in its place."""
    if name == "jax-whisper":
        return TorchWhisperBackend(**kw)
    # device placement only applies to the on-device backend; the others are
    # host- or API-bound
    kw.pop("device", None)
    if name == "faster-whisper":
        return FasterWhisperBackend(**kw)
    if name == "openai-api":
        return OpenAIApiBackend(**kw)
    if name == "fake":
        return FakeBackend(kw.pop("script", []), **kw)
    raise ValueError(f"unknown ASR backend {name!r}")
