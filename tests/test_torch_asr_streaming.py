"""The port's streaming ASR (mere_fusion_tpu_torch/asr/, utils/bpe.py)
against the JAX package's.

Host code first: the LCP commit of HypothesisBuffer and StreamingTranscriber
on scripted FakeBackend streams, the energy VAD, DTW token times and word
merging, the timestamp segmenter, the BPE codec on a toy vocabulary. Then
the device backend: TorchWhisperBackend.transcribe against
JaxWhisperBackend.transcribe on the same weights (narrow widths, the full
51,865-token vocabulary, from the JAX init through convert.whisper_from_flax)
and audio: the same tokens and result fields, unprompted, on a prompted
second window, with VAD skipping silence, and with the temperature ladder
forced by a low compression-ratio threshold. The ladder's sampled rungs use
a temperature so small (1e-7) that the Gumbel noise cannot move an argmax,
so that the two packages' different random streams pick the same tokens.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mere_fusion_tpu import asr as jasr
from mere_fusion_tpu.asr import align as jalign
from mere_fusion_tpu.asr import backends as jbackends
from mere_fusion_tpu.asr import vad as jvad
from mere_fusion_tpu.models import whisper as jw
from mere_fusion_tpu.utils import bpe as jbpe
from mere_fusion_tpu_torch import asr as tasr
from mere_fusion_tpu_torch.asr import align as talign
from mere_fusion_tpu_torch.asr import backends as tbackends
from mere_fusion_tpu_torch.asr import vad as tvad
from mere_fusion_tpu_torch.convert import whisper_from_flax
from mere_fusion_tpu_torch.models import whisper as tw
from mere_fusion_tpu_torch.utils import bpe as tbpe
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

SR = 16000


def make_script(words, t0=0.2, dt=0.3):
    return [(t0 + i * dt, t0 + (i + 1) * dt - 0.05, w) for i, w in enumerate(words)]


def _stream(pkg, script, seconds: float, min_chunk: float, trimming, jitter=True):
    """Feed ``seconds`` of audio to pkg's StreamingTranscriber over a
    FakeBackend script in min_chunk steps; the committed (beg, end, text)
    of every step and of finish(), and the final buffer offset."""
    backend = pkg.FakeBackend(script, jitter_last=jitter)
    st = pkg.StreamingTranscriber(backend, buffer_trimming=trimming)
    audio = np.zeros(int(seconds * SR), np.float32)
    step = int(min_chunk * SR)
    out = []
    for start in range(0, len(audio), step):
        st.insert_audio_chunk(audio[start:start + step])
        backend.set_offset(st.buffer_time_offset)
        out.append(st.process_iter())
    out.append(st.finish())
    return out, st.buffer_time_offset, st.prompt()


def test_hypothesis_buffer_commits_as_jax():
    hyps = [
        ([(0.0, 0.5, "hello"), (0.5, 1.0, "world")], 0.0),
        ([(0.0, 0.5, "hello"), (0.5, 1.0, "there")], 0.0),
        ([(0.1, 0.5, "hello"), (0.5, 1.0, "there"), (1.0, 1.4, "friend")], 0.4),
        ([(0.1, 0.6, "there"), (0.6, 1.0, "friend"), (1.0, 1.5, "again")], 0.5),
        ([(0.1, 0.6, "friend"), (0.6, 1.1, "again")], 0.9),
    ]
    commits = {}
    for name, pkg in (("jax", jasr), ("port", tasr)):
        hb = pkg.HypothesisBuffer()
        log = []
        for words, offset in hyps:
            hb.insert([pkg.Word(*w) for w in words], offset)
            log.append([(w.beg, w.end, w.text) for w in hb.flush()])
        hb.pop_committed(1.0)
        log.append([(w.beg, w.end, w.text) for w in hb.committed_in_buffer + hb.complete()])
        commits[name] = (log, hb.last_committed_time, hb.last_committed_word)
    assert commits["port"] == commits["jax"]
    assert any(commits["port"][0][:-1])


@pytest.mark.parametrize("case", [
    ("segment", 15.0, 40, 0.4, 1.0, False),
    ("segment", 15.0, 5, 0.3, 0.5, True),
    ("sentence", 4.0, 30, 0.35, 1.0, False),
], ids=["segment_trim", "jitter", "sentence_trim"])
def test_streaming_transcriber_commits_as_jax(case):
    way, sec, n_words, dt, min_chunk, jitter = case
    words = [f"W{i}." if i % 7 == 6 else f"W{i}" for i in range(n_words)]
    script = make_script(words, dt=dt)
    seconds = 0.2 + n_words * dt + 1.0
    port = _stream(tasr, script, seconds, min_chunk, (way, sec), jitter)
    assert port == _stream(jasr, script, seconds, min_chunk, (way, sec), jitter)
    text = " ".join(t for _, _, t in port[0] if t)
    assert all(w in text for w in words[:3])
    if n_words >= 30:
        assert port[1] > 0          # the buffer was trimmed


def test_vad_segments_and_word_filter_as_jax():
    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    audio = np.zeros(3 * SR, np.float32)
    audio[SR:2 * SR] = 0.3 * np.sin(2 * np.pi * 440 * t)
    audio[int(2.5 * SR):int(2.6 * SR)] = 0.2 * rng.standard_normal(int(0.1 * SR))
    loud = (0.2 * (1.0 + 0.2 * np.sin(2 * np.pi * 3 * t))
            * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    for x in (audio, loud, np.zeros(SR, np.float32),
              rng.normal(0, 1e-4, SR).astype(np.float32)):
        assert tvad.speech_segments(x) == jvad.speech_segments(x)
        assert tvad.has_speech(x) == jvad.has_speech(x)
    segs = tvad.speech_segments(audio)
    assert segs and segs[0][0] == pytest.approx(1.0, abs=0.15)
    words = [(0.1, 0.4, "a"), (1.1, 1.4, "b"), (2.5, 2.9, "c")]
    for spans in (segs, [(1.0, 2.0)], None):
        kept_t = tvad.filter_words([tasr.Word(*w) for w in words], spans)
        kept_j = jvad.filter_words([jasr.Word(*w) for w in words], spans)
        assert [(w.beg, w.end, w.text) for w in kept_t] == \
            [(w.beg, w.end, w.text) for w in kept_j]


class _Tok:
    """A stand-in tokenizer: token t decodes to " t<t>" (a word start) when
    t is even, else "~<t>" (a continuation); encode maps each word of the
    text to one id."""

    def decode(self, toks):
        t = int(toks[0])
        return f" t{t}" if t % 2 == 0 else f"~{t}"

    def encode(self, s):
        return [sum(s.encode()) % 50000 for s in s.split()] or [0]


def test_dtw_token_times_and_words_as_jax():
    rng = np.random.default_rng(3)
    n_prompt, n_text, frames = 4, 9, 60
    attn = rng.random((4, 1, 2, n_prompt + n_text + 3, 80)).astype(np.float32)
    # a diagonal the DTW path must follow
    for k in range(n_text):
        attn[:, :, :, n_prompt + k, 5 * k + 3] += 4.0
    np.testing.assert_array_equal(talign.median_filter(attn[0, 0], 7),
                                  jalign.median_filter(attn[0, 0], 7))
    cost = -rng.random((6, 14))
    for a, b in zip(talign.dtw_path(cost), jalign.dtw_path(cost)):
        np.testing.assert_array_equal(a, b)
    starts = talign.token_times(attn, n_prompt, frames)
    np.testing.assert_array_equal(starts, jalign.token_times(attn, n_prompt, frames))
    assert (np.diff(starts[:n_text]) >= 0).all()
    tokens = rng.integers(0, 1000, n_text).tolist()
    words = talign.words_with_times(tokens, starts[:n_text], _Tok(), 1.2)
    assert words == jalign.words_with_times(tokens, starts[:n_text], _Tok(), 1.2)
    flat = [b for w in words for b in w[:2]]
    assert flat == sorted(flat) and len(words) == sum(t % 2 == 0 for t in tokens[1:]) + 1


def test_timestamp_segments_as_jax():
    tb = 1000
    ts = lambda sec: tb + int(round(sec / 0.02))  # noqa: E731
    cases = [
        ([ts(0.0), 1, 2, ts(1.0), ts(1.0), 3, ts(2.5)], tb, 30.0),
        ([5, 6, ts(0.4), 7, ts(9.0), ts(1.0), 8], tb, 5.0),
        ([1, 2, 3], None, 30.0),
        ([], tb, 30.0),
    ]
    for toks, begin, window in cases:
        assert tbackends.timestamp_segments(toks, begin, window) == \
            jbackends.timestamp_segments(toks, begin, window)
    assert tbackends.timestamp_segments(*cases[0]) == [(0.0, 1.0, [1, 2]), (1.0, 2.5, [3])]


def test_bpe_codec_as_jax():
    vocab = {"h": 0, "e": 1, "l": 2, "o": 3, "he": 4, "ll": 5, "hell": 6, "Ġ": 7,
             "w": 8, "r": 9, "d": 10, "Ġw": 11, "or": 12, "Ġwor": 13, "ld": 14, "!": 15}
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("Ġ", "w"), ("o", "r"),
              ("Ġw", "or"), ("l", "d")]
    special = {"<|endoftext|>": 16}
    port = tbpe.BPETokenizer(vocab, merges, special)
    ref = jbpe.BPETokenizer(vocab, merges, special)
    for text in ("hello", "hello world!", "world hello", "held"):
        assert port.encode(text) == ref.encode(text)
        assert port.decode(port.encode(text)) == ref.decode(ref.encode(text)) == text
    assert port.encode("hello") == [6, 3]
    assert port.decode([6, 16, 3], skip_special=False) == "hell<|endoftext|>o"


# ---- the device backend against JaxWhisperBackend ------------------------------------

DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2)
WINDOW = 32 * 2 * 160          # the backend's fixed window at these dims: 0.64 s


@pytest.fixture(scope="module")
def weights():
    jdims, tdims = jw.WhisperDims(**DIMS), tw.WhisperDims(**DIMS)
    model = jw.Whisper(jdims)
    variables = jax.jit(model.init)(jax.random.key(1), jnp.zeros((1, 80, 64)),
                                    jnp.zeros((1, 4), jnp.int32))
    variables = jax.tree_util.tree_map(np.array, variables)
    return variables, whisper_from_flax(variables, tdims), jdims, tdims


def _speech(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 140 * (1 + 0.3 * t)
    pcm = sum(0.12 / k * np.sin(2 * np.pi * k * f0 * t) for k in (1, 2, 3))
    return (pcm + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def _backends(weights, **kw):
    variables, state, jdims, tdims = weights
    jax_be = jbackends.JaxWhisperBackend(variables=variables, dims=jdims, **kw)
    port_be = tbackends.TorchWhisperBackend(state_dict=state, dims=tdims,
                                            device=torch.device("cpu"), **kw)
    return jax_be, port_be


FIELDS = ("duration", "temperature", "language", "speech")


def _assert_same(res_t: dict, res_j: dict) -> None:
    assert set(res_t) == set(res_j)
    assert res_t["tokens"] == res_j["tokens"]
    for k in FIELDS:
        assert res_t.get(k) == res_j.get(k), k
    for k in ("avg_logprob", "no_speech_prob"):
        if k in res_j:
            assert res_t[k] == pytest.approx(res_j[k], abs=1e-5), k
    if res_j["starts"] is None:
        assert res_t["starts"] is None
    else:
        np.testing.assert_array_equal(res_t["starts"], res_j["starts"])


def test_backend_transcribe_unprompted_as_jax(weights):
    jax_be, port_be = _backends(weights, tokenizer=None, temperatures=(0.0,))
    assert port_be.model.decoder.token_embedding.weight.device.type == "cpu"
    audio = _speech(0.5)
    res_t, res_j = port_be.transcribe(audio), jax_be.transcribe(audio)
    _assert_same(res_t, res_j)
    assert res_t["tokens"] and res_t["starts"] is None
    words = port_be.ts_words(res_t)
    assert [(w.beg, w.end, w.text) for w in words] == \
        [(w.beg, w.end, w.text) for w in jax_be.ts_words(res_j)]
    assert port_be.segments_end_ts(res_t) == [0.5]


def test_backend_transcribe_prompted_second_window_with_word_times_as_jax(weights):
    """A stand-in tokenizer turns on the prompt bucket, the suppressed
    tokens and the DTW word times."""
    jax_be, port_be = _backends(weights, tokenizer=_Tok(), temperatures=(0.0,),
                                logprob_threshold=None, no_speech_threshold=None)
    audio = _speech(1.0, seed=1)
    first = port_be.transcribe(audio[:WINDOW // 2])
    _assert_same(first, jax_be.transcribe(audio[:WINDOW // 2]))
    prompt = "".join(port_be._token_text(t) for t in first["tokens"][:6])
    seq_t, plen_t = port_be._build_prompt(prompt)
    assert (seq_t, plen_t) == jax_be._build_prompt(prompt)
    assert len(seq_t) == 1 + port_be.prompt_bucket + 4 and plen_t > 4
    res_t, res_j = port_be.transcribe(audio, prompt), jax_be.transcribe(audio, prompt)
    _assert_same(res_t, res_j)
    assert res_t["tokens"] and res_t["starts"] is not None
    assert [(w.beg, w.end, w.text) for w in port_be.ts_words(res_t)] == \
        [(w.beg, w.end, w.text) for w in jax_be.ts_words(res_j)]


def test_backend_vad_skips_silence_as_jax(weights):
    jax_be, port_be = _backends(weights, tokenizer=None, temperatures=(0.0,))
    for be in (jax_be, port_be):
        be.use_vad()
    decodes = []
    decode = port_be._decode
    port_be._decode = lambda *a: (decodes.append(1), decode(*a))[1]
    silence = np.zeros(SR // 2, np.float32)
    res_t = port_be.transcribe(silence)
    assert res_t == jax_be.transcribe(silence) and res_t["tokens"] == [] and not decodes
    assert port_be.ts_words(res_t) == []
    half = np.concatenate([_speech(0.3, seed=2), np.zeros(int(0.3 * SR), np.float32)])
    res_t, res_j = port_be.transcribe(half), jax_be.transcribe(half)
    _assert_same(res_t, res_j)
    assert decodes == [1] and res_t["speech"]
    words = port_be.ts_words(res_t)
    assert [(w.beg, w.end, w.text) for w in words] == \
        [(w.beg, w.end, w.text) for w in jax_be.ts_words(res_j)]
    assert all(any(w.beg < e and w.end > b for b, e in res_t["speech"]) for w in words)


def test_backend_forced_ladder_as_jax(weights):
    jax_be, port_be = _backends(weights, tokenizer=None, temperatures=(0.0, 1e-7, 2e-7),
                                compression_ratio_threshold=0.5, logprob_threshold=None,
                                best_of=3)
    rungs = []
    sampler = tw.make_cached_sampling_decoder(port_be.model, best_of=3, max_new_tokens=128)
    port_be._sampler = lambda *a: (rungs.append(a[3]), sampler(*a))[1]
    audio = _speech(0.6, seed=3)
    res_t, res_j = port_be.transcribe(audio), jax_be.transcribe(audio)
    _assert_same(res_t, res_j)
    assert res_t["temperature"] == 2e-7 and rungs == [1e-7, 2e-7]
    assert port_be._sample_seed == jax_be._sample_seed == 2


def test_backend_runs_on_cuda_unless_asked_for_the_cpu(weights, monkeypatch):
    _, state, _, tdims = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbackends.TorchWhisperBackend(state_dict=state, dims=tdims)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbackends.make_backend("jax-whisper", dims=tdims)
    with pytest.raises(ValueError, match="unknown ASR backend"):
        tbackends.make_backend("whisper", device="cpu")
    be = tbackends.make_backend("jax-whisper", dims=tdims, device="cpu", tokenizer=None)
    assert isinstance(be, tbackends.TorchWhisperBackend) and be.beam_size == 5
    res = be.transcribe_long(np.zeros(SR // 2, np.float32), timestamps=False)
    assert res["duration"] == 0.5 and len(res["chunks"]) == 1
    assert res["chunks"][0]["start"] == 0.0 and res["chunks"][0]["end"] == 0.5
