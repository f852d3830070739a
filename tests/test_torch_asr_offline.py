"""The port's offline ASR and its tools (mere_fusion_tpu_torch/asr/) against
the JAX package's.

Host code first: every text normalizer byte-equal to JAX's on a seeded
corpus (numbers from ``numwords._VOCAB``, every key of
``spelling.uk_to_us_mapping()``, symbols and diacritics); the txt/vtt/srt
writers byte-equal; ``simulate_streaming``'s emissions in the unaware mode and
``server.handle_connection``'s lines over a socket pair, on scripted
FakeBackend streams.

Then the device path at narrow widths with the full 51,865-token vocabulary
(the JAX init through convert.whisper_from_flax, as
tests/test_torch_asr_streaming.py): the batched beam decoder window by
window against the port's batch-1 decoder; ``transcribe_long``'s chunks,
text and duration against ``JaxWhisperBackend.transcribe_long``'s, greedy
and beam-3, with timestamps and without, three windows at batch size 2 (JAX
pads the last group, the port does not); both CLIs' ``main`` on a WAV with
the backends patched in. The decoder's final-norm bias leans toward EOT and
a few timestamp tokens lean toward EOT's embedding, so that windows of one
batch stop at different steps (some fill their pool, some reach the
buffer's end) and timestamp tokens appear among the text.
"""
from __future__ import annotations

import io
import random
import re
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from mere_fusion_tpu import asr as jasr
from mere_fusion_tpu.asr import __main__ as jmain
from mere_fusion_tpu.asr import backends as jbackends
from mere_fusion_tpu.asr import normalizers as jnorm
from mere_fusion_tpu.asr import numwords as jnum
from mere_fusion_tpu.asr import server as jserver
from mere_fusion_tpu.asr import simulate as jsim
from mere_fusion_tpu.asr import spelling as jspell
from mere_fusion_tpu.asr import writers as jwriters
from mere_fusion_tpu.models import whisper as jw
from mere_fusion_tpu_torch import asr as tasr
from mere_fusion_tpu_torch.asr import __main__ as tmain
from mere_fusion_tpu_torch.asr import backends as tbackends
from mere_fusion_tpu_torch.asr import normalizers as tnorm
from mere_fusion_tpu_torch.asr import numwords as tnum
from mere_fusion_tpu_torch.asr import server as tserver
from mere_fusion_tpu_torch.asr import simulate as tsim
from mere_fusion_tpu_torch.asr import spelling as tspell
from mere_fusion_tpu_torch.asr import writers as twriters
from mere_fusion_tpu_torch.convert import whisper_from_flax
from mere_fusion_tpu_torch.models import whisper as tw
from mere_fusion_tpu_torch.transport.line_packet import receive_one_line
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

SR = 16000


# ---- normalizers and writers ---------------------------------------------------------

def _corpus() -> list[str]:
    """Seeded sentences over the number vocabulary, the spelling table's keys,
    symbols, diacritics, contractions and asides."""
    rng = random.Random(21)
    numbers = sorted(jnum._VOCAB) + ["7", "42", "3.5", "0", "$5", "-8", "1,000", "half",
                                     "and", "a", "point", "oh", "double", "cents"]
    uk = sorted(jspell.uk_to_us_mapping())
    extra = ["café", "naïve", "Œuvre", "ßtraße", "façade", "—", "«quote»", "[noise]",
             "<cough>", "(laughs)", "uh", "um", "Mr.", "Dr.", "won't", "I'd", "she's",
             "y'all", "$20", "50%", "€3", "£7.50", "¢9", "1960s", "21st", "x²", "½",
             "♪", "-->", "it's", "Prof.", "ma'am", "o'clock", "B.C.", "—dash—"]
    out = [" ".join(uk[i:i + 12]) for i in range(0, len(uk), 12)]
    for _ in range(300):
        words = [rng.choice(numbers) for _ in range(rng.randint(1, 9))]
        words += [rng.choice(extra) for _ in range(rng.randint(0, 3))]
        rng.shuffle(words)
        out.append(" ".join(words))
    return out


@pytest.mark.parametrize("name", ["basic", "basic_diacritics", "basic_split", "english",
                                  "numbers", "spelling"])
def test_normalizers_byte_equal_jax(name):
    make = {
        "basic": lambda m: m.BasicTextNormalizer(),
        "basic_diacritics": lambda m: m.BasicTextNormalizer(remove_diacritics=True),
        "basic_split": lambda m: m.BasicTextNormalizer(remove_diacritics=True,
                                                       split_letters=True),
        "english": lambda m: m.EnglishTextNormalizer(),
        "numbers": lambda m: m.EnglishNumberNormalizer(),
        "spelling": lambda m: m.EnglishSpellingNormalizer(),
    }[name]
    mods = {"basic": (jnorm, tnorm), "basic_diacritics": (jnorm, tnorm),
            "basic_split": (jnorm, tnorm), "english": (jnorm, tnorm),
            "numbers": (jnum, tnum), "spelling": (jspell, tspell)}[name]
    ref, port = make(mods[0]), make(mods[1])
    corpus = _corpus()
    assert tspell.uk_to_us_mapping() == jspell.uk_to_us_mapping()
    for text in corpus:
        assert port(text).encode() == ref(text).encode(), text
    # the package re-exports the normalizers, as the JAX package does
    assert tasr.EnglishTextNormalizer is tnorm.EnglishTextNormalizer
    assert tasr.BasicTextNormalizer is tnorm.BasicTextNormalizer
    assert tasr.EnglishNumberNormalizer is tnum.EnglishNumberNormalizer
    assert tasr.EnglishSpellingNormalizer is tspell.EnglishSpellingNormalizer
    assert jasr.EnglishTextNormalizer is jnorm.EnglishTextNormalizer


SEGMENTS = [
    {"start": 0.0, "end": 1.234, "text": " Hello there. "},
    {"start": 61.5, "end": 65.0004, "text": "a --> b, c-->d"},
    {"start": 3599.9996, "end": 3725.5, "text": "the hour-long cue"},
    {"start": 7322.25, "end": 7330.0, "text": "   "},
]


@pytest.mark.parametrize("fmt", ["txt", "vtt", "srt"])
def test_writers_byte_equal_jax(fmt):
    outs = []
    for mod in (jwriters, twriters):
        buf = io.StringIO()
        mod.WRITERS[fmt](SEGMENTS, buf)
        outs.append(buf.getvalue().encode())
    assert outs[1] == outs[0]
    if fmt == "srt":
        assert b"01:00:00,000 --> 01:02:05,500" in outs[1] and b"a -> b, c->d" in outs[1]
    if fmt == "vtt":
        assert outs[1].startswith(b"WEBVTT\n") and b"01:00:00.000 --> 01:02:05.500" in outs[1]
    for sec in (0.0, 0.0004, 59.9996, 3600.0, 36000.123):
        for args in ((), (True, ","), (False, ".")):
            assert twriters.format_timestamp(sec, *args) == \
                jwriters.format_timestamp(sec, *args)
    assert twriters.compression_ratio("abc " * 50) == jwriters.compression_ratio("abc " * 50)
    chunks = [dict(s, tokens=[1, 2]) for s in SEGMENTS]
    assert twriters.chunks_to_segments(chunks) == jwriters.chunks_to_segments(chunks)


# ---- the streaming simulation and the socket server ----------------------------------

def _script(n_words: int, t0: float = 0.2, dt: float = 0.3):
    return [(t0 + i * dt, t0 + (i + 1) * dt - 0.05, f"w{i}." if i % 5 == 4 else f"w{i}")
            for i in range(n_words)]


@pytest.mark.parametrize("trimming", [("segment", 15.0), ("sentence", 3.0)])
def test_simulate_streaming_unaware_as_jax(trimming):
    results = []
    for pkg, sim in ((jasr, jsim), (tasr, tsim)):
        backend = pkg.FakeBackend(_script(30), jitter_last=True)
        st = pkg.StreamingTranscriber(backend, buffer_trimming=trimming)
        res = sim.simulate_streaming(st, np.zeros(11 * SR, np.float32), min_chunk=0.5,
                                     backend_offset_hook=backend.set_offset)
        results.append(([(e.emitted_at, e.beg, e.end, e.text) for e in res.emissions],
                        res.transcript, res.mean_latency))
    assert results[1] == results[0]
    assert "w0" in results[1][1] and "w29" in results[1][1]
    e = tsim.Emission(2.0, 1.0, 1.5, "x")
    assert e.latency == jsim.Emission(2.0, 1.0, 1.5, "x").latency == 0.5


class _Stepped:
    """A transcriber that signals each process_iter, so that the client
    sends the next half second only after the server has read the last one:
    every run then makes the same calls, whatever the socket's timing."""

    def __init__(self, inner):
        self.inner = inner
        self.stepped = threading.Semaphore(0)

    def insert_audio_chunk(self, pcm):
        self.inner.insert_audio_chunk(pcm)

    def process_iter(self):
        try:
            return self.inner.process_iter()
        finally:
            self.stepped.release()

    def finish(self):
        return self.inner.finish()


def _served_lines(pkg, server_mod, pcm: np.ndarray, piece: int) -> list[str]:
    """Stream PCM16 through server_mod.handle_connection on a socket pair
    with a FakeBackend transcriber, half a second at a time in pieces of
    ``piece`` bytes (odd sizes split samples); the lines the client receives."""
    backend = pkg.FakeBackend(_script(10), jitter_last=False)
    transcriber = _Stepped(pkg.StreamingTranscriber(backend))
    srv, client = socket.socketpair()

    def run():
        server_mod.handle_connection(srv, transcriber, min_chunk_seconds=0.5)
        srv.close()

    lines = []

    def read():          # a line is a whole 64 KiB packet: read while sending
        while (line := receive_one_line(client)) is not None:
            lines.append(line)

    threads = [threading.Thread(target=f, daemon=True) for f in (run, read)]
    for t in threads:
        t.start()
    data = pcm.tobytes()
    half = SR // 2 * 2
    for start in range(0, len(data), half):
        part = data[start:start + half]
        for i in range(0, len(part), piece):
            client.sendall(part[i:i + piece])
        if len(part) == half:
            assert transcriber.stepped.acquire(timeout=10)
    client.shutdown(socket.SHUT_WR)
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    client.close()
    return lines


def test_handle_connection_lines_as_jax():
    pcm = np.random.default_rng(0).integers(-3000, 3000, 4 * SR).astype(np.int16)
    port = _served_lines(tasr, tserver, pcm, 7001)
    assert port == _served_lines(jasr, jserver, pcm, 7001)
    assert port and all(ln.split()[0].isdigit() and ln.split()[1].isdigit() for ln in port)
    assert "w0" in " ".join(port)
    assert tserver.CHUNK_BYTES == jserver.CHUNK_BYTES


# ---- the device path against the JAX package ------------------------------------------

DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
            n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=2, n_text_layer=2)
WINDOW = 32 * 2 * 160          # the backend's fixed window at these dims: 0.64 s


class _Tok:
    """A stand-in tokenizer (as tests/test_torch_asr_streaming.py's): token
    t decodes to " t<t>" when t is even, else "~<t>"; encode maps each word
    to one id, so that the suppressed non-speech set is not empty."""

    def decode(self, toks):
        t = int(toks[0])
        return f" t{t}" if t % 2 == 0 else f"~{t}"

    def encode(self, s):
        return [sum(s.encode()) % 50000 for s in s.split()] or [0]


@pytest.fixture(scope="module")
def weights():
    jdims, tdims = jw.WhisperDims(**DIMS), tw.WhisperDims(**DIMS)
    model = jw.Whisper(jdims)
    variables = jax.jit(model.init)(jax.random.key(1), jnp.zeros((1, 80, 64)),
                                    jnp.zeros((1, 4), jnp.int32))
    variables = jax.tree_util.tree_map(np.array, variables)
    dec = variables["params"]["decoder"]
    eot = dec["token_embedding"]["embedding"][jw.EOT].copy()
    dec["ln"]["bias"] = (dec["ln"]["bias"] + 4.5 * eot / (eot @ eot)).astype(np.float32)
    dec["token_embedding"]["embedding"][jw.TIMESTAMP_BEGIN::100] += 0.5 * eot
    return variables, whisper_from_flax(variables, tdims), jdims, tdims


def _speech(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 140 * (1 + 0.3 * t)
    pcm = sum(0.12 / k * np.sin(2 * np.pi * k * f0 * t) for k in (1, 2, 3))
    return (pcm + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


# three windows, the last one partial
AUDIO = np.concatenate([_speech(0.64, 0) * 0.5, _speech(0.64, 1), _speech(0.3, 2) * 1.5])


@pytest.fixture(scope="module")
def backends(weights):
    """(JAX, port) backends, greedy with the stand-in tokenizer and beam-3
    with none, built once: the JAX ones keep their compiled decodes."""
    variables, state, jdims, tdims = weights
    out = {}
    for name, kw in (("greedy", dict(beam_size=1, tokenizer=_Tok())),
                     ("beam3", dict(beam_size=3, tokenizer=None))):
        kw.update(temperatures=(0.0,))
        out[name] = (jbackends.JaxWhisperBackend(variables=variables, dims=jdims, **kw),
                     tbackends.TorchWhisperBackend(state_dict=state, dims=tdims,
                                                   device=torch.device("cpu"), **kw))
    return out


def test_batched_beam_decoder_equals_batch_1_per_window(weights):
    """Four windows on one batch against each window alone: some fill
    their pool (and leave the batch) at different steps, some reach the
    buffer's end."""
    _, state, _, tdims = weights
    model = tw.Whisper(tdims)
    model.load_state_dict(state)
    model.eval()
    audio = np.concatenate([_speech(0.64, s) * (0.3 + 0.4 * s) for s in range(4)])
    from mere_fusion_tpu_torch.ops.mel import melspectrogram, whisper_mel_config

    with torch.no_grad():
        mels = melspectrogram(torch.from_numpy(audio).view(4, WINDOW), whisper_mel_config(80))
        xa = model.encode(mels)
    prompt = torch.tensor([tw.sot_sequence(0)])
    decode = tw.make_cached_beam_decoder(model, beam_size=3, max_new_tokens=24,
                                         return_scores=True)
    toks, avg, ns = decode(xa, prompt.expand(4, -1), 4)
    steps = decode.stats["steps"]
    assert toks.shape == (4, 28) and avg.shape == ns.shape == (4,)
    lengths = []
    for b in range(4):
        one = decode(xa[b:b + 1], prompt, 4)
        np.testing.assert_array_equal(one[0][0].numpy(), toks[b].numpy())
        assert float(one[1][0]) == pytest.approx(float(avg[b]), abs=1e-5)
        assert float(one[2][0]) == pytest.approx(float(ns[b]), abs=1e-6)
        lengths.append(int((toks[b, 4:] != tw.EOT).sum()))
    # windows that stop early and one that runs to the buffer's end
    assert min(lengths) < 24 and max(lengths) == 24 and len(set(lengths)) > 2, lengths
    assert steps == 27


def _chunks(res: dict):
    return [(c["start"], c["end"], c["tokens"], c["text"]) for c in res["chunks"]]


@pytest.mark.parametrize("timestamps", [False, True], ids=["plain", "timestamps"])
@pytest.mark.parametrize("kind", ["greedy", "beam3"])
def test_transcribe_long_matches_jax(backends, kind, timestamps):
    jax_be, port_be = backends[kind]
    res_t = port_be.transcribe_long(AUDIO, batch_size=2, timestamps=timestamps)
    res_j = jax_be.transcribe_long(AUDIO, batch_size=2, timestamps=timestamps)
    assert _chunks(res_t) == _chunks(res_j)
    assert res_t["text"] == res_j["text"]
    assert res_t["duration"] == res_j["duration"] == len(AUDIO) / SR
    assert set(res_t) == {"chunks", "text", "duration"}
    assert res_t["chunks"][-1]["end"] <= res_t["duration"]
    if timestamps:
        assert (port_be._ts_decode is not None
                and port_be._ts_decoder() is port_be._ts_decoder())
        if kind == "greedy":      # the tokenizer's non-speech set joins <|notimestamps|>
            assert port_be._suppress and jw.NO_TIMESTAMPS not in port_be._suppress
    lengths = [len(c["tokens"]) for c in res_t["chunks"]]
    assert any(lengths), lengths


def _run_main(mod, pkg, backend, argv, monkeypatch, capsys):
    seen = {}

    def make_backend(name, **kw):
        seen.update(kw, name=name)
        return backend

    monkeypatch.setattr(pkg, "make_backend", make_backend)
    mod.main(argv)
    out = capsys.readouterr().out
    return re.sub(r"in [0-9.]+ s \([0-9.]+x realtime\)", "in T s (Rx realtime)", out), seen


@pytest.mark.parametrize("mode", ["offline", "unaware", "batch"])
def test_cli_matches_jax(backends, tmp_path, monkeypatch, capsys, mode):
    jax_be, port_be = backends["beam3"]
    wav = tmp_path / "in.wav"
    wavfile.write(wav, SR, (AUDIO * 32767).astype(np.int16))
    fmt = {"offline": "txt", "unaware": "vtt", "batch": "srt"}[mode]
    outs = []
    for mod, pkg, be, extra in ((jmain, jasr, jax_be, []),
                                (tmain, tasr, port_be, ["--device", "cpu"])):
        path = tmp_path / f"{mod.__name__}.{fmt}"
        argv = [str(wav), "--mode", mode, "--batch-size", "2", "--beam-size", "3",
                "--min-chunk-size", "0.5", "--output-format", fmt,
                "--output-file", str(path)] + extra
        out, seen = _run_main(mod, pkg, be, argv, monkeypatch, capsys)
        outs.append((out, path.read_bytes(), seen))
    (out_j, file_j, seen_j), (out_t, file_t, seen_t) = outs
    assert out_t == out_j and file_t == file_j
    assert seen_t == dict(seen_j, device="cpu") == dict(
        name="jax-whisper", language="en", beam_size=3, device="cpu")
    assert out_t.strip()
    if mode == "batch":
        assert "(Rx realtime)" in out_t and file_t.startswith(b"1\n00:00:00,000 --> ")


def test_cli_flags_load_wav_and_device(tmp_path, monkeypatch, capsys):
    helps = []
    for mod in (jmain, tmain):
        with pytest.raises(SystemExit):
            mod.main(["--help"])
        helps.append(set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out)))
    assert helps[1] == helps[0] | {"--device"}
    # an 8 kHz stereo int16 file: the first channel, resampled to 16 kHz
    rng = np.random.default_rng(5)
    path = tmp_path / "st.wav"
    wavfile.write(path, 8000, rng.integers(-9000, 9000, (4000, 2)).astype(np.int16))
    loaded = tmain.load_wav_16k(str(path))
    np.testing.assert_array_equal(loaded, jmain.load_wav_16k(str(path)))
    assert loaded.dtype == np.float32 and len(loaded) == 8000
    # no card and no --device: the backend raises, as TorchWhisperBackend does
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main([str(path), "--mode", "offline"])
