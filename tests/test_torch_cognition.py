"""The port's cognition plane (brain/, llm/, perception/ stub,
server/upstream.py's processors, Session.ensure_upstream, the CLI's
--asr_backend/--llm flags) against the JAX package's.

The caller's speech → SpeechUpstream → StreamingTranscriber → BrainSession →
the LLM → phrases → engine.put_msg_txt, with scripted FakeBackend words and
EchoLLM, on stand-in engines; the session's plane built on its device with
the default config (whisper-tiny, beam 5) on the CPU.
"""
from __future__ import annotations

import asyncio
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mere_fusion_tpu import brain as jbrain
from mere_fusion_tpu import llm as jllm
from mere_fusion_tpu import perception as jperception
from mere_fusion_tpu.asr import FakeBackend as JaxFakeBackend
from mere_fusion_tpu.asr import StreamingTranscriber as JaxStreamingTranscriber
from mere_fusion_tpu.cli import build_parser as jax_build_parser
from mere_fusion_tpu.cli import config_from_args as jax_config_from_args
from mere_fusion_tpu.server import upstream as jupstream
from mere_fusion_tpu.utils import env as jenv
from mere_fusion_tpu_torch import brain, cli, llm, perception
from mere_fusion_tpu_torch.asr import FakeBackend, StreamingTranscriber, TorchWhisperBackend
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.models.whisper import TINY
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.server import upstream
from mere_fusion_tpu_torch.server.sessions import Session
from mere_fusion_tpu_torch.utils import env

CPU = torch.device("cpu")
SCRIPT = [(0.2 + 0.3 * i, 0.45 + 0.3 * i, w)
          for i, w in enumerate(["nice", "to", "meet", "you", "today"])]


class _Engine:
    """A stand-in engine: the phrases put on its TTS, in order."""

    def __init__(self, device=None):
        self.device = device
        self.phrases: list[str] = []
        self.paused = 0

    def put_msg_txt(self, msg: str) -> None:
        self.phrases.append(msg)

    def pause_talk(self) -> None:
        self.paused += 1


def _wait(cond, seconds: float = 10.0) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.01)


@pytest.mark.parametrize("chunks", [
    ["Hello there. ", "How are ", "you doing today? I am fine! ", "Bye"],
    ["no delimiter at all in this rather long stream of words " * 3],
    ["你好。", "今天天气很好！", "我们走吧？", "short"],
    ["A. B? C! " * 30],
], ids=["latin", "long_no_delimiter", "cjk", "many"])
@pytest.mark.parametrize("min_len", [5, 40])
def test_split_phrases_as_jax(chunks, min_len):
    assert list(brain.split_phrases(chunks, min_len)) == \
        list(jbrain.split_phrases(chunks, min_len))


def test_brain_session_puts_phrases_as_jax():
    phrases, messages = {}, {}
    for name, pkg, llm_pkg in (("port", brain, llm), ("jax", jbrain, jllm)):
        echo = llm_pkg.EchoLLM("I heard {text}. Thanks for calling. Bye now. ")
        seen = []
        stream = echo.stream_chat
        echo.stream_chat = lambda m, s=stream, seen=seen: (seen.append(m), s(m))[1]
        engine = _Engine()
        session = pkg.BrainSession(engine, echo, min_phrase_len=5)
        session.video_produce("640x480 bright scene, static scene")
        session.video_produce("640x480 dim scene, movement detected")
        session.text_produce("hello there")
        _wait(lambda: len(engine.phrases) >= 3)
        session.interrupt()
        assert engine.paused == 1
        session.close()
        assert not session._thread.is_alive()
        phrases[name], messages[name] = engine.phrases, seen
    assert phrases["port"] == phrases["jax"]
    assert messages["port"] == messages["jax"]
    assert brain.PERSONA_PROMPT == jbrain.orchestrator.PERSONA_PROMPT
    assert "scene: 640x480 dim scene, movement detected" in messages["port"][0][1]["content"]


def _feed_speech(up, n_frames: int) -> None:
    """20 ms int16 frames, frame k at the constant level k + 1."""
    for k in range(n_frames):
        frame = np.full(320, k + 1, np.int16)
        if k % 2:
            up.process_pcm16(frame.tobytes())
        else:
            up.process_pcm(frame.astype(np.float32) / 32768.0)
    up.finish()


def test_speech_upstream_commits_into_the_brain_as_jax():
    texts = {}
    before = metrics.latency("asr.process_iter").count
    for name, up_mod, fake, st in (("port", upstream, FakeBackend, StreamingTranscriber),
                                   ("jax", jupstream, JaxFakeBackend,
                                    JaxStreamingTranscriber)):
        got = []
        sink = SimpleNamespace(text_produce=got.append)
        transcriber = st(fake(SCRIPT, jitter_last=True))
        up = up_mod.SpeechUpstream(transcriber, sink, min_chunk_seconds=0.5)
        _feed_speech(up, 100)
        texts[name] = (got, transcriber.audio_buffer)
    assert texts["port"][0] == texts["jax"][0]
    np.testing.assert_array_equal(texts["port"][1], texts["jax"][1])
    assert "nice" in " ".join(texts["port"][0]) and "today" in texts["port"][0][-1]
    assert metrics.latency("asr.process_iter").count == before + 4   # 2 s in 0.5 s chunks


def test_video_upstream_and_stub_perception_as_jax():
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(6)]
    frames += [np.full((48, 64, 3), 200, np.uint8)] * 3
    out = {}
    for name, up_mod, pmod in (("port", upstream, perception), ("jax", jupstream, jperception)):
        got = []
        up = up_mod.VideoUpstream(pmod.make_perception("stub", fps_throttle=2),
                                  SimpleNamespace(video_produce=got.append))
        for f in frames:
            up.process_frame(f)
        out[name] = got
    assert out["port"] == out["jax"] and len(out["port"]) == 4
    for kind in ("yolo", "yolo-tpu"):
        with pytest.raises(NotImplementedError, match="'Perception'"):
            perception.make_perception(kind)
    with pytest.raises(ValueError, match="unknown perception"):
        perception.make_perception("cctv")


def test_session_with_llm_builds_the_plane_on_its_device():
    session = Session("s", engine=_Engine(CPU), cfg=Config(), llm=llm.EchoLLM())
    session.ensure_upstream()
    backend = session.speech_upstream.transcriber.backend
    assert isinstance(backend, TorchWhisperBackend)
    assert backend.dims == TINY and backend.beam_size == 5 and backend.language == "en"
    assert {p.device for p in backend.model.parameters()} == {CPU}
    assert session.speech_upstream.min_chunk == Config().asr.min_chunk_seconds
    assert session.speech_upstream.transcriber.trim_sec == Config().asr.buffer_trim_seconds
    assert isinstance(session.video_upstream.perception, perception.StubPerception)
    assert session.video_upstream.brain is session.brain is session.speech_upstream.brain
    plane = session.speech_upstream
    session.ensure_upstream()                   # built once
    assert session.speech_upstream is plane
    asyncio.run(session.close())
    assert not session.brain._thread.is_alive()

    # no fallback: a detector that is not ported, or an unknown ASR backend, raises
    cfg = Config().override(**{"perception.backend": "yolo-tpu"})
    session = Session("y", engine=_Engine(CPU), cfg=cfg, llm=llm.EchoLLM(),
                      asr_backend=FakeBackend([]))
    with pytest.raises(NotImplementedError, match="'Perception'"):
        session.ensure_upstream()
    session.brain.close()
    cfg = Config().override(**{"asr.backend": "whisper-cpp"})
    session = Session("w", engine=_Engine(CPU), cfg=cfg, llm=llm.EchoLLM())
    with pytest.raises(ValueError, match="unknown ASR backend"):
        session.ensure_upstream()
    session.brain.close()


class _AudioFrame:
    sample_rate = 16000

    def __init__(self, level: int):
        self.level = level

    def to_ndarray(self, **kw):
        return np.full((1, 320), self.level, np.int16)


class _AudioTrack:
    kind = "audio"

    def __init__(self, n: int):
        self.levels = list(range(1, n + 1))

    async def recv(self):
        if not self.levels:
            await asyncio.sleep(3600)       # the caller went quiet
        await asyncio.sleep(0)
        return _AudioFrame(self.levels.pop(0))


def test_session_reader_runs_chunks_off_the_loop_in_order_into_the_engine():
    """A session with an LLM: its audio reader drives SpeechUpstream →
    StreamingTranscriber → BrainSession → engine.put_msg_txt, each chunk's
    transcription on an executor thread, the chunks in arrival order."""
    calls = []

    class Backend(FakeBackend):
        def transcribe(self, audio, init_prompt=""):
            calls.append((threading.get_ident(), len(audio)))
            return super().transcribe(audio, init_prompt)

    engine = _Engine(CPU)
    cfg = Config().override(**{"asr.min_chunk_seconds": 0.5})
    session = Session("r", engine=engine, cfg=cfg, llm=llm.EchoLLM("I heard {text}. "),
                      asr_backend=Backend(SCRIPT, jitter_last=False))
    n = 100                                    # 2 s of 20 ms frames

    async def drive():
        session.player = SimpleNamespace(stop=lambda: None)
        loop_thread = threading.get_ident()
        task = upstream.attach_upstream_track(session, _AudioTrack(n))
        session._consumers.append(task)
        for _ in range(1000):
            if len(calls) == 4 and engine.phrases:
                break
            await asyncio.sleep(0.01)
        await session.close()
        assert task.cancelled()
        return loop_thread

    loop_thread = asyncio.run(drive())
    assert [c[1] for c in calls] == [8000, 16000, 24000, 32000]
    assert all(tid != loop_thread for tid, _ in calls)
    levels = np.repeat(np.arange(1, n + 1), 320).astype(np.float32) / 32768.0
    np.testing.assert_array_equal(session.speech_upstream.transcriber.audio_buffer, levels)
    assert engine.phrases and engine.phrases[0].startswith("I heard text: nice scene:")


def test_cli_flags_reach_the_config_and_make_llm(monkeypatch, tmp_path):
    argv = ["--asr_backend", "openai-api", "--llm", "openai", "--llm_url",
            "http://127.0.0.1:9/v1", "--llm_model", "tiny-chat"]
    args = cli.build_parser().parse_args(argv)
    assert cli.config_from_args(args).asr.backend == "openai-api"
    assert jax_config_from_args(jax_build_parser().parse_args(argv)).asr.backend == "openai-api"
    assert cli.config_from_args(cli.build_parser().parse_args([])).asr.backend == "jax-whisper"
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    (tmp_path / ".env").write_text("OPENAI_API_KEY=sk-dotenv\n")
    served = {}
    from mere_fusion_tpu_torch.server import app

    monkeypatch.setattr(app, "run_server",
                        lambda cfg, factory, llm=None, devices=None: served.update(
                            cfg=cfg, llm=llm, devices=devices))
    cli.main(argv + ["--device", "cpu"])
    made = served["llm"]
    assert isinstance(made, llm.OpenAICompatLLM)
    assert (made.base_url, made.model, made.api_key) == (
        "http://127.0.0.1:9/v1", "tiny-chat", "sk-dotenv")
    assert served["cfg"].asr.backend == "openai-api" and served["devices"] == [CPU]
    assert isinstance(cli.make_llm_from_args(cli.build_parser().parse_args(
        ["--llm", "echo"])), llm.EchoLLM)
    assert cli.make_llm_from_args(cli.build_parser().parse_args([])) is None
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--asr_backend", "whisper-cpp"])


def test_dotenv_and_make_llm_as_jax(monkeypatch, tmp_path):
    path = tmp_path / ".env"
    path.write_text("# keys\nexport A_KEY='a b'\nB_KEY=plain # comment\nC_KEY=\"q#x\"\n"
                    "bad line\n=novalue\nD_KEY=keep\n")
    for k in ("A_KEY", "B_KEY", "C_KEY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("D_KEY", "env")
    assert env.load_dotenv(str(path)) == jenv.load_dotenv(str(path))
    assert (os.environ["A_KEY"], os.environ["B_KEY"], os.environ["C_KEY"],
            os.environ["D_KEY"]) == ("a b", "plain", "q#x", "env")
    assert env.load_dotenv(str(tmp_path / "missing")) == {}
    assert env.env_api_key("NOPE_KEY", "A_KEY") == jenv.env_api_key("NOPE_KEY", "A_KEY")
    monkeypatch.setenv("GEMINI_API_KEY", "g")
    monkeypatch.setenv("OPENAI_API_KEY", "o")
    assert llm.make_llm("chatgpt").api_key == jllm.make_llm("chatgpt").api_key == "o"
    vllm = llm.make_llm("vllm", host="10.0.0.1", port=1)
    assert (vllm.url, vllm.model) == (jllm.make_llm("vllm", host="10.0.0.1", port=1).url,
                                     "THUDM/chatglm3-6b")
    assert list(llm.EchoLLM().stream_chat([{"content": "hi"}])) == \
        list(jllm.EchoLLM().stream_chat([{"content": "hi"}]))
    with pytest.raises(ValueError, match="unknown llm"):
        llm.make_llm("eliza")
