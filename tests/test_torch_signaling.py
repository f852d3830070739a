"""The port's WebRTC signaling and session legs against the JAX package's:
server/signaling.py, server/upstream.py and server/sessions.py.

Twins of tests/test_signaling.py against the contract-enforcing aiortc fake
(tests/aiortc_fake.py, docs/aiortc_contract.md), then parity: the port's
``negotiate`` and ``Session._start_webrtc`` make the JAX package's calls on
the peer connections, in its order, and post its payloads. Then the
upstream divergence (a session without an LLM starts no track reader, where
the JAX package starts one that dies at its first frame), the "died during
startup" guard, and the RTMP leg of a session against a mini server.
"""
from __future__ import annotations

import asyncio
import secrets
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mere_fusion_tpu.server import sessions as jax_sessions
from mere_fusion_tpu.server import signaling as jax_signaling
from mere_fusion_tpu.server import upstream as jax_upstream
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.server import sessions, signaling, upstream
from mere_fusion_tpu_torch.server.sessions import Session, SessionManager
from mere_fusion_tpu_torch.server.signaling import (
    attach_state_watcher,
    negotiate,
    wait_connected,
)
from tests.aiortc_fake import (
    ContractFakePC,
    InternalError,
    InvalidAccessError,
    InvalidStateError,
    make_answer,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def make_pc(**kw):
    """A pc with one recvonly audio transceiver (createOffer needs media, C1)."""
    pc = ContractFakePC(**kw)
    pc.addTransceiver("audio", direction="recvonly")
    return pc


def _player():
    return SimpleNamespace(audio=SimpleNamespace(kind="audio"),
                           video=SimpleNamespace(kind="video"), stop=lambda: None)


# ---- twins of tests/test_signaling.py: negotiate ------------------------------------

def test_negotiate_success():
    pc = make_pc()
    posts = []

    async def post_json(url, payload, timeout):
        posts.append((url, payload, timeout))
        return {"code": 0, "sdp": "v=0 answer"}

    asyncio.run(negotiate(pc, "http://srs/api", "webrtc://host/live/s1",
                          post_json=post_json, make_answer=make_answer))
    assert pc.localDescription.sdp == "v=0 m=audio(recvonly)"
    assert pc.remoteDescription.sdp == "v=0 answer"
    assert pc.signalingState == "stable"
    url, payload, timeout = posts[0]
    assert url == "http://srs/api"
    assert set(payload) == {"api", "streamurl", "clientip", "sdp", "tid", "action"}
    assert payload["api"] == "http://srs/api"
    assert payload["streamurl"] == "webrtc://host/live/s1"
    assert payload["clientip"] is None
    assert payload["sdp"] == "v=0 m=audio(recvonly)"
    assert 10000 <= int(payload["tid"]) <= 99999
    assert timeout == 15.0


def test_negotiate_retries_with_backoff_then_succeeds():
    """Retries re-POST the same offer; the state stays have-local-offer (C2)."""
    pc = make_pc()
    sleeps, calls = [], []

    async def post_json(url, payload, timeout):
        calls.append(payload["sdp"])
        if len(calls) < 3:
            raise OSError("connection refused")
        return {"sdp": "late answer"}

    async def sleep(t):
        sleeps.append(t)

    asyncio.run(negotiate(pc, "u", "s", post_json=post_json, make_answer=make_answer,
                          sleep=sleep))
    assert len(calls) == 3 and len(set(calls)) == 1
    assert sleeps == [1, 2]
    assert pc.remoteDescription.sdp == "late answer"


def test_negotiate_exhausts_and_raises():
    pc = make_pc()
    sleeps = []

    async def post_json(url, payload, timeout):
        raise asyncio.TimeoutError("slow SRS")

    async def sleep(t):
        sleeps.append(t)

    with pytest.raises(ConnectionError, match="3 attempts"):
        asyncio.run(negotiate(pc, "u", "s", post_json=post_json, make_answer=make_answer,
                              sleep=sleep))
    assert sleeps == [1, 2]   # no sleep after the last attempt
    assert pc.remoteDescription is None


def test_negotiate_rejects_sdp_less_answer():
    pc = make_pc()

    async def post_json(url, payload, timeout):
        return {"code": 400}

    async def sleep(t):
        pass

    with pytest.raises(ConnectionError, match="code=400"):
        asyncio.run(negotiate(pc, "u", "s", post_json=post_json, make_answer=make_answer,
                              sleep=sleep))
    assert pc.remoteDescription is None


# ---- twins: the aiortc contract through the port's code ------------------------------

def test_contract_offer_requires_media():
    """C1: createOffer with no media raises, as aiortc does."""
    async def post_json(url, payload, timeout):  # pragma: no cover
        return {"sdp": "x"}

    with pytest.raises(InternalError, match="no media"):
        asyncio.run(negotiate(ContractFakePC(), "u", "s", post_json=post_json,
                              make_answer=make_answer))


def test_contract_media_added_after_offer_missing_from_sdp():
    """C1: the offer snapshots its m-lines, so the port's produce pc adds its
    tracks before negotiating: both are in the posted offer."""
    pc = make_pc()

    async def drive():
        offer = await pc.createOffer()
        pc.addTrack(SimpleNamespace(kind="video"))
        return offer

    assert "video" not in asyncio.run(drive()).sdp
    posts = _run_start_webrtc(sessions)[1]
    assert "m=audio(send)" in posts[1]["sdp"] and "m=video(send)" in posts[1]["sdp"]


def test_contract_answer_requires_have_local_offer():
    """C2: an answer in "stable" raises, so negotiate sets the local offer
    first."""
    pc = make_pc()
    with pytest.raises(InvalidStateError, match="stable"):
        asyncio.run(pc.setRemoteDescription(make_answer("v=0 a")))

    async def post_json(url, payload, timeout):
        assert pc.signalingState == "have-local-offer"
        return {"sdp": "v=0 a"}

    asyncio.run(negotiate(pc, "u", "s", post_json=post_json, make_answer=make_answer))
    assert pc.signalingState == "stable"


def test_contract_double_add_track_raises():
    """C9: a track that has a sender already is refused; the port's produce
    pc adds each of the player's tracks once."""
    pc = ContractFakePC()
    track = SimpleNamespace(kind="audio")
    pc.addTrack(track)
    with pytest.raises(InvalidAccessError):
        pc.addTrack(track)
    pcs = _run_start_webrtc(sessions)[0]
    assert [getattr(t, "kind", None) for t in pcs[1]._senders] == ["audio", "video"]


def test_contract_closed_pc_rejects_media_and_offers():
    """C8: addTrack and createOffer after close raise; the port's close()
    closes every pc once (close is idempotent)."""
    pc = make_pc()

    async def drive():
        await pc.close()
        await pc.close()
        with pytest.raises(InvalidStateError):
            pc.addTrack(SimpleNamespace(kind="audio"))
        with pytest.raises(InvalidStateError):
            await pc.createOffer()

    asyncio.run(drive())
    pcs, _, session = _run_start_webrtc(sessions, close=True)
    assert all(p.closed for p in pcs) and session._closed


def test_contract_track_fires_during_set_remote_description():
    """C4: recv transceivers emit track inside setRemoteDescription."""
    pc = ContractFakePC()
    pc.addTransceiver("audio", direction="recvonly")
    pc.addTransceiver("video", direction="recvonly")
    got = []
    pc.on("track", lambda t: got.append(t.kind))

    async def post_json(url, payload, timeout):
        assert got == []
        return {"sdp": "v=0 answer"}

    asyncio.run(negotiate(pc, "u", "s", post_json=post_json, make_answer=make_answer))
    assert got == ["audio", "video"]


def test_wait_connected_resolves_on_async_transition():
    """C7: connected comes by scheduled events after the answer."""
    pc = make_pc()

    async def post_json(url, payload, timeout):
        return {"sdp": "v=0 answer"}

    async def drive():
        await negotiate(pc, "u", "s", post_json=post_json, make_answer=make_answer)
        assert pc.connectionState == "new"
        await wait_connected(pc, timeout=1.0)
        assert pc.connectionState == "connected"

    asyncio.run(drive())


def test_wait_connected_checks_state_before_listening():
    pc = make_pc()
    pc.connectionState = "connected"
    asyncio.run(wait_connected(pc, timeout=0.01))


def test_wait_connected_timeout_and_death():
    pc = make_pc(connect_after_answer=False)
    with pytest.raises(ConnectionError, match="not connected within"):
        asyncio.run(wait_connected(pc, timeout=0.05))
    dead = make_pc(connect_after_answer=False)

    async def drive():
        task = asyncio.ensure_future(wait_connected(dead, timeout=5.0))
        await asyncio.sleep(0)
        dead.connectionState = "failed"
        await dead.emit("connectionstatechange")
        with pytest.raises(ConnectionError, match="failed"):
            await task

    asyncio.run(drive())


def _drive_states(pc, states):
    async def drive():
        for state in states:
            pc.connectionState = state
            await pc.emit("connectionstatechange")

    asyncio.run(drive())


def test_state_watcher_fires_once():
    pc = make_pc(connect_after_answer=False)
    dead = []
    attach_state_watcher(pc, lambda state: dead.append(state))
    _drive_states(pc, ["connected", "failed", "closed"])
    assert dead == ["failed"]


def test_state_watcher_ignores_transient_disconnected():
    pc = make_pc(connect_after_answer=False)
    dead = []

    async def on_dead(state):    # async callbacks are awaited
        dead.append(state)

    attach_state_watcher(pc, on_dead)
    _drive_states(pc, ["disconnected", "connected", "failed"])
    assert dead == ["failed"]


# ---- twins: the dual-pc session (reference app.py:427-512) ---------------------------

def test_session_webrtc_negotiates_both_pcs_and_tears_down(monkeypatch):
    cfg = Config().override(**{"transport.mode": "webrtc"})
    session = Session("s7", engine=SimpleNamespace(), cfg=cfg)
    session.player = _player()
    attached = []
    monkeypatch.setattr(upstream, "attach_upstream_track",
                        lambda sess, track: attached.append(track.kind))
    pcs, posts, closed = [], [], []

    def pc_factory():
        pcs.append(ContractFakePC())
        return pcs[-1]

    async def post_json(url, payload, timeout):
        posts.append((url, payload["streamurl"], payload["sdp"], pcs[0].connectionState))
        return {"sdp": "answer"}

    async def fake_close():
        closed.append(True)

    session.close = fake_close

    async def drive():
        await session._start_webrtc(pc_factory=pc_factory, post_json=post_json,
                                    make_answer=make_answer)
        consume, produce = pcs
        assert "m=audio(recvonly)" in posts[0][2] and "m=video(recvonly)" in posts[0][2]
        assert attached == ["audio", "video"]
        assert "send" in posts[1][2]
        assert posts[1][3] == "connected"   # the push waited for the pull
        assert session._pcs == [consume, produce]
        consume.connectionState = "failed"
        await consume.emit("connectionstatechange")
        await consume.emit("connectionstatechange")

    asyncio.run(drive())
    assert [s for _, s, _, _ in posts] == ["webrtc://localhost/live/stream_s7",
                                           "webrtc://localhost/live/processed_stream_s7"]
    assert posts[0][0] == cfg.transport.pull_url
    assert posts[1][0] == cfg.transport.push_url
    assert closed == [True]


def test_session_webrtc_consume_never_connects_tears_down():
    cfg = Config().override(**{"transport.mode": "webrtc", "transport.connect_timeout": 0.05})
    session = Session("s9", engine=SimpleNamespace(), cfg=cfg)
    session.player = _player()
    pcs = []

    def pc_factory():
        pcs.append(ContractFakePC(connect_after_answer=False))
        return pcs[-1]

    async def post_json(url, payload, timeout):
        return {"sdp": "answer"}

    async def drive():
        with pytest.raises(ConnectionError, match="not connected"):
            await session._start_webrtc(pc_factory=pc_factory, post_json=post_json,
                                        make_answer=make_answer)
        assert len(pcs) == 1 and pcs[0] in session._pcs
        await session.close()
        assert pcs[0].closed

    asyncio.run(drive())


def test_failed_produce_negotiation_still_closes_consume_pc(monkeypatch):
    cfg = Config().override(**{"transport.mode": "webrtc"})
    session = Session("s8", engine=SimpleNamespace(), cfg=cfg)
    session.player = _player()
    pcs = []

    def pc_factory():
        pcs.append(ContractFakePC())
        return pcs[-1]

    calls = {"n": 0}

    async def post_json(url, payload, timeout):
        calls["n"] += 1
        if calls["n"] == 1:
            return {"sdp": "answer"}
        raise OSError("SRS push down")

    async def no_sleep(_s):
        return None

    async def drive():
        with pytest.raises(ConnectionError):
            await session._start_webrtc(pc_factory=pc_factory, post_json=post_json,
                                        make_answer=make_answer)
        assert pcs[0] in session._pcs and pcs[1] in session._pcs
        await session.close()
        assert pcs[0].closed and pcs[1].closed

    orig = signaling.negotiate

    async def fast_negotiate(*a, **kw):   # the 1 s + 2 s backoff is not under test
        return await orig(*a, **kw, sleep=no_sleep)

    monkeypatch.setattr(signaling, "negotiate", fast_negotiate)
    asyncio.run(drive())


def test_watcher_death_deregisters_from_manager():
    cfg = Config().override(**{"transport.mode": "loopback", "server.max_sessions": 1})
    mgr = SessionManager(cfg, engine_factory=lambda c: SimpleNamespace(), devices=[CPU])
    closes = []

    async def drive():
        sid = "sX"
        session = Session(sid, engine=SimpleNamespace(), cfg=cfg)
        session.player = SimpleNamespace(stop=lambda: closes.append("stop"))
        session._manager_discard = lambda: mgr.stop_session(sid)
        mgr.sessions[sid] = session
        await session.discard()           # what the state watcher runs
        assert mgr.sessions == {}
        assert closes == ["stop"]
        await session.discard()           # idempotent
        await session.close()
        assert closes == ["stop"]

    asyncio.run(drive())


# ---- twins: SRS response replays -----------------------------------------------------

SRS_FIXTURES = {
    "play_ok": {"code": 0, "server": "vid-k2918w2",
                "sdp": ("v=0\r\no=SRS/5.0.213 112 2 IN IP4 0.0.0.0\r\ns=SRSPlay\r\n"
                        "t=0 0\r\nm=audio 9 UDP/TLS/RTP/SAVPF 111\r\n"),
                "sessionid": "k2918w2:FY0G9Y9S"},
    "publish_ok": {"code": 0, "server": "vid-k2918w2",
                   "sdp": ("v=0\r\no=SRS/5.0.213 112 2 IN IP4 0.0.0.0\r\ns=SRSPublish\r\n"
                           "t=0 0\r\nm=video 9 UDP/TLS/RTP/SAVPF 106\r\n"),
                   "sessionid": "k2918w2:2J9R1M5K"},
    "error_bare_code": {"code": 400},
    "error_code_msg": {"code": 2049, "msg": "no stream found"},
    "error_busy": {"code": 1028, "server": "vid-k2918w2", "msg": "stream busy"},
    "malformed_sdp_null": {"code": 0, "sdp": None},
    "malformed_sdp_empty": {"code": 0, "sdp": ""},
    "malformed_no_sdp": {"code": 0, "server": "vid-k2918w2"},
    "malformed_not_object": ["not", "a", "dict"],
}


def _replay(body, n: int = 1, mod=signaling):
    pc = make_pc()
    attempts = []

    async def post_json(url, payload, timeout):
        attempts.append(payload)
        return body

    async def no_sleep(_s):
        return None

    asyncio.run(mod.negotiate(pc, "http://srs/rtc/v1/play/", "webrtc://host/live/s1",
                              post_json=post_json, make_answer=make_answer, retries=n,
                              sleep=no_sleep, action="play"))
    return pc, attempts


def test_srs_replay_success_bodies():
    for name in ("play_ok", "publish_ok"):
        pc, attempts = _replay(SRS_FIXTURES[name])
        assert pc.remoteDescription.sdp == SRS_FIXTURES[name]["sdp"]
        assert pc.signalingState == "stable"
        assert len(attempts) == 1 and attempts[0]["action"] == "play"


@pytest.mark.parametrize("name", ["error_bare_code", "error_code_msg", "error_busy"])
def test_srs_replay_error_codes_fail_without_touching_pc(name):
    with pytest.raises(ConnectionError) as ei:
        _replay(SRS_FIXTURES[name], n=2)
    assert f"code={SRS_FIXTURES[name]['code']!r}" in str(ei.value)
    with pytest.raises(ConnectionError) as ref:
        _replay(SRS_FIXTURES[name], n=2, mod=jax_signaling)
    assert str(ei.value) == str(ref.value)


@pytest.mark.parametrize("name", ["malformed_sdp_null", "malformed_sdp_empty",
                                  "malformed_no_sdp", "malformed_not_object"])
def test_srs_replay_malformed_answers_fail(name):
    with pytest.raises(ConnectionError) as ei:
        _replay(SRS_FIXTURES[name], n=2)
    with pytest.raises(ConnectionError) as ref:
        _replay(SRS_FIXTURES[name], n=2, mod=jax_signaling)
    assert str(ei.value) == str(ref.value)


def test_srs_replay_error_then_recovery_retries():
    pc = make_pc()
    bodies = [SRS_FIXTURES["error_bare_code"], SRS_FIXTURES["play_ok"]]
    sleeps = []

    async def post_json(url, payload, timeout):
        return bodies.pop(0)

    async def fake_sleep(s):
        sleeps.append(s)

    asyncio.run(negotiate(pc, "u", "s", post_json=post_json, make_answer=make_answer,
                          retries=3, sleep=fake_sleep))
    assert pc.remoteDescription.sdp == SRS_FIXTURES["play_ok"]["sdp"]
    assert sleeps == [1]


# ---- parity with the JAX package: calls on the pcs and posted payloads ----------------

class RecordingPC(ContractFakePC):
    """The contract fake, logging each call made on it into ``log``."""

    def __init__(self, log, name, **kw):
        super().__init__(**kw)
        self._log, self._name = log, name

    def _note(self, *entry):
        self._log.append((self._name, *entry))

    def on(self, name, f=None):
        self._note("on", name)
        return super().on(name, f)

    def addTransceiver(self, kind, direction="sendrecv"):
        self._note("addTransceiver", kind, direction)
        return super().addTransceiver(kind, direction)

    def addTrack(self, track):
        self._note("addTrack", track.kind)
        return super().addTrack(track)

    async def createOffer(self):
        self._note("createOffer")
        return await super().createOffer()

    async def setLocalDescription(self, desc):
        self._note("setLocalDescription", desc.type, desc.sdp)
        await super().setLocalDescription(desc)

    async def setRemoteDescription(self, desc):
        self._note("setRemoteDescription", desc.type, desc.sdp)
        await super().setRemoteDescription(desc)

    async def close(self):
        self._note("close")
        await super().close()


@pytest.mark.parametrize("bodies", [[{"sdp": "v=0 a"}], [{"code": 400}, OSError("x"), {"sdp": "b"}],
                                    [{"code": 0}, {"code": 1028, "msg": "busy"}, ["x"]]],
                         ids=["first", "recovers", "exhausted"])
def test_negotiate_calls_and_payloads_match_jax(monkeypatch, bodies):
    monkeypatch.setattr(secrets, "randbelow", lambda n: 4321)
    runs = []
    for mod in (signaling, jax_signaling):
        log, posts, sleeps, queue = [], [], [], list(bodies)
        pc = RecordingPC(log, "pc")
        pc.addTransceiver("video", direction="recvonly")

        async def post_json(url, payload, timeout):
            posts.append((url, payload, timeout))
            body = queue.pop(0)
            if isinstance(body, Exception):
                raise body
            return body

        async def sleep(s):
            sleeps.append(s)

        async def drive():
            try:
                await mod.negotiate(pc, "http://srs/api", "webrtc://h/live/x", post_json=post_json,
                                    make_answer=make_answer, sleep=sleep, action="publish")
            except ConnectionError as e:
                return str(e)

        runs.append((asyncio.run(drive()), log, posts, sleeps))
    assert runs[0] == runs[1]


def _run_start_webrtc(sessions_mod, close=False, connect=True, log=None, posts=None):
    """``sessions_mod.Session("s7")._start_webrtc`` on RecordingPCs; the
    pcs, the posted payloads and the session."""
    log = [] if log is None else log
    posts = [] if posts is None else posts
    cfg = sessions_mod.Config().override(**{"transport.mode": "webrtc",
                                       "transport.connect_timeout": 0.05})
    session = sessions_mod.Session("s7", engine=SimpleNamespace(), cfg=cfg)
    session.player = _player()
    pcs = []

    def pc_factory():
        pcs.append(RecordingPC(log, f"pc{len(pcs)}", connect_after_answer=connect))
        return pcs[-1]

    async def post_json(url, payload, timeout):
        posts.append(dict(payload, _url=url, _timeout=timeout))
        return {"sdp": f"answer {len(posts)}"}

    async def drive():
        try:
            await session._start_webrtc(pc_factory=pc_factory, post_json=post_json,
                                        make_answer=make_answer)
        except ConnectionError as e:
            log.append(("raised", str(e)))
        if close:
            await session.close()

    asyncio.run(drive())
    return pcs, posts, session


@pytest.mark.parametrize("connect", [True, False], ids=["connected", "consume_never_connects"])
def test_start_webrtc_calls_and_payloads_match_jax(monkeypatch, connect):
    monkeypatch.setattr(secrets, "randbelow", lambda n: 1234)
    kinds = {"jax": [], "port": []}
    monkeypatch.setattr(jax_upstream, "attach_upstream_track",
                        lambda s, t: kinds["jax"].append(t.kind))
    monkeypatch.setattr(upstream, "attach_upstream_track",
                        lambda s, t: kinds["port"].append(t.kind))
    out = {}
    for name, mod in (("port", sessions), ("jax", jax_sessions)):
        log, posts = [], []
        _run_start_webrtc(mod, close=True, connect=connect, log=log, posts=posts)
        out[name] = (log, posts)
    assert out["port"] == out["jax"]
    assert kinds["port"] == kinds["jax"] == ["audio", "video"]
    log = out["port"][0]
    assert ("pc0", "close") in log and (("pc1", "close") in log) == connect


# ---- the upstream divergence: no LLM, no reader ---------------------------------------

class _AudioFrame:
    sample_rate = 16000

    def to_ndarray(self):
        return np.zeros((1, 320), np.int16)


class _Track:
    def __init__(self, kind):
        self.kind, self.reads = kind, 0

    async def recv(self):
        self.reads += 1
        return _AudioFrame()


def test_no_llm_track_starts_no_reader_where_jax_reader_dies(monkeypatch):
    """ROADMAP §3: with no LLM the JAX package's attach_upstream_track
    (mere_fusion_tpu/server/upstream.py:73-99) starts a reader that dies at
    its first frame on None.process_pcm; the port's starts none and leaves
    the track unread."""
    jax_tasks = []
    ensure_future = asyncio.ensure_future

    def keep(coro):
        jax_tasks.append(ensure_future(coro))
        return jax_tasks[-1]

    async def drive():
        jax_session = jax_sessions.Session("j", engine=SimpleNamespace(),
                                           cfg=jax_sessions.Config())
        jax_track = _Track("audio")
        with monkeypatch.context() as m:
            m.setattr(asyncio, "ensure_future", keep)
            jax_upstream.attach_upstream_track(jax_session, jax_track)
        with pytest.raises(AttributeError, match="process_pcm"):
            await asyncio.wait_for(jax_tasks[0], 10)
        assert jax_track.reads == 1

        port_session = Session("p", engine=SimpleNamespace(), cfg=Config())
        tracks = [_Track("audio"), _Track("video")]
        assert [upstream.attach_upstream_track(port_session, t) for t in tracks] == [None, None]
        await asyncio.sleep(0.05)
        assert [t.reads for t in tracks] == [0, 0]

    asyncio.run(drive())


def test_track_with_llm_gets_a_reader_feeding_speech_upstream():
    """A session with an LLM builds its cognition plane on the first track,
    and the track's reader feeds the caller's audio into SpeechUpstream's
    transcriber."""
    from mere_fusion_tpu_torch.asr import FakeBackend
    from mere_fusion_tpu_torch.llm import EchoLLM

    engine = SimpleNamespace(put_msg_txt=lambda msg: None, pause_talk=lambda: None)
    backend = FakeBackend([])
    session = Session("p", engine=engine, cfg=Config(), llm=EchoLLM(), asr_backend=backend)
    track = _Track("audio")

    async def drive():
        session.player = _player()
        task = upstream.attach_upstream_track(session, track)
        assert isinstance(session.speech_upstream, upstream.SpeechUpstream)
        session._consumers.append(task)
        for _ in range(1000):
            await asyncio.sleep(0.01)
            if backend.calls:
                break
        await session.close()
        assert task.cancelled()

    asyncio.run(drive())
    assert backend.calls >= 1 and track.reads >= 50
    assert session.speech_upstream.transcriber.buffer_seconds >= 1.0
    assert not session.brain._thread.is_alive()


def test_webrtc_session_keeps_its_track_readers():
    """A session with an upstream keeps the reader tasks of its tracks and
    cancels them on close."""
    session = Session("r", engine=SimpleNamespace(), cfg=Config())
    processed = []
    session.speech_upstream = SimpleNamespace(process_pcm=processed.append)
    session.video_upstream = SimpleNamespace(process_frame=processed.append)

    async def drive():
        session.player = _player()
        task = upstream.attach_upstream_track(session, _Track("audio"))
        session._consumers.append(task)
        for _ in range(100):
            await asyncio.sleep(0.01)
            if processed:
                break
        await session.close()
        assert task.cancelled()

    asyncio.run(drive())
    assert processed and processed[0].shape == (320,)


# ---- the manager's guard and the RTMP leg ------------------------------------------

def test_session_dying_during_startup_is_not_registered(monkeypatch):
    """A watcher that fires between start() and registration closes the
    session; the manager then registers no corpse and frees the slot."""
    from tests.fakes import FakeEngine

    cfg = Config().override(**{"transport.mode": "webrtc"})
    mgr = SessionManager(cfg, lambda c: FakeEngine(c), devices=[CPU])
    pcs = []
    orig = Session._start_webrtc

    async def start_and_die(self):
        def pc_factory():
            pcs.append(ContractFakePC())
            return pcs[-1]

        async def post_json(url, payload, timeout):
            return {"sdp": "answer"}

        await orig(self, pc_factory=pc_factory, post_json=post_json, make_answer=make_answer)
        pcs[0].connectionState = "failed"
        await pcs[0].emit("connectionstatechange")

    monkeypatch.setattr(Session, "_start_webrtc", start_and_die)

    async def drive():
        with pytest.raises(RuntimeError, match="died during startup"):
            await mgr.start_session()
        assert mgr.sessions == {} and mgr.placer.counts() == {CPU: 0}

    asyncio.run(drive())
    assert all(p.closed for p in pcs)


def test_session_rtmp_leg_pushes_frames(monkeypatch):
    """transport.mode "rtmp" with no ffmpeg: the session's frames reach an
    RTMP server as Screen Video, sized from first_video_frame_shape."""
    from mere_fusion_tpu_torch.transport import rtmp
    from mere_fusion_tpu_torch.transport.flv import decode_screen_video
    from tests.fakes import FakeEngine
    from tests.test_torch_flv_rtmp import JOIN_S, MiniRtmpServer

    class Engine(FakeEngine):
        def first_video_frame_shape(self):
            return (32, 32)

    server = MiniRtmpServer(n_media=8)
    server.start()
    cfg = Config().override(**{"transport.mode": "rtmp",
                               "transport.push_url": f"rtmp://127.0.0.1:{server.port}/live/s"})
    mgr = SessionManager(cfg, lambda c: Engine(c), devices=[CPU])

    async def drive():
        session = await mgr.start_session()
        assert session._rtmp is not None
        for _ in range(200):
            await asyncio.sleep(0.05)
            if not server.is_alive():
                break
        await mgr.close_all()

    monkeypatch.setattr(rtmp.shutil, "which", lambda name: None)   # the native route
    asyncio.run(drive())
    server.join(timeout=JOIN_S)
    assert server.error is None and server.metadata["width"] == 32
    vids = [p for t, p in server.media if t == 9]
    assert vids and vids[0][0] >> 4 == 1
    np.testing.assert_array_equal(decode_screen_video(vids[0][1:]), np.zeros((32, 32, 3)))
