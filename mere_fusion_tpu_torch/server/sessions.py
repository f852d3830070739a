"""Per-user sessions: engine and media transport lifecycle.

Port of mere_fusion_tpu/server/sessions.py (reference: app.py:42-97,
312-531). Transports (``transport.mode``):

- "loopback": in-process; consumer tasks drain the tracks at the paced rate
  (tests, demos);
- "rtp": L16 audio and RFC 4175 video over UDP with RTCP sender reports
  (``transport.rtp_send``): numpy and sockets, no ffmpeg, no aiortc;
- "rtmp": an FLV push through ffmpeg, or through the native publisher
  (``transport.rtmp``, ``transport.rtmp_native``) when ffmpeg is absent;
- "webrtc": two RTCPeerConnections against an SRS relay (pull the caller's
  stream, push the avatar's), signaled over HTTP with retries
  (``server.signaling``); needs aiortc.

A session given an LLM builds its upstream cognition plane when the first
caller's track arrives (``ensure_upstream``): streaming Whisper ASR on the
session's device, the configured perception (the port's YOLOv10 summarizer
on the session's device with ``perception.backend`` yolo-tpu), and the brain
that puts the LLM's phrases on the engine's TTS.
"""
from __future__ import annotations

import asyncio
import inspect
import math
import threading
import uuid
from typing import Optional

from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.device import device_scope
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.transport.tracks import HumanPlayer


class CapacityError(RuntimeError):
    """Session admission refused: max_sessions reached."""


class Session:
    def __init__(self, session_id: str, engine, cfg: Config, llm=None,
                 asr_backend=None, perception=None):
        self.session_id = session_id
        self.model = engine          # the reference's name for the engine
        self.cfg = cfg
        self.llm = llm
        self._asr_backend = asr_backend
        self._perception = perception
        self.player: Optional[HumanPlayer] = None
        # torch.device this session is placed on (set by SessionManager)
        self.device = getattr(engine, "device", None)
        self.brain = None
        self.speech_upstream = None
        self.video_upstream = None
        self._consumers: list[asyncio.Task] = []
        self._pcs: list = []
        self._rtmp = None
        self._rtp = None
        self._closed = False
        # set by SessionManager: async () -> bool, which removes this session
        # from the manager's registry and closes it (the reference discards a
        # session when its connection dies, app.py:406-478; a bare close
        # would keep its max_sessions slot and the active gauge)
        self._manager_discard = None

    def ensure_upstream(self) -> None:
        """Build the cognition plane on the first incoming track: incoming
        speech and video drive the brain, which speaks through the engine. A
        session without an LLM has none. The ASR backend's weights go on the
        session's device, so that transcription run from the shared event
        loop's executor does not pile every session onto one card; a build
        that fails raises."""
        if self.llm is None or self.speech_upstream is not None:
            return
        from mere_fusion_tpu_torch.asr import StreamingTranscriber, make_backend
        from mere_fusion_tpu_torch.brain import BrainSession
        from mere_fusion_tpu_torch.server.upstream import SpeechUpstream, VideoUpstream

        if self.brain is None:
            self.brain = BrainSession(self.model, self.llm)
        asr_kw = {"device": self.device}
        if self.cfg.asr.backend == "jax-whisper":
            asr_kw.update(language=self.cfg.asr.language, beam_size=self.cfg.asr.beam_size)
        backend = self._asr_backend or make_backend(self.cfg.asr.backend, **asr_kw)
        transcriber = StreamingTranscriber(
            backend, buffer_trimming=("segment", self.cfg.asr.buffer_trim_seconds))
        self.speech_upstream = SpeechUpstream(
            transcriber, self.brain, min_chunk_seconds=self.cfg.asr.min_chunk_seconds)
        self.video_upstream = VideoUpstream(
            self._perception or self._build_perception(), self.brain)

    def _build_perception(self):
        """The perception backend of the config: the port's YOLOv10 summarizer
        (``yolo-tpu``) on this session's device, ultralytics (``yolo``) or the
        stub. Built with the upstream, at the first incoming track, never on
        the session start's critical path."""
        from mere_fusion_tpu_torch.perception import make_perception, parse_perception_spec

        p = self.cfg.perception
        if p.backend in ("yolo-tpu", "yolo_tpu"):
            return make_perception(
                p.backend, ckpt=p.ckpt or None, scale=p.scale, fps_throttle=p.fps_throttle,
                conf=p.conf, device=self.device, face_attrs=parse_perception_spec(p.face_attrs),
                ocr=parse_perception_spec(p.ocr))
        if p.backend == "yolo":
            kw = {"model_path": p.ckpt} if p.ckpt else {}
            return make_perception("yolo", fps_throttle=p.fps_throttle, **kw)
        return make_perception("stub", fps_throttle=p.fps_throttle)

    async def start(self) -> None:
        mode = self.cfg.transport.mode
        self.player = HumanPlayer(self.model)
        try:
            if mode == "loopback":
                self._consumers = [
                    asyncio.create_task(self._drain(self.player.audio)),
                    asyncio.create_task(self._drain(self.player.video)),
                ]
            elif mode == "webrtc":
                await self._start_webrtc()
            elif mode == "rtmp":
                await self._start_rtmp()
            elif mode == "rtp":
                await self._start_rtp()
            else:
                raise ValueError(f"unsupported transport mode {mode!r}")
        except Exception:
            # half-built transports (a negotiated consume pc when the produce
            # negotiation fails) must not leak live connections
            await self.close()
            raise
        metrics.counter("sessions.started")

    def _start_sink(self, sink) -> None:
        self._consumers = [asyncio.create_task(
            sink.run(self.player.video, self.player.audio, threading.Event()))]

    async def _start_rtmp(self) -> None:
        """FLV push to ``transport.push_url``, sized from the engine's frames."""
        from mere_fusion_tpu_torch.transport.rtmp import RtmpStreamer, RtmpTrackSink

        h, w = self.model.first_video_frame_shape()
        self._rtmp = RtmpStreamer(self.cfg.transport.push_url, width=w, height=h,
                                  fps=self.cfg.audio.fps,
                                  sample_rate=self.cfg.audio.sample_rate)
        self._start_sink(RtmpTrackSink(self._rtmp))

    async def _start_rtp(self) -> None:
        """L16 audio and RFC 4175 video over UDP to ``transport.rtp_host``."""
        from mere_fusion_tpu_torch.transport.rtp_send import RtpSender, RtpTrackSink

        t = self.cfg.transport
        self._rtp = RtpSender(t.rtp_host, t.rtp_audio_port, t.rtp_video_port)
        self._start_sink(RtpTrackSink(self._rtp))

    async def _drain(self, track) -> None:
        try:
            while True:
                await track.recv()
        except (ConnectionError, asyncio.CancelledError):
            pass

    async def _start_webrtc(self, pc_factory=None, post_json=None, make_answer=None) -> None:
        """Two peer connections against SRS: pull the caller's stream, push
        the avatar's (reference app.py:395-531).

        pc_factory, post_json and make_answer are injectable for tests; a
        server uses aiortc's RTCPeerConnection and aiohttp.
        """
        from mere_fusion_tpu_torch.server.signaling import (
            attach_state_watcher,
            negotiate,
            wait_connected,
        )

        if pc_factory is None:
            from aiortc import RTCPeerConnection

            pc_factory = RTCPeerConnection
        sid = self.session_id
        t = self.cfg.transport

        def on_dead(state: str):
            return self.discard()

        # pull the caller's stream; registered before negotiating, so that
        # close() reaches it when a later step fails
        consume_pc = pc_factory()
        self._pcs.append(consume_pc)
        consume_pc.addTransceiver("audio", direction="recvonly")
        consume_pc.addTransceiver("video", direction="recvonly")

        @consume_pc.on("track")
        def on_track(track):
            from mere_fusion_tpu_torch.server.upstream import attach_upstream_track

            reader = attach_upstream_track(self, track)
            if reader is not None:
                self._consumers.append(reader)

        attach_state_watcher(consume_pc, on_dead, label=f"consume/{sid}")
        await negotiate(consume_pc, t.pull_url, f"webrtc://localhost/live/stream_{sid}",
                        post_json=post_json, make_answer=make_answer)
        # the push negotiation starts once the pull side is connected
        # (reference app.py:471-478); a timeout or a death reaches start()'s
        # close-on-failure path
        await wait_connected(consume_pc, timeout=t.connect_timeout)

        produce_pc = pc_factory()
        self._pcs.append(produce_pc)
        produce_pc.addTrack(self.player.audio)
        produce_pc.addTrack(self.player.video)
        attach_state_watcher(produce_pc, on_dead, label=f"produce/{sid}")
        await negotiate(produce_pc, t.push_url,
                        f"webrtc://localhost/live/processed_stream_{sid}",
                        post_json=post_json, make_answer=make_answer)

    async def discard(self) -> None:
        """Close and deregister (a dead connection): through the manager when
        registered there, so that the max_sessions slot and the active gauge
        are released; a bare close for an unmanaged session or a death that
        races the session's start."""
        if self._manager_discard is not None and await self._manager_discard():
            return
        await self.close()

    async def close(self) -> None:
        if self._closed:  # idempotent: teardown may race stop_session
            return
        self._closed = True
        for task in self._consumers:
            task.cancel()
        if self._consumers:
            await asyncio.gather(*self._consumers, return_exceptions=True)
        if self._rtmp is not None:
            self._rtmp.close()
        if self._rtp is not None:
            self._rtp.close()
        for pc in self._pcs:
            await pc.close()
        loop = asyncio.get_running_loop()
        if self.player is not None:
            # joins the render thread (up to 5 s) off the event loop
            await loop.run_in_executor(None, self.player.stop)
        if self.brain is not None:
            # joins the phrase thread (up to 5 s) off the event loop
            await loop.run_in_executor(None, self.brain.close)
        metrics.counter("sessions.closed")


class SessionManager:
    def __init__(self, cfg: Config, engine_factory, devices=None, llm=None):
        """devices: the torch devices sessions are placed on; None means
        every CUDA device of the host (raises if there is none)."""
        self.cfg = cfg
        self.engine_factory = engine_factory
        self.llm = llm
        self.devices = devices
        self.sessions: dict[str, Session] = {}
        self._starting: set[str] = set()  # admission-counted while building
        self.lock = asyncio.Lock()
        self.placer = None  # built on the first session start

    def _ensure_placer(self):
        if self.placer is None:
            from mere_fusion_tpu_torch.parallel.placement import DevicePlacer, cuda_devices

            devices = self.devices if self.devices is not None else cuda_devices()
            # per-device cap sized so the GLOBAL max_sessions stays the only
            # admission limit; least-loaded acquire balances the devices
            self.placer = DevicePlacer(
                devices, max_sessions_per_device=max(
                    1, math.ceil(self.cfg.server.max_sessions / len(devices))))
        return self.placer

    def _build_engine(self, device):
        """Call the factory on an executor thread with the placed device as
        the thread's current device, passing device= through when the
        factory accepts it."""
        factory = self.engine_factory
        try:
            params = inspect.signature(factory).parameters
            accepts_device = "device" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())
        except (TypeError, ValueError):
            accepts_device = False
        with device_scope(device):
            engine = factory(self.cfg, device=device) if accepts_device else factory(self.cfg)
        if getattr(engine, "device", False) is None:
            engine.device = device
        return engine

    async def start_session(self) -> Session:
        placer = self._ensure_placer()
        async with self.lock:
            if len(self.sessions) + len(self._starting) >= self.cfg.server.max_sessions:
                raise CapacityError("max sessions")
            sid = str(uuid.uuid4())
            self._starting.add(sid)
            device = placer.acquire(sid)
        try:
            # the engine build blocks for seconds (weights, kernel build,
            # warm-up): run it off the loop, lock dropped, so live sessions
            # keep streaming while a new caller joins
            loop = asyncio.get_running_loop()
            engine = await loop.run_in_executor(None, self._build_engine, device)
            session = Session(sid, engine, self.cfg, llm=self.llm)
            session.device = device
            session._manager_discard = lambda: self.stop_session(sid)
            await session.start()
            async with self.lock:
                self._starting.discard(sid)
                if session._closed:
                    # a connection-state watcher fired between start() and
                    # registration: its discard() found nothing to
                    # deregister and closed the session; register no corpse
                    placer.release(sid)
                    raise RuntimeError("session died during startup")
                self.sessions[sid] = session
                metrics.gauge("sessions.active", len(self.sessions))
                self._publish_placement()
            return session
        except BaseException:
            async with self.lock:
                if sid in self._starting:
                    self._starting.discard(sid)
                    placer.release(sid)
            raise

    async def stop_session(self, session_id: str) -> bool:
        async with self.lock:
            session = self.sessions.pop(session_id, None)
            if session is None:
                return False
            await session.close()
            # release AFTER close: the dying engine's weights and in-flight
            # launches still occupy its device until then
            if self.placer is not None:
                self.placer.release(session_id)
                self._publish_placement()
            metrics.gauge("sessions.active", len(self.sessions))
            return True

    def _publish_placement(self) -> None:
        """Per-device session counts on /metrics."""
        counts = self.placer.counts()
        for i, dev in enumerate(self.placer.devices):
            metrics.gauge(f"sessions.device{i}", counts[dev])

    def get(self, session_id: str) -> Optional[Session]:
        return self.sessions.get(session_id)

    async def close_all(self) -> None:
        for sid in list(self.sessions):
            await self.stop_session(sid)
