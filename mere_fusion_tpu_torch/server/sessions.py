"""Per-user sessions: engine + media transport lifecycle.

Port of mere_fusion_tpu/server/sessions.py. Transport "loopback" is
in-process: the tracks are drained by consumer tasks at the paced rate
(tests, demos, hosts without aiortc). WebRTC, RTMP and RTP output and the
upstream cognition plane (ASR + perception + brain) are not ported yet.
"""
from __future__ import annotations

import asyncio
import inspect
import math
import uuid
from typing import Optional

from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.device import device_scope
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.transport.tracks import HumanPlayer


class CapacityError(RuntimeError):
    """Session admission refused: max_sessions reached."""


class Session:
    def __init__(self, session_id: str, engine, cfg: Config):
        self.session_id = session_id
        self.model = engine          # the reference's name for the engine
        self.cfg = cfg
        self.player: Optional[HumanPlayer] = None
        # torch.device this session is placed on (set by SessionManager)
        self.device = getattr(engine, "device", None)
        self._consumers: list[asyncio.Task] = []
        self._closed = False

    def ensure_upstream(self) -> None:
        raise NotImplementedError(
            "the upstream cognition plane (streaming ASR + perception) is not "
            "ported to the PyTorch package yet (ROADMAP: 'Streaming ASR', "
            "'Perception')")

    async def start(self) -> None:
        mode = self.cfg.transport.mode
        self.player = HumanPlayer(self.model)
        try:
            if mode == "loopback":
                self._consumers = [
                    asyncio.create_task(self._drain(self.player.audio)),
                    asyncio.create_task(self._drain(self.player.video)),
                ]
            elif mode in ("webrtc", "rtmp", "rtp"):
                raise NotImplementedError(
                    f"transport {mode!r} is not ported to the PyTorch package "
                    "yet (ROADMAP: 'Transports'); use loopback")
            else:
                raise ValueError(f"unsupported transport mode {mode!r}")
        except Exception:
            await self.close()
            raise
        metrics.counter("sessions.started")

    async def _drain(self, track) -> None:
        try:
            while True:
                await track.recv()
        except (ConnectionError, asyncio.CancelledError):
            pass

    async def close(self) -> None:
        if self._closed:  # idempotent: teardown may race stop_session
            return
        self._closed = True
        for task in self._consumers:
            task.cancel()
        if self._consumers:
            await asyncio.gather(*self._consumers, return_exceptions=True)
        if self.player is not None:
            # joins the render thread (up to 5 s) off the event loop
            await asyncio.get_running_loop().run_in_executor(None, self.player.stop)
        metrics.counter("sessions.closed")


class SessionManager:
    def __init__(self, cfg: Config, engine_factory, devices=None):
        """devices: the torch devices sessions are placed on; None means
        every CUDA device of the host (raises if there is none)."""
        self.cfg = cfg
        self.engine_factory = engine_factory
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
            session = Session(sid, engine, self.cfg)
            session.device = device
            await session.start()
            async with self.lock:
                self._starting.discard(sid)
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
