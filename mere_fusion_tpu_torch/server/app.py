"""aiohttp session server: the reference's six routes plus /metrics,
/health, /preview and /profile.

POST /start_session   {}                             → {code, session_id}
POST /stop_session    {session_id}                   → {code}
POST /interrupt       {session_id}                   → {code}
POST /talk            {session_id, type: echo|chat, text, interrupt?}
POST /set_audio_type  {session_id, audio_type, reinit}
POST /record          {session_id, type: start_record|end_record}
POST /camera          {session_id, enable?, orbit?, scale?, pan?, reset?}
GET  /metrics, /health, /preview, /profile

Port of mere_fusion_tpu/server/app.py; /profile uses torch.profiler.
"""
from __future__ import annotations

import asyncio
import logging
import os

from aiohttp import web

from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.server.sessions import CapacityError, SessionManager

logger = logging.getLogger(__name__)


def json_ok(**kw) -> web.Response:
    return web.json_response({"code": 0, **kw})


def json_err(message: str, status: int = 400) -> web.Response:
    return web.json_response({"code": 1, "message": message}, status=status)


MANAGER = web.AppKey("manager", SessionManager)


def create_app(cfg: Config, engine_factory, llm=None, devices=None) -> web.Application:
    """devices: where sessions are placed (see SessionManager); None means
    every CUDA device of the host. ``app[MANAGER]`` is the SessionManager."""
    app = web.Application()
    manager = SessionManager(cfg, engine_factory, devices=devices, llm=llm)
    app[MANAGER] = manager

    def require_session(params):
        session = manager.get(params.get("session_id", ""))
        if session is None:
            raise web.HTTPNotFound(
                text='{"code": 1, "message": "Session not found"}',
                content_type="application/json",
            )
        return session

    async def start_session(request: web.Request) -> web.Response:
        try:
            session = await manager.start_session()
        except CapacityError:
            return json_err("Maximum number of sessions reached", status=429)
        except Exception as e:  # engine build / transport failures are NOT
            # capacity: surface them as a server error
            logger.exception("start_session failed")
            return json_err(f"session startup failed: {e}", status=500)
        return json_ok(message="Session started", session_id=session.session_id)

    async def stop_session(request: web.Request) -> web.Response:
        data = await request.json()
        sid = data.get("session_id")
        if not sid:
            return json_err("session_id is required")
        if not await manager.stop_session(sid):
            return json_err("Session not found", status=404)
        return json_ok(message="Session stopped")

    async def interrupt(request: web.Request) -> web.Response:
        session = require_session(await request.json())
        session.model.pause_talk()
        return json_ok(data="ok")

    async def talk(request: web.Request) -> web.Response:
        params = await request.json()
        session = require_session(params)
        if params.get("interrupt"):
            session.model.pause_talk()
        kind = params.get("type", "echo")
        if kind == "echo":
            session.model.put_msg_txt(params["text"])
        elif kind == "chat":
            if llm is None:
                return json_err("no llm configured", status=501)
            reply = await asyncio.get_running_loop().run_in_executor(
                None, llm.chat, params["text"])
            session.model.put_msg_txt(reply)
        else:
            return json_err(f"unknown talk type {kind!r}")
        return json_ok(data="ok")

    async def set_audio_type(request: web.Request) -> web.Response:
        params = await request.json()
        session = require_session(params)
        session.model.set_curr_state(params["audio_type"], params["reinit"])
        return json_ok(data="ok")

    async def record(request: web.Request) -> web.Response:
        params = await request.json()
        session = require_session(params)
        try:
            if params["type"] == "start_record":
                session.model.start_recording(params.get("path", "data/record_lasted.mp4"))
            elif params["type"] == "end_record":
                session.model.stop_recording()
            else:
                return json_err(f"unknown record type {params['type']!r}")
        except NotImplementedError as e:
            return json_err(str(e), status=501)
        return json_ok(data="ok")

    async def preview(request: web.Request) -> web.StreamResponse:
        """Live MJPEG preview of a session's output video:
        GET /preview?session_id=...&fps=10"""
        import cv2

        session = require_session(dict(request.query))
        fps = float(request.query.get("fps", 10))
        resp = web.StreamResponse(headers={
            "Content-Type": "multipart/x-mixed-replace; boundary=mjpeg",
            "Cache-Control": "no-store",
        })
        await resp.prepare(request)
        last = None
        try:
            while True:
                frame = session.model.latest_frame
                if frame is not None and frame is not last:
                    last = frame
                    ok, jpg = cv2.imencode(".jpg", frame.image,
                                           [cv2.IMWRITE_JPEG_QUALITY, 85])
                    if ok:
                        await resp.write(
                            b"--mjpeg\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(jpg)}\r\n\r\n".encode()
                            + jpg.tobytes() + b"\r\n")
                await asyncio.sleep(1.0 / fps)
        except ConnectionResetError:
            pass
        return resp

    async def camera(request: web.Request) -> web.Response:
        """The free camera of an ER-NeRF session; with /preview it stands in
        for the reference's dearpygui orbit viewer (gui.py mouse handlers).
        JSON body: {"session_id": ..., "enable": bool (default true),
        "orbit": [dx, dy], "scale": delta, "pan": [dx, dy(, dz)],
        "reset": bool}, with gui.py:56-69's semantics."""
        params = await request.json()
        session = require_session(params)
        model = session.model
        if not hasattr(model, "set_orbit_camera"):
            return json_err("session model has no interactive camera")
        if not params.get("enable", True):
            model.set_orbit_camera(False)
            return json_ok(data="camera disabled")
        cam = model.set_orbit_camera(True)
        if params.get("reset"):
            cam.reset()
        if "orbit" in params:
            cam.orbit(*params["orbit"])
        if "scale" in params:
            cam.scale(params["scale"])
        if "pan" in params:
            cam.pan(*params["pan"])
        return json_ok(data={"radius": float(cam.radius), "pose": cam.pose.tolist()})

    async def get_metrics(request: web.Request) -> web.Response:
        return web.json_response(metrics.snapshot())

    async def health(request: web.Request) -> web.Response:
        return json_ok(status="healthy", sessions=len(manager.sessions))

    async def profile(request: web.Request) -> web.Response:
        """Capture a torch.profiler trace (CPU + CUDA activity) of the live
        pipeline: GET /profile?seconds=2&dir=mf_trace writes a Chrome trace
        under ``dir`` (relative to the server's working directory)."""
        import time

        import torch
        from torch.profiler import ProfilerActivity, profile as torch_profile

        seconds = min(float(request.query.get("seconds", 2.0)), 30.0)
        trace_dir = request.query.get("dir", "mf_trace")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = torch_profile(activities=activities)
        try:
            prof.start()
        except RuntimeError as exc:
            return json_err(f"profiler unavailable: {exc}", status=503)
        try:
            await asyncio.sleep(seconds)
        finally:
            # stop even on client-disconnect cancellation
            prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"trace_{int(time.time() * 1000)}.json")
        prof.export_chrome_trace(path)
        return json_ok(data={"trace": path, "seconds": seconds})

    app.router.add_post("/start_session", start_session)
    app.router.add_post("/stop_session", stop_session)
    app.router.add_post("/interrupt", interrupt)
    app.router.add_post("/talk", talk)
    app.router.add_post("/set_audio_type", set_audio_type)
    app.router.add_post("/record", record)
    app.router.add_get("/preview", preview)
    app.router.add_post("/camera", camera)
    app.router.add_get("/metrics", get_metrics)
    app.router.add_get("/health", health)
    app.router.add_get("/profile", profile)

    async def on_shutdown(app):
        await manager.close_all()

    app.on_shutdown.append(on_shutdown)
    return app


def run_server(cfg: Config, engine_factory, llm=None, devices=None) -> None:
    app = create_app(cfg, engine_factory, llm, devices)
    web.run_app(app, host=cfg.server.listen_host, port=cfg.server.listen_port)
