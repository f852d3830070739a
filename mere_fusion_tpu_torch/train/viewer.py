"""Interactive ER-NeRF training viewer over HTTP: watch the avatar learn.

Port of mere_fusion_tpu/train/viewer.py, the headless form of the reference
GUI's train mode (ernerf/nerf_triplane/gui.py:140-162): every displayed
frame follows ``train_steps`` optimiser steps (4 to 16, retargeted so that
training takes about 500 ms a displayed frame), rendered from the current
orbit camera with the in-flight (non-EMA) weights.

  GET  /preview   MJPEG stream of the newest rendered training view
  GET  /stats     {"step", "loss", "train_steps", "train_ms_per_it", "render_ms"}
  POST /camera    {"dx", "dy"} orbit · {"scale"} dolly · {"pan": [dx, dy]}
                  · {"reset": true}, the serving /camera contract

``TrainingViewer.tick(state, it, metrics)`` is called once an iteration
from the train loop. The clock reads the host, as in the JAX package: on
the card the steps are queued ahead of the device, so the train time reads
their enqueue time and the render's readback waits for the queued steps.
Unlike the JAX viewer, ``close`` also ends the /preview streams.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mere_fusion_tpu_torch.engines.orbit import OrbitCamera


class TrainingViewer:
    """HTTP MJPEG viewer around a render closure.

    render_fn(state, pose [4, 4] f32, intrinsics [4] f32) → float image
    [H, W, 3] in [0, 1] (numpy), rendered from the training state passed to
    ``tick``: its current weights, not the EMA, as the reference's train
    GUI shows.
    """

    def __init__(self, render_fn, width: int = 256, height: int = 256, port: int = 0,
                 radius: float = 3.35, fovy: float = 21.24, target_train_ms: float = 500.0):
        # radius and fovy: the reference GUI's defaults for the face scene
        self.render_fn = render_fn
        self.cam = OrbitCamera(width, height, r=radius, fovy=fovy)
        self.train_steps = 16          # adaptive, 4..16 (gui.py:118)
        self.target_train_ms = target_train_ms
        self._tick_count = 0
        self._t_window = time.perf_counter()
        self._lock = threading.Lock()
        # /camera POSTs arrive on the server's handler threads while the
        # training thread renders: camera updates and pose snapshots must not
        # interleave
        self._cam_lock = threading.Lock()
        self._jpeg: bytes | None = None
        self._jpeg_seq = 0
        self._closed = False
        self._frame_event = threading.Condition(self._lock)
        self.stats: dict = {"step": 0, "train_steps": self.train_steps}
        self._state = None
        self._httpd = _make_server(self, port)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="train-viewer",
                                        daemon=True)
        self._thread.start()

    # -- train-loop side -------------------------------------------------------
    def bind_state(self, state) -> None:
        with self._lock:
            self._state = state

    def tick(self, state, it: int, metrics: dict) -> None:
        """Call once a training iteration; renders every train_steps."""
        self.bind_state(state)
        self._tick_count += 1
        if self._tick_count < self.train_steps:
            return
        t_train = (time.perf_counter() - self._t_window) * 1e3
        t0 = time.perf_counter()
        self._render_once(state)
        render_ms = (time.perf_counter() - t0) * 1e3
        # retarget: the measured train time scaled to a full 16-step window,
        # aiming at target_train_ms of training a displayed frame, moved only
        # when 20% off (gui.py:158-162)
        full_t = t_train / self._tick_count * 16.0
        want = min(16, max(4, int(16 * self.target_train_ms / max(full_t, 1e-3))))
        if want > self.train_steps * 1.2 or want < self.train_steps * 0.8:
            self.train_steps = want
        with self._lock:
            self.stats = {
                "step": int(it),
                "loss": float(metrics.get("loss", float("nan"))),
                "train_steps": self.train_steps,
                "train_ms_per_it": t_train / max(self._tick_count, 1),
                "render_ms": render_ms,
            }
        self._tick_count = 0
        self._t_window = time.perf_counter()

    def _render_once(self, state) -> None:
        with self._cam_lock:     # a coherent snapshot; render outside the lock
            pose = self.cam.pose.astype(np.float32)
            intr = self.cam.intrinsics.astype(np.float32)
        img = np.asarray(self.render_fn(state, pose, intr))
        u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        import cv2

        ok, jpg = cv2.imencode(".jpg", u8[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 85])
        if not ok:
            return
        with self._frame_event:
            self._jpeg = jpg.tobytes()
            self._jpeg_seq += 1
            self._frame_event.notify_all()

    def close(self) -> None:
        with self._frame_event:
            self._closed = True
            self._frame_event.notify_all()
        self._httpd.shutdown()
        self._thread.join(timeout=5)
        self._httpd.server_close()

    # -- HTTP side -----------------------------------------------------------
    def wait_jpeg(self, last_seq: int, timeout: float = 5.0):
        """(the newest JPEG, its sequence number), waiting up to timeout for
        one newer than last_seq; (None, last_seq) once the viewer is closed."""
        with self._frame_event:
            if self._jpeg_seq == last_seq and not self._closed:
                self._frame_event.wait(timeout)
            if self._closed:
                return None, last_seq
            return self._jpeg, self._jpeg_seq

    def apply_camera(self, msg: dict) -> None:
        with self._cam_lock:     # handler threads race each other and tick
            if msg.get("reset"):
                self.cam.reset()
            if "dx" in msg or "dy" in msg:
                self.cam.orbit(float(msg.get("dx", 0)), float(msg.get("dy", 0)))
            if "scale" in msg:
                self.cam.scale(float(msg["scale"]))
            if "pan" in msg:
                dx, dy = msg["pan"]
                self.cam.pan(float(dx), float(dy))
        # the next tick renders the new view; render one now for an idle viewer
        state = self._state
        if state is not None:
            self._render_once(state)


def _make_server(viewer: TrainingViewer, port: int) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/stats"):
                with viewer._lock:
                    body = json.dumps(viewer.stats).encode()
                self._json(200, body)
            elif self.path.startswith("/preview"):
                self.send_response(200)
                self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=mjpeg")
                self.end_headers()
                seq = -1
                try:
                    while not viewer._closed:
                        jpg, seq2 = viewer.wait_jpeg(seq)
                        if jpg is None or seq2 == seq:
                            continue
                        seq = seq2
                        self.wfile.write(b"--mjpeg\r\nContent-Type: image/jpeg\r\n"
                                         + f"Content-Length: {len(jpg)}\r\n\r\n".encode()
                                         + jpg + b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self.send_error(404)

        def do_POST(self):
            if not self.path.startswith("/camera"):
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                viewer.apply_camera(json.loads(self.rfile.read(n) or b"{}"))
            except (ValueError, KeyError, TypeError) as e:
                self._json(400, json.dumps({"error": str(e)}).encode())
                return
            self._json(200, b'{"ok": true}')

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)
