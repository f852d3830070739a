"""Video understanding of the caller's camera: the stub summarizer.

Port of the stub half of mere_fusion_tpu/perception/__init__.py:
``StubPerception`` gives the summary contract (a string every
``fps_throttle``-th frame, else None) from basic image statistics, so the
full-duplex plane runs anywhere. The YOLOv10 detector with face attributes
and OCR (``yolo-tpu``, ``yolo``) is not ported yet (ROADMAP: 'Perception').
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class StubPerception:
    """Dependency-free scene summarizer (shape/brightness/motion)."""

    def __init__(self, fps_throttle: int = 10):
        self.fps_throttle = fps_throttle
        self._count = 0
        self._prev: Optional[np.ndarray] = None

    def process_frame(self, frame_bgr: np.ndarray) -> Optional[str]:
        self._count += 1
        if self._count % self.fps_throttle != 0:
            return None
        small = frame_bgr[::8, ::8].astype(np.float32)
        brightness = float(small.mean())
        motion = 0.0
        if self._prev is not None and self._prev.shape == small.shape:
            motion = float(np.abs(small - self._prev).mean())
        self._prev = small
        h, w = frame_bgr.shape[:2]
        light = "bright" if brightness > 128 else "dim"
        moving = "movement detected" if motion > 8 else "static scene"
        return f"{w}x{h} {light} scene, {moving}"


def make_perception(kind: str = "stub", **kw):
    if kind == "stub":
        return StubPerception(**kw)
    if kind in ("yolo", "yolo-tpu", "yolo_tpu"):
        raise NotImplementedError(
            f"perception backend {kind!r} is not ported to the PyTorch package yet "
            "(ROADMAP: 'Perception')")
    raise ValueError(f"unknown perception backend {kind!r}")
