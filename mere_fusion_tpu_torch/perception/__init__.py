"""Video understanding: object, face and text analysis of the caller's camera.

Port of mere_fusion_tpu/perception/__init__.py, the equivalent of the
reference's yolo_opencv.py (YOLOv10 detection with frame-rate throttling,
DeepFace attributes when a person is present, EasyOCR text;
yolo_opencv.py:136-221):

- ``StubPerception``: the summary contract (a string every
  ``fps_throttle``-th frame, else None) from basic image statistics;
- ``TPUYoloPerception`` (backends ``yolo-tpu``/``yolo_tpu``, the names the
  config shares with the JAX package): the port's YOLOv10 on the session's
  card, with the port's face-attribute nets and CRAFT+CRNN reader when they
  are given, else the deepface/easyocr libraries when importable;
- ``YoloPerception`` (``yolo``): the ultralytics package's model, imported
  when built.

The summary sentences are the JAX package's, character for character.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mere_fusion_tpu_torch.device import device_scope, resolve_device


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


def _counts_summary(labels) -> tuple[str, bool]:
    counts: dict[str, int] = {}
    person_seen = False
    for label in labels:
        counts[label] = counts.get(label, 0) + 1
        person_seen |= label == "person"
    parts = [f"{n} {label}(s)" for label, n in sorted(counts.items())]
    return "scene contains " + (", ".join(parts) if parts else "nothing notable"), person_seen


class YoloPerception:
    """YOLO + DeepFace + EasyOCR summarizer (needs ultralytics etc.)."""

    def __init__(self, model_path: str = "yolov10x.pt", fps_throttle: int = 10,
                 use_deepface: bool = True, use_ocr: bool = True):
        from ultralytics import YOLO

        self.model = YOLO(model_path)
        self.fps_throttle = fps_throttle
        self.use_deepface = use_deepface
        self.use_ocr = use_ocr
        self._count = 0
        self._reader = None

    def process_frame(self, frame_bgr: np.ndarray) -> Optional[str]:
        self._count += 1
        if self._count % self.fps_throttle != 0:
            return None
        results = self.model(frame_bgr, verbose=False)[0]
        summary, person_seen = _counts_summary(
            results.names[int(c)] for c in results.boxes.cls.tolist())
        if person_seen and self.use_deepface:
            summary += _deepface_summary(frame_bgr)
        if self.use_ocr:
            try:
                if self._reader is None:
                    import easyocr

                    self._reader = easyocr.Reader(["en", "ch_sim"])
                texts = [t[1] for t in self._reader.readtext(frame_bgr)]
                if texts:
                    summary += "; visible text: " + " | ".join(texts[:5])
            except Exception:
                pass
        return summary


class TPUYoloPerception:
    """On-device YOLOv10 scene summarizer, the ultralytics-free path: the
    port's YOLOv10 (models/yolo.py) on ``device`` in bf16 in place of the
    reference's ultralytics model (yolo_opencv.py:42, 152-221), with the
    same summary contract: throttled object counts, face attributes when a
    person is seen, scene text.

    ``ckpt`` is an ultralytics ``yolov10*.pt``, read by the tolerant
    unpickler of utils/yolo_convert.py without the ultralytics package, or a
    converted directory (tools/convert_ckpt.py's, or the JAX package's orbax
    one, which needs ``tensorstore``); one copy of its weights a (ckpt,
    device), shared by the sessions there.
    Without it the weights are seeded random ones. ``face_attrs`` and ``ocr``
    are specs for ``make_face_attrs`` / ``make_ocr`` (None: the deepface /
    easyocr libraries when importable). With no ``device`` the current CUDA
    device is used, and without one the build raises."""

    def __init__(self, ckpt: Optional[str] = None, scale: str = "x",
                 fps_throttle: int = 10, conf: float = 0.25,
                 use_deepface: bool = True, use_ocr: bool = True,
                 detector=None, device=None, face_attrs=None, ocr=None):
        from mere_fusion_tpu_torch.models.yolo import YoloDetector

        if detector is not None:
            self.detector = detector
            self.device = getattr(detector, "device", device)
        else:
            self.device = resolve_device(device)
            if ckpt is not None:
                from mere_fusion_tpu_torch.engines import shared_device_tree
                from mere_fusion_tpu_torch.models.yolo import build_yolo

                # the convolutions' kernels in bf16, BatchNorm in float32
                state = shared_device_tree("yolo", ckpt, self.device, torch.bfloat16,
                                           cast=lambda t: t.ndim == 4)
                with device_scope(self.device):
                    model = build_yolo(state, scale=scale, device=self.device,
                                       dtype=torch.bfloat16)
                self.detector = YoloDetector(model=model, device=self.device)
            else:
                self.detector = YoloDetector.init_random(scale=scale, device=self.device)
        self.fps_throttle = fps_throttle
        self.conf = conf
        self.use_deepface = use_deepface
        self.use_ocr = use_ocr
        self.face_attrs = make_face_attrs(face_attrs, device=self.device)
        self.ocr = make_ocr(ocr, device=self.device)
        self._count = 0
        self._reader = None

    def process_frame(self, frame_bgr: np.ndarray) -> Optional[str]:
        self._count += 1
        if self._count % self.fps_throttle != 0:
            return None
        # a frame comes from the event loop's executor thread, whose
        # current device is 0 whatever the session's card
        with device_scope(self.device):
            detections = self.detector.detect(frame_bgr, conf=self.conf)
            summary, person_seen = _counts_summary(label for _b, _s, label in detections)
            if person_seen and self.face_attrs is not None:
                summary += _face_attr_summary(frame_bgr, self.face_attrs)
            elif person_seen and self.use_deepface:
                summary += _deepface_summary(frame_bgr)
            if self.use_ocr:
                summary += self._ocr_summary(frame_bgr)
        return summary

    def _ocr_summary(self, frame_bgr: np.ndarray) -> str:
        if self.ocr is not None:
            # the port's CRAFT+CRNN reader (models/ocr.py), consumed as the
            # reference consumes easyocr (yolo_opencv.py:195-199)
            texts = [t[1] for t in self.ocr.readtext(frame_bgr)]
            return "; visible text: " + " | ".join(texts[:5]) if texts else ""
        try:
            if self._reader is None:
                import easyocr

                self._reader = easyocr.Reader(["en", "ch_sim"])
            texts = [t[1] for t in self._reader.readtext(frame_bgr)]
            if texts:
                return "; visible text: " + " | ".join(texts[:5])
        except Exception:
            pass
        return ""


def parse_perception_spec(s: str):
    """CLI/config string → make_face_attrs / make_ocr spec.

    ``""`` → None (disabled / the library fallback), ``"random"`` → random
    weights, ``"key=path,key2=path2"`` → kwargs dict (e.g.
    ``age=age.h5,gender=gender.h5`` or
    ``craft=craft_mlt_25k.pth,crnn=english_g2.pth``).
    """
    if not s:
        return None
    if s == "random":
        return "random"
    out = {}
    for part in s.split(","):
        k, eq, v = part.partition("=")
        if not eq or not k.strip() or not v.strip():
            raise ValueError(
                f"perception spec {s!r}: expected 'random' or "
                "comma-separated key=path pairs")
        out[k.strip()] = v.strip()
    return out


def make_face_attrs(spec, device=None):
    """A face-attrs spec as a FaceAttributeAnalyzer on ``device`` (or None).

    ``spec``: None → disabled (the deepface fallback applies); "random" →
    narrow (width 0.25) seeded nets for age, gender and emotion, so the
    pipeline runs without checkpoints; a dict of DeepFace .h5 paths (keys
    age/gender/race/emotion) → real weights via utils/keras_convert.py; or
    an analyzer already built."""
    if spec is None or spec is False:
        return None
    from mere_fusion_tpu_torch.models.face_attrs import FaceAttributeAnalyzer

    if isinstance(spec, FaceAttributeAnalyzer):
        return spec
    if spec == "random":
        return FaceAttributeAnalyzer.init_random(tasks=("age", "gender", "emotion"),
                                                 device=device)
    if isinstance(spec, dict):
        return FaceAttributeAnalyzer.from_h5(**spec, device=device)
    raise ValueError(f"unknown face_attrs spec {spec!r}")


def make_ocr(spec, device=None):
    """An OCR spec as a TextReader on ``device`` (or None → the easyocr
    fallback).

    ``spec``: None/False → disabled; "random" → a seeded reader with a
    narrow (width 0.25) detector; a dict of TextReader kwargs whose
    ``craft``/``crnn`` entries are EasyOCR checkpoint paths, converted on
    the fly; or a reader already built."""
    if spec is None or spec is False:
        return None
    from mere_fusion_tpu_torch.models.ocr import TextReader

    if isinstance(spec, TextReader):
        return spec
    if spec == "random":
        return TextReader(width=0.25, device=device)
    if isinstance(spec, dict):
        from mere_fusion_tpu_torch.utils.torch_convert import (
            convert_craft,
            convert_crnn,
            load_torch_checkpoint,
        )

        kw = dict(spec)
        if isinstance(kw.get("craft"), str):
            kw["det_state"] = convert_craft(load_torch_checkpoint(kw.pop("craft")))
        if isinstance(kw.get("crnn"), str):
            kw["rec_state"] = convert_crnn(load_torch_checkpoint(kw.pop("crnn")))
        return TextReader(**{"device": device, **kw})
    raise ValueError(f"unknown ocr spec {spec!r}")


def _face_attr_summary(frame_bgr: np.ndarray, analyzer) -> str:
    """The sentence of _deepface_summary, from the port's nets."""
    faces = analyzer.analyze(frame_bgr)
    if not faces:
        return ""
    f = faces[0]
    return (f"; person appears {f.get('age', '?')} years old, "
            f"{f.get('dominant_gender', '?')}, "
            f"{f.get('dominant_emotion', '?')}")


def _deepface_summary(frame_bgr: np.ndarray) -> str:
    try:
        from deepface import DeepFace

        faces = DeepFace.analyze(
            frame_bgr, actions=("age", "gender", "emotion"),
            enforce_detection=False, silent=True,
        )
        if faces:
            f = faces[0]
            return (f"; person appears {f.get('age', '?')} years old, "
                    f"{f.get('dominant_gender', '?')}, "
                    f"{f.get('dominant_emotion', '?')}")
    except Exception:
        pass
    return ""


def make_perception(kind: str = "stub", **kw):
    if kind == "stub":
        return StubPerception(**kw)
    if kind == "yolo":
        return YoloPerception(**kw)
    if kind in ("yolo-tpu", "yolo_tpu"):
        return TPUYoloPerception(**kw)
    raise ValueError(f"unknown perception backend {kind!r}")
