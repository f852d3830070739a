"""Face-attribute nets (age / gender / race / emotion).

Port of mere_fusion_tpu/models/face_attrs.py. The reference folds
``DeepFace.analyze(..., actions=['age', 'gender', 'race', 'emotion'],
enforce_detection=False)`` of the caller's frame into its scene summary
whenever a person is detected (yolo_opencv.py:202-217). The public DeepFace
topologies, NCHW:

- ``VGGFaceAttr``: the VGG-Face backbone (13 convs in 5 blocks, two
  convolutional "fc" layers) with a 1×1 conv head; DeepFace's age (101-way),
  gender (2-way) and race (6-way) models share it. Its input is BGR, as
  DeepFace feeds OpenCV frames unconverted.
- ``EmotionNet``: DeepFace's expression CNN, 48×48 grayscale, five VALID
  convs with max/avg pooling, three dense layers, 7-way softmax. It flattens
  in Keras's channels-last order, so the ``dense_0`` rows of a Keras file
  or a flax tree need no permutation.

Modules are named as the flax ones with dots (``conv_0``, ``fc_0``,
``head``, ``dense_0``); ``utils/keras_convert.py`` reads DeepFace's ``.h5``
files onto them. The analyzer runs the faces of a frame as one batch per
net; softmax and the class arithmetic are float32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mere_fusion_tpu_torch.device import device_scope, random_init_, resolve_device

GENDER_LABELS = ("Woman", "Man")
RACE_LABELS = ("asian", "indian", "black", "white",
               "middle eastern", "latino hispanic")
EMOTION_LABELS = ("angry", "disgust", "fear", "happy",
                  "sad", "surprise", "neutral")

# the most faces of a frame that are analysed
MAX_FACES = 4

# (channels, repeats) for the five VGG-Face conv blocks
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def _width(width: float):
    return lambda n: max(int(round(n * width)), 4)


class VGGFaceAttr(nn.Module):
    """VGG-Face backbone + n-way 1×1-conv head. Input [N, 3, 224, 224] in
    [0, 1], BGR; output [N, n_classes] probabilities (float32).

    ``width`` scales every channel count (published files: 1.0)."""

    def __init__(self, n_classes: int, width: float = 1.0):
        super().__init__()
        c = _width(width)
        cin, i = 3, 0
        for channels, reps in _VGG_BLOCKS:
            for _ in range(reps):
                setattr(self, f"conv_{i}", nn.Conv2d(cin, c(channels), 3, padding=1))
                cin, i = c(channels), i + 1
        # the "fc" layers stay convolutional, as in the original: 7×7 VALID
        # over the final 7×7 map, then 1×1
        self.fc_0 = nn.Conv2d(cin, c(4096), 7)
        self.fc_1 = nn.Conv2d(c(4096), c(4096), 1)
        self.head = nn.Conv2d(c(4096), n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.head.weight.dtype)
        i = 0
        for _channels, reps in _VGG_BLOCKS:
            for _ in range(reps):
                x = F.relu(getattr(self, f"conv_{i}")(x))
                i += 1
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.fc_0(x))
        x = F.relu(self.fc_1(x))
        return self.head(x).flatten(1).float().softmax(-1)


class EmotionNet(nn.Module):
    """DeepFace's facial-expression CNN ([N, 1, 48, 48] → 7-way softmax)."""

    def __init__(self, n_classes: int = 7, width: float = 1.0):
        super().__init__()
        c = _width(width)
        self.conv_0 = nn.Conv2d(1, c(64), 5)
        self.conv_1 = nn.Conv2d(c(64), c(64), 3)
        self.conv_2 = nn.Conv2d(c(64), c(64), 3)
        self.conv_3 = nn.Conv2d(c(64), c(128), 3)
        self.conv_4 = nn.Conv2d(c(128), c(128), 3)
        self.dense_0 = nn.Linear(c(128), c(1024))
        self.dense_1 = nn.Linear(c(1024), c(1024))
        self.dense_2 = nn.Linear(c(1024), n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dense_2.weight.dtype)
        x = F.max_pool2d(F.relu(self.conv_0(x)), 5, 2)
        x = F.relu(self.conv_1(x))
        x = F.avg_pool2d(F.relu(self.conv_2(x)), 3, 2)
        x = F.relu(self.conv_3(x))
        x = F.avg_pool2d(F.relu(self.conv_4(x)), 3, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)     # Keras Flatten(): channels last
        x = F.relu(self.dense_0(x))
        x = F.relu(self.dense_1(x))
        return self.dense_2(x).float().softmax(-1)


def apparent_age(age_probs: torch.Tensor) -> torch.Tensor:
    """Expected value over the 101 age bins (DeepFace findApparentAge)."""
    bins = torch.arange(age_probs.shape[-1], dtype=torch.float32, device=age_probs.device)
    return (age_probs * bins).sum(-1)


_TASKS = (("age", 101), ("gender", 2), ("race", 6))


def _build(module_fn, state, device, dtype, seed: int) -> nn.Module:
    with torch.device("meta"):
        net = module_fn()
    net.to_empty(device=device)
    if state is None:
        random_init_(net, seed)
    else:
        net.load_state_dict(state, strict=True)
    return net.to(dtype).eval()


class FaceAttributeAnalyzer:
    """Host wrapper: crop faces, batch them, run the attribute nets on the
    device.

    Gives per-face dicts with DeepFace.analyze's keys (reference consumption:
    yolo_opencv.py:203-216): ``age``, ``gender``/``dominant_gender``,
    ``race``/``dominant_race``, ``emotion``/``dominant_emotion``, ``region``;
    distributions in percent, as DeepFace's.

    ``age``, ``gender``, ``race``, ``emotion`` are the port's state dicts of
    the tasks to run (any subset). ``detector`` is an optional callable
    ``frame_bgr -> [(x1, y1, x2, y2), ...]``; without one the whole frame is
    one face, DeepFace's ``enforce_detection=False`` fallback."""

    def __init__(self, age=None, gender=None, race=None, emotion=None,
                 width: float = 1.0, dtype: torch.dtype = torch.float32, detector=None,
                 max_faces: int = MAX_FACES, device=None, seed: int = 0,
                 tasks: tuple = ()):
        self.detector = detector
        self.max_faces = max_faces
        self.device = resolve_device(device)
        given = {"age": age, "gender": gender, "race": race, "emotion": emotion}
        self.nets: dict[str, nn.Module] = {}
        with device_scope(self.device):
            for task, n_cls in _TASKS + (("emotion", 7),):
                state = given[task]
                if state is None and task not in tasks:
                    continue
                build = (lambda: EmotionNet(width=width)) if task == "emotion" else \
                    (lambda n=n_cls: VGGFaceAttr(n_classes=n, width=width))
                self.nets[task] = _build(build, state, self.device, dtype, seed)

    @classmethod
    def from_h5(cls, age: Optional[str] = None, gender: Optional[str] = None,
                race: Optional[str] = None, emotion: Optional[str] = None,
                **kw) -> "FaceAttributeAnalyzer":
        """DeepFace's published Keras weight files (any subset), e.g.
        ``from_h5(age="age_model_weights.h5",
        emotion="facial_expression_model_weights.h5")``."""
        from mere_fusion_tpu_torch.utils.keras_convert import (
            convert_emotion_h5,
            convert_vggface_h5,
        )

        width = kw.get("width", 1.0)     # the converters check the files' shapes at it
        states = {}
        for task, n_cls in _TASKS:
            path = {"age": age, "gender": gender, "race": race}[task]
            if path is not None:
                states[task] = convert_vggface_h5(path, n_classes=n_cls, width=width)
        if emotion is not None:
            states["emotion"] = convert_emotion_h5(emotion, width=width)
        return cls(**states, **kw)

    @classmethod
    def init_random(cls, tasks=("age", "gender", "race", "emotion"), width: float = 0.25,
                    seed: int = 0, **kw) -> "FaceAttributeAnalyzer":
        """Seeded random weights, so the pipeline runs without checkpoints."""
        return cls(width=width, seed=seed, tasks=tuple(tasks), **kw)

    def _faces(self, frame_bgr: np.ndarray):
        if self.detector is None:
            h, w = frame_bgr.shape[:2]
            return [(0, 0, w, h)]
        boxes = self.detector(frame_bgr)
        return [tuple(int(v) for v in b[:4]) for b in boxes][: self.max_faces]

    @torch.no_grad()
    def probabilities(self, bgr224: np.ndarray, gray48: np.ndarray) -> dict[str, np.ndarray]:
        """[N, 224, 224, 3] BGR and [N, 48, 48] gray crops in [0, 1] → each
        task's [N, classes] probabilities."""
        with device_scope(self.device):
            x = torch.from_numpy(bgr224).to(self.device).permute(0, 3, 1, 2)
            g = torch.from_numpy(gray48).to(self.device)[:, None]
            return {task: net(g if task == "emotion" else x).cpu().numpy()
                    for task, net in self.nets.items()}

    def analyze(self, frame_bgr: np.ndarray) -> list[dict]:
        import cv2

        regions = self._faces(frame_bgr)
        if not regions:
            return []
        n = len(regions)
        bgr224 = np.zeros((n, 224, 224, 3), np.float32)
        gray48 = np.zeros((n, 48, 48), np.float32)
        for i, (x1, y1, x2, y2) in enumerate(regions):
            crop = frame_bgr[max(y1, 0):max(y2, y1 + 1),
                             max(x1, 0):max(x2, x1 + 1)]
            if crop.size == 0:
                crop = frame_bgr
            bgr224[i] = cv2.resize(crop, (224, 224)).astype(np.float32) / 255.0
            g = cv2.cvtColor(crop, cv2.COLOR_BGR2GRAY)
            gray48[i] = cv2.resize(g, (48, 48)).astype(np.float32) / 255.0
        probs = self.probabilities(bgr224, gray48)

        out = []
        for i, (x1, y1, x2, y2) in enumerate(regions):
            face = {"region": {"x": x1, "y": y1, "w": x2 - x1, "h": y2 - y1}}
            if "age" in probs:
                face["age"] = int(round(float(
                    np.sum(probs["age"][i] * np.arange(probs["age"].shape[-1])))))
            for task, labels in (("gender", GENDER_LABELS),
                                 ("race", RACE_LABELS),
                                 ("emotion", EMOTION_LABELS)):
                if task in probs:
                    dist = {lab: float(p) * 100.0
                            for lab, p in zip(labels, probs[task][i])}
                    face[task] = dist
                    face[f"dominant_{task}"] = max(dist, key=dist.get)
            out.append(face)
        return out
