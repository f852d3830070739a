"""Avatar asset bundles (precomputed per-identity data).

Port of mere_fusion_tpu/engines/avatar.py. The disk format is the
reference's wav2lip avatars' (reference: wav2lip/genavatar.py:101-125,
lipreal.py:154-158):

    <avatar_dir>/<avatar_id>/
        full_imgs/{i}.png   full video frames (BGR)
        face_imgs/{i}.png   face crops (model input size)
        coords.pkl          list of (y1, y2, x1, x2) bboxes per frame

``synthesize_avatar`` generates a procedural identity for tests and
weightless demos.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import cv2
import numpy as np

from mere_fusion_tpu_torch.engines.base import _sorted_imgs


@dataclass
class LipAvatar:
    frame_cycle: list[np.ndarray]   # full frames, BGR uint8
    face_cycle: list[np.ndarray]    # face crops, BGR uint8 [S, S, 3]
    coords: list[tuple[int, int, int, int]]  # (y1, y2, x1, x2)

    def __len__(self) -> int:
        return len(self.frame_cycle)


def load_lip_avatar(avatar_path: str, face_size: int = 96) -> LipAvatar:
    with open(os.path.join(avatar_path, "coords.pkl"), "rb") as f:
        coords = pickle.load(f)
    frames = [cv2.imread(p) for p in _sorted_imgs(os.path.join(avatar_path, "full_imgs"))]
    faces = [
        cv2.resize(cv2.imread(p), (face_size, face_size))
        for p in _sorted_imgs(os.path.join(avatar_path, "face_imgs"))
    ]
    if not (len(frames) == len(faces) == len(coords)):
        raise ValueError(
            f"avatar bundle inconsistent: {len(frames)} frames, "
            f"{len(faces)} faces, {len(coords)} coords"
        )
    return LipAvatar(frames, faces, coords)


def synthesize_avatar(
    avatar_path: str,
    n_frames: int = 10,
    frame_hw: tuple[int, int] = (240, 320),
    face_size: int = 96,
) -> LipAvatar:
    """Write a procedural avatar bundle: moving gradient background with a
    fixed 'face' rectangle whose hue varies per frame."""
    h, w = frame_hw
    full_dir = os.path.join(avatar_path, "full_imgs")
    face_dir = os.path.join(avatar_path, "face_imgs")
    os.makedirs(full_dir, exist_ok=True)
    os.makedirs(face_dir, exist_ok=True)

    y1, x1 = h // 4, w // 4
    y2, x2 = y1 + h // 2, x1 + w // 2
    coords = []
    for i in range(n_frames):
        yy, xx = np.mgrid[0:h, 0:w]
        frame = np.stack(
            [
                ((xx * 255) // w).astype(np.uint8),
                ((yy * 255) // h).astype(np.uint8),
                np.full((h, w), (i * 29) % 255, np.uint8),
            ],
            axis=-1,
        )
        face = frame[y1:y2, x1:x2].copy()
        face[:, :, 0] = (face[:, :, 0].astype(int) + 60) % 255
        frame[y1:y2, x1:x2] = face
        cv2.imwrite(os.path.join(full_dir, f"{i}.png"), frame)
        cv2.imwrite(
            os.path.join(face_dir, f"{i}.png"), cv2.resize(face, (face_size, face_size))
        )
        coords.append((y1, y2, x1, x2))
    with open(os.path.join(avatar_path, "coords.pkl"), "wb") as f:
        pickle.dump(coords, f)
    return load_lip_avatar(avatar_path, face_size)
