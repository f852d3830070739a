"""ER-NeRF test-time dataset: poses, blink areas, background.

Port of the test-set half of mere_fusion_tpu/data/provider.py (the twin of
the reference's NeRFDataset_Test): transforms.json poses converted to NGP
coordinates, optional camera-path smoothing, AU45 blink areas from
OpenFace's au.csv, and infinite mirrored looping for live streaming. The
training dataset (preload tiers) is not ported yet.
"""
from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass

import cv2
import numpy as np


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float, offset=(0, 0, 0)) -> np.ndarray:
    """Axis permutation + scaling into the NGP convention."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def ngp_to_nerf_matrix(pose: np.ndarray, scale: float, offset=(0, 0, 0)) -> np.ndarray:
    """Exact inverse of nerf_matrix_to_ngp (for synthesizing datasets)."""
    out = np.eye(4, dtype=np.float32)
    out[0, :3] = pose[2, :3] * np.array([1, -1, -1])
    out[1, :3] = pose[0, :3] * np.array([1, -1, -1])
    out[2, :3] = pose[1, :3] * np.array([1, -1, -1])
    out[0, 3] = (pose[2, 3] - offset[2]) / scale
    out[1, 3] = (pose[0, 3] - offset[0]) / scale
    out[2, 3] = (pose[1, 3] - offset[1]) / scale
    return out


def smooth_camera_path(poses: np.ndarray, kernel_size: int = 5) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    n = poses.shape[0]
    k = kernel_size // 2
    trans = poses[:, :3, 3].copy()
    rots = poses[:, :3, :3].copy()
    for i in range(n):
        lo, hi = max(0, i - k), min(n, i + k + 1)
        poses[i, :3, 3] = trans[lo:hi].mean(0)
        poses[i, :3, :3] = Rotation.from_matrix(rots[lo:hi]).mean().as_matrix()
    return poses


def read_au45(au_path: str) -> np.ndarray:
    """The AU45_r (blink) column of an OpenFace au.csv, whose header names
    carry a leading space."""
    with open(au_path, newline="") as f:
        rows = list(csv.DictReader(f))
    return np.asarray([float(r[" AU45_r"]) for r in rows], np.float64)


@dataclass
class NeRFTestDataset:
    poses: np.ndarray        # [N, 4, 4] NGP-space c2w
    eye_area: np.ndarray     # [N] in [0, 1] (AU45/2 clipped)
    bg_img: np.ndarray       # [H, W, 3] float32 RGB
    intrinsics: tuple        # (fx, fy, cx, cy)
    H: int
    W: int

    def __len__(self) -> int:
        return self.poses.shape[0]

    def mirror_index(self, index: int) -> int:
        size = len(self)
        turn, res = divmod(index, size)
        return res if turn % 2 == 0 else size - res - 1

    def collate(self, index: int) -> dict:
        i = self.mirror_index(index)
        return {
            "index": i,
            "pose": self.poses[i],
            "eye": np.asarray([[self.eye_area[i]]], np.float32),
            "bg_color": self.bg_img.reshape(-1, 3),
        }

    def __iter__(self):
        i = 0
        while True:
            yield self.collate(i)
            i += 1

    @classmethod
    def load(cls, pose_path: str, au_path: str = "", bg_img: str = "white",
             scale: float = 4.0, offset=(0, 0, 0), smooth_path: bool = False,
             smooth_path_window: int = 7, smooth_eye: bool = False,
             data_range=(0, -1)) -> "NeRFTestDataset":
        with open(pose_path) as f:
            transform = json.load(f)
        H = int(transform["cy"]) * 2
        W = int(transform["cx"]) * 2
        frames = transform["frames"]
        end = data_range[1] if data_range[1] != -1 else len(frames)
        frames = frames[data_range[0]: end]

        au_blink = read_au45(au_path) if au_path else None
        poses, eye_area = [], []
        for fr in frames:
            poses.append(nerf_matrix_to_ngp(
                np.array(fr["transform_matrix"], np.float32), scale, offset))
            if au_blink is not None:
                area = float(np.clip(au_blink[fr["img_id"]], 0, 2)) / 2
            else:
                area = 0.25  # default open eye
            eye_area.append(area)
        poses = np.stack(poses)
        if smooth_path:
            poses = smooth_camera_path(poses, smooth_path_window)
        eye_area = np.asarray(eye_area, np.float32)
        if smooth_eye:
            smoothed = eye_area.copy()
            for i in range(len(eye_area)):
                lo, hi = max(0, i - 1), min(len(eye_area), i + 2)
                smoothed[i] = eye_area[lo:hi].mean()
            eye_area = smoothed

        if bg_img == "white":
            bg = np.ones((H, W, 3), np.float32)
        elif bg_img == "black":
            bg = np.zeros((H, W, 3), np.float32)
        else:
            img = cv2.imread(bg_img, cv2.IMREAD_UNCHANGED)
            if img.shape[:2] != (H, W):
                img = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
            bg = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255

        fl = transform["focal_len"]
        intrinsics = (fl, fl, transform["cx"], transform["cy"])
        return cls(poses, eye_area, bg, intrinsics, H, W)


def synthesize_nerf_dataset(dirpath: str, n_frames: int = 4, hw: int = 64) -> str:
    """Write a small procedural transforms.json + au.csv: a short orbit
    looking at the origin, authored in NGP space and converted back so
    loading reproduces it exactly."""
    os.makedirs(dirpath, exist_ok=True)
    frames = []
    for i in range(n_frames):
        angle = 0.08 * i
        c, s = np.cos(angle), np.sin(angle)
        post = np.array(
            [
                [c, 0.0, s, 1.5 * s],
                [0.0, 1.0, 0.0, 0.0],
                [-s, 0.0, c, 1.5 * c],
                [0.0, 0.0, 0.0, 1.0],
            ],
            np.float32,
        )
        mat = ngp_to_nerf_matrix(post, scale=1.0).tolist()
        frames.append({"img_id": i, "aud_id": i, "transform_matrix": mat})
    pose_path = os.path.join(dirpath, "transforms.json")
    with open(pose_path, "w") as f:
        json.dump({"cx": hw / 2, "cy": hw / 2, "focal_len": hw * 1.2, "frames": frames}, f)
    au_path = os.path.join(dirpath, "au.csv")
    with open(au_path, "w") as f:
        f.write("frame, face_id, timestamp, confidence, success, AU45_r\n")
        for i in range(n_frames):
            f.write(f"{i+1}, 0, {i*0.04:.3f}, 0.98, 1, {0.2 + 0.1 * (i % 3):.2f}\n")
    return dirpath
