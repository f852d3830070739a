"""Interactive orbit camera for the ER-NeRF live viewer.

Port of mere_fusion_tpu/engines/orbit.py, the math twin of the reference
GUI's OrbitCamera (ernerf/nerf_triplane/gui.py:12-69): NGP-convention
initial rotation, radius-then-rotate-then-translate pose composition,
rotvec orbit around the camera up/side axes, 1.1^(-delta) dolly,
camera-space pan.

The reference drives it from dearpygui mouse handlers; here it is driven
over HTTP (POST /camera, server/app.py) and the MJPEG /preview stream is
the display, so a headless server needs no GUI toolkit.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R


class OrbitCamera:
    def __init__(self, W: int, H: int, r: float = 2.0, fovy: float = 60.0):
        self.W = W
        self.H = H
        self.radius = r
        self.fovy = fovy  # degrees
        self.center = np.array([0, 0, 0], dtype=np.float32)
        # NGP-convention initial camera matrix (gui.py:19)
        self.rot = R.from_matrix([[0, -1, 0], [0, 0, -1], [1, 0, 0]])
        self.up = np.array([1, 0, 0], dtype=np.float32)
        self._initial = (r, self.rot.as_quat().copy())

    @property
    def pose(self) -> np.ndarray:
        res = np.eye(4, dtype=np.float32)
        res[2, 3] -= self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot.as_matrix()
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    def update_pose(self, pose: np.ndarray) -> None:
        """Adopt an existing c2w pose (e.g. the dataset's current frame) so
        interaction starts from where the avatar is looking."""
        self.radius = float(np.linalg.norm(pose[:3, 3]))
        T = np.eye(4)
        T[2, 3] = -self.radius
        rot = pose @ np.linalg.inv(T)
        self.rot = R.from_matrix(rot[:3, :3])

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * np.tan(np.deg2rad(self.fovy) / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2])

    def orbit(self, dx: float, dy: float) -> None:
        side = self.rot.as_matrix()[:3, 0]
        rotvec_x = self.up * np.radians(-0.01 * dx)
        rotvec_y = side * np.radians(-0.01 * dy)
        self.rot = R.from_rotvec(rotvec_x) * R.from_rotvec(rotvec_y) * self.rot

    def scale(self, delta: float) -> None:
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx: float, dy: float, dz: float = 0.0) -> None:
        self.center += 0.0001 * self.rot.as_matrix()[:3, :3] @ np.array(
            [dx, dy, dz], dtype=np.float32
        )

    def reset(self) -> None:
        self.radius, quat = self._initial
        self.rot = R.from_quat(quat)
        self.center = np.zeros(3, dtype=np.float32)
