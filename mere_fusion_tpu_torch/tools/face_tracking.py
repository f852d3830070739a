"""3DMM face tracking by differentiable landmark fitting.

Port of mere_fusion_tpu/tools/face_tracking.py, the replacement for the
reference's pytorch3d-based tracker (reference
data_utils/face_tracking/face_tracker.py). The pose that the ER-NeRF data
pipeline consumes (transforms.json euler/trans + focal, process.py task 8)
is recoverable from the landmark term alone, so this fits all frames at
once with Adam:

    minimize  || project(R(euler_f)·(mean + B_id a + B_exp e_f) + t_f) - L_f ||²
              + λ_id ||a||² + λ_exp ||e_f||²

with a shared identity ``a``, per-frame expressions ``e_f``, per-frame pose
(euler_f, t_f) and a shared focal length. The photometric stage is
tools/render_3dmm.py.

The morphable-model arrays (mean [N,3], id basis [N·3, K_id], exp basis
[N·3, K_exp]) load from the reference's 3DMM asset directory, or are passed
directly (the tests and chip_smoke build synthetic ones). Every fit runs on
``device``: None is the current CUDA device, and the CPU when asked.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mere_fusion_tpu_torch.device import resolve_device


@dataclass
class MorphableModel:
    mean: np.ndarray        # [N, 3]
    base_id: np.ndarray     # [N*3, K_id]
    base_exp: np.ndarray    # [N*3, K_exp]
    faces: Optional[np.ndarray] = None     # [T, 3] triangle topology
    keyinds: Optional[np.ndarray] = None   # [68] landmark vertex ids

    @classmethod
    def load(cls, path: str) -> "MorphableModel":
        """Load from the reference's converted BFM directory
        (data_utils/face_tracking/3DMM: 3DMM_info.npy from convert_BFM.py;
        the triangle topology from topology_info.npy's "tris" and the 68
        landmark vertex ids from keys_info.npy's "keyinds" when present, the
        files the reference's renderer and face model load)."""
        info = np.load(os.path.join(path, "3DMM_info.npy"), allow_pickle=True).item()
        faces = keyinds = None
        topo_path = os.path.join(path, "topology_info.npy")
        if os.path.exists(topo_path):
            topo = np.load(topo_path, allow_pickle=True).item()
            if "tris" in topo:
                faces = np.asarray(topo["tris"], np.int32).reshape(-1, 3)
        keys_path = os.path.join(path, "keys_info.npy")
        if os.path.exists(keys_path):
            keys = np.load(keys_path, allow_pickle=True).item()
            if "keyinds" in keys:
                keyinds = np.asarray(keys["keyinds"], np.int64).reshape(-1)
        return cls(
            mean=info["mu_shape"].reshape(-1, 3).astype(np.float32),
            base_id=info["b_shape"].astype(np.float32),
            base_exp=info["b_exp"].astype(np.float32),
            faces=faces,
            keyinds=keyinds,
        )

    def subset(self, idx) -> "MorphableModel":
        """The model restricted to vertices ``idx`` (no topology)."""
        idx = np.asarray(idx)
        ki, ke = self.base_id.shape[-1], self.base_exp.shape[-1]
        return MorphableModel(
            mean=self.mean[idx],
            base_id=self.base_id.reshape(-1, 3, ki)[idx].reshape(-1, ki),
            base_exp=self.base_exp.reshape(-1, 3, ke)[idx].reshape(-1, ke),
        )


def euler_to_rot(euler: torch.Tensor) -> torch.Tensor:
    """[..., 3] (pitch, yaw, roll) → [..., 3, 3] rotation matrices (the
    reference's euler2rot convention, face_tracking/geo_transform.py)."""
    x, y, z = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    rx = torch.stack([one, zero, zero,
                      zero, cx, -sx,
                      zero, sx, cx], -1).reshape(*x.shape, 3, 3)
    ry = torch.stack([cy, zero, sy,
                      zero, one, zero,
                      -sy, zero, cy], -1).reshape(*x.shape, 3, 3)
    rz = torch.stack([cz, -sz, zero,
                      sz, cz, zero,
                      zero, zero, one], -1).reshape(*x.shape, 3, 3)
    return rz @ ry @ rx


def project(points: torch.Tensor, focal, center: tuple) -> torch.Tensor:
    """Perspective projection [..., N, 3] → [..., N, 2] pixels; the camera
    looks down -z (the reference's forward_transform, geo_transform.py)."""
    z = torch.clamp(-points[..., 2], min=1e-4)
    u = points[..., 0] / z * focal + center[0]
    v = -points[..., 1] / z * focal + center[1]
    return torch.stack([u, v], dim=-1)


def model_tensors(model: MorphableModel, device) -> tuple:
    """(mean [N,3], id basis [N,3,Ki], exp basis [N,3,Ke]) on ``device``."""
    mean = torch.as_tensor(model.mean, dtype=torch.float32, device=device)
    n = mean.shape[0]
    b_id = torch.as_tensor(model.base_id, dtype=torch.float32, device=device).reshape(n, 3, -1)
    b_exp = torch.as_tensor(model.base_exp, dtype=torch.float32, device=device).reshape(n, 3, -1)
    return mean, b_id, b_exp


def fit_landmarks(
    model: MorphableModel,
    landmarks: np.ndarray,          # [F, N, 2] detected 2D landmarks (px)
    image_hw: tuple,
    iters: int = 3000,
    lr: float = 3e-2,
    lambda_id: float = 1e-4,
    lambda_exp: float = 1e-4,
    init_trans_z: float = -600.0,
    init_focal: float = 1150.0,
    freeze_focal: bool = False,
    device=None,
) -> dict:
    """Fit shared id + focal and per-frame exp/euler/trans to landmarks.

    ``freeze_focal`` keeps the focal at ``init_focal``: the focal is left
    out of the optimizer (optax's set_to_zero in the JAX twin), the probe
    mode the coarse focal sweep uses (reference face_tracker.py:54-111).
    Adam is optax's: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    which is torch.optim.Adam's formula.

    Returns {euler [F,3], trans [F,3], exp [F,Ke], id [Ki], focal ()} as
    numpy plus the final mean pixel error (the loss read before the last
    update, as the JAX twin reads it)."""
    dev = resolve_device(device)
    f, n, _ = landmarks.shape
    h, w = image_hw
    center = (w / 2.0, h / 2.0)
    mean, b_id, b_exp = model_tensors(model, dev)
    target = torch.as_tensor(np.asarray(landmarks), dtype=torch.float32, device=dev)

    params = {
        "id": torch.zeros(b_id.shape[-1], device=dev),
        "exp": torch.zeros(f, b_exp.shape[-1], device=dev),
        "euler": torch.zeros(f, 3, device=dev),
        "trans": torch.tensor([0.0, 0.0, init_trans_z], device=dev).repeat(f, 1),
        "log_focal": torch.log(torch.tensor(init_focal, dtype=torch.float32, device=dev)),
    }
    free = [k for k in params if not (freeze_focal and k == "log_focal")]
    for k in free:
        params[k].requires_grad_(True)
    opt = torch.optim.Adam([params[k] for k in free], lr=lr, foreach=False, fused=False)

    def loss_fn(p):
        pts = (mean[None]
               + torch.einsum("nvk,k->nv", b_id, p["id"])[None]
               + torch.einsum("nvk,fk->fnv", b_exp, p["exp"]))
        rot = euler_to_rot(p["euler"])                  # [F, 3, 3]
        geo = torch.einsum("fij,fnj->fni", rot, pts) + p["trans"][:, None]
        proj = project(geo, torch.exp(p["log_focal"]), center)
        lmk = ((proj - target) ** 2).sum(-1).mean()
        reg = (lambda_id * (p["id"] ** 2).sum()
               + lambda_exp * (p["exp"] ** 2).sum())
        return lmk + reg, lmk

    lmk = torch.tensor(float("inf"))
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        loss, lmk = loss_fn(params)
        loss.backward()
        opt.step()
        lmk = lmk.detach()

    out = {k: v.detach().cpu().numpy() for k, v in params.items()}
    out["focal"] = float(np.exp(out.pop("log_focal")))
    out["pixel_rmse"] = float(np.sqrt(lmk.cpu().numpy()))
    return out


def fit_landmarks_focal_sweep(
    model: MorphableModel,
    landmarks: np.ndarray,
    image_hw: tuple,
    focals=tuple(range(600, 1500, 100)),
    sweep_iters: int = 800,
    sweep_frame_stride: int = 40,
    **fit_kw,
) -> dict:
    """Coarse-to-fine focal: probe each candidate focal with a short
    frozen-focal fit on a frame subset, then run the full fit with the focal
    freed from the winner (reference face_tracker.py:45-126: sel_ids every
    40 frames, focal range(600, 1500, 100), best landmark loss wins)."""
    sel = landmarks[::max(1, sweep_frame_stride)]
    # the probes pin iters/init_focal/freeze_focal; a caller's values for
    # those keys apply to the final free-focal fit only
    probe_kw = {k: v for k, v in fit_kw.items()
                if k not in ("iters", "init_focal", "freeze_focal")}
    best_focal, best_rmse = None, np.inf
    for focal in focals:
        probe = fit_landmarks(model, sel, image_hw, iters=sweep_iters,
                              init_focal=float(focal), freeze_focal=True,
                              **probe_kw)
        if probe["pixel_rmse"] < best_rmse:
            best_focal, best_rmse = float(focal), probe["pixel_rmse"]
    final_kw = dict(fit_kw)
    final_kw.setdefault("init_focal", best_focal)
    return fit_landmarks(model, landmarks, image_hw, **final_kw)


def poses_from_fit(fit: dict) -> np.ndarray:
    """Per-frame camera-to-world matrices [F, 4, 4] from the fitted head
    pose, in the reference's transforms.json convention
    (data_utils/process.py:311-335 save_transforms).

    This tracker's camera puts the head at negative z with
    u = cx + f·X/depth, v = cy − f·Y/depth (``project``); the reference's
    puts it at positive z with u = cx − f·X/Z, v = cy + f·Y/Z
    (face_tracking/geo_transform.py:53-69). The two camera frames differ by
    a point reflection, so the exported rotation is −Rᵀ while the camera
    position −Rᵀt is unchanged."""
    rot = euler_to_rot(torch.as_tensor(np.asarray(fit["euler"]), dtype=torch.float32)).numpy()
    trans = np.asarray(fit["trans"])
    f = rot.shape[0]
    out = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    rt = rot.transpose(0, 2, 1)
    out[:, :3, :3] = -rt
    out[:, :3, 3] = -np.einsum("fij,fj->fi", rt, trans)
    return out
