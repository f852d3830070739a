"""The port's 3DMM landmark fitting against the JAX package's.

On a synthetic 68-vertex morphable model (numpy seeds, as
tests/test_face_tracking.py builds one): the rotation and the projection
within 2e-5; 20 Adam steps of ``fit_landmarks`` with the focal free and
frozen within 1e-4 of the largest entry of each leaf (the JAX fit's
thousands of steps to convergence are not repeated here: convergence is
checked on the card); the coarse focal sweep picking JAX's focal;
``poses_from_fit`` and ``MorphableModel.load`` as JAX's. One torch thread.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mere_fusion_tpu.tools import face_tracking as jft
from mere_fusion_tpu_torch.tools import face_tracking as ft
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
REL = 1e-4                 # 20 Adam steps, each leaf against its largest entry
ATOL = 2e-5                # rotation and projection


def synth(seed: int, n: int = 68, ki: int = 8, ke: int = 6):
    rng = np.random.default_rng(seed)
    arrays = dict(mean=rng.normal(0, 40, (n, 3)).astype(np.float32),
                  base_id=rng.normal(0, 3, (n * 3, ki)).astype(np.float32),
                  base_exp=rng.normal(0, 2, (n * 3, ke)).astype(np.float32))
    return jft.MorphableModel(**arrays), ft.MorphableModel(**arrays), rng


def observed(model, rng, f: int, focal: float, z: float, sigma: float = 0.15):
    """Landmarks of the model at seeded poses, through JAX's projection."""
    exp = rng.normal(0, 0.2, (f, model.base_exp.shape[1])).astype(np.float32)
    euler = rng.normal(0, sigma, (f, 3)).astype(np.float32)
    trans = np.tile([0.0, 0.0, z], (f, 1)).astype(np.float32)
    trans[:, :2] += rng.normal(0, 10, (f, 2))
    pts = model.mean[None] + (exp @ model.base_exp.T).reshape(f, -1, 3)
    rot = np.asarray(jft.euler_to_rot(jnp.asarray(euler)))
    cam = np.einsum("fij,fnj->fni", rot, pts) + trans[:, None]
    return np.asarray(jft.project(jnp.asarray(cam), focal, (256.0, 256.0)))


def assert_fit_close(got: dict, want: dict) -> None:
    for key in ("euler", "trans", "exp", "id", "focal", "pixel_rmse"):
        g, w = np.asarray(got[key], np.float64), np.asarray(want[key], np.float64)
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(g - w).max()) <= REL * scale, (key, np.abs(g - w).max(), scale)


def test_rotation_and_projection_match_jax():
    rng = np.random.default_rng(3)
    euler = rng.normal(0, 0.4, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(ft.euler_to_rot(torch.from_numpy(euler)).numpy(),
                               np.asarray(jft.euler_to_rot(jnp.asarray(euler))), atol=ATOL)
    pts = rng.normal(0, 30, (2, 7, 3)).astype(np.float32)
    pts[..., 2] -= 600.0
    pts[0, 0, 2] = 3.0                                   # behind the camera: clamped depth
    np.testing.assert_allclose(
        ft.project(torch.from_numpy(pts), 1150.0, (64.0, 48.0)).numpy(),
        np.asarray(jft.project(jnp.asarray(pts), 1150.0, (64.0, 48.0))), rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("freeze_focal", [False, True], ids=["free_focal", "frozen_focal"])
def test_twenty_adam_steps_match_jax(freeze_focal):
    jm, tm, rng = synth(0)
    lmk = observed(jm, rng, 4, 1200.0, -650.0)
    want = jft.fit_landmarks(jm, lmk, (512, 512), iters=20, freeze_focal=freeze_focal)
    got = ft.fit_landmarks(tm, lmk, (512, 512), iters=20, freeze_focal=freeze_focal,
                           device=CPU)
    assert_fit_close(got, want)
    if freeze_focal:        # the initial focal through log and exp in float32, as JAX's
        assert got["focal"] == want["focal"] == pytest.approx(1150.0, rel=1e-6)


def test_focal_sweep_picks_jaxs_focal():
    """The sweep's probes (the focal frozen) rank the candidates as JAX's
    do; the final free-focal fit starts from the same winner."""
    jm, tm, rng = synth(2)
    lmk = observed(jm, rng, 6, 700.0, -400.0, sigma=0.25)
    kw = dict(focals=(600, 700, 900, 1200), sweep_iters=30, sweep_frame_stride=2,
              iters=20, init_trans_z=-400.0)
    want = jft.fit_landmarks_focal_sweep(jm, lmk, (512, 512), **kw)
    got = ft.fit_landmarks_focal_sweep(tm, lmk, (512, 512), device=CPU, **kw)
    assert_fit_close(got, want)
    # 20 free steps move the focal by well under a candidate's spacing
    assert round(got["focal"] / 100) * 100 == round(want["focal"] / 100) * 100 == 700


def test_poses_from_fit_match_jax():
    rng = np.random.default_rng(5)
    fit = {"euler": rng.normal(0, 0.3, (4, 3)).astype(np.float32),
           "trans": rng.normal(0, 50, (4, 3)).astype(np.float32)}
    np.testing.assert_allclose(ft.poses_from_fit(fit), jft.poses_from_fit(fit), atol=ATOL)


def test_load_reads_the_reference_assets(tmp_path):
    """3DMM_info.npy as jft.MorphableModel.load reads it, the topology's
    "tris", and the port's keys_info.npy "keyinds" (the landmark vertices
    the reference's face model indexes)."""
    rng = np.random.default_rng(7)
    n = 12
    info = {"mu_shape": rng.normal(size=n * 3).astype(np.float32),
            "b_shape": rng.normal(size=(n * 3, 4)).astype(np.float32),
            "b_exp": rng.normal(size=(n * 3, 3)).astype(np.float32)}
    np.save(tmp_path / "3DMM_info.npy", info, allow_pickle=True)
    tris = rng.integers(0, n, (5, 3))
    np.save(tmp_path / "topology_info.npy", {"tris": tris}, allow_pickle=True)
    want = jft.MorphableModel.load(str(tmp_path))
    got = ft.MorphableModel.load(str(tmp_path))
    for key in ("mean", "base_id", "base_exp", "faces"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert got.keyinds is None
    np.save(tmp_path / "keys_info.npy", {"keyinds": np.array([3, 1, 4])}, allow_pickle=True)
    got = ft.MorphableModel.load(str(tmp_path))
    np.testing.assert_array_equal(got.keyinds, [3, 1, 4])
    sub = got.subset(got.keyinds)
    np.testing.assert_array_equal(sub.mean, got.mean[[3, 1, 4]])
    np.testing.assert_array_equal(sub.base_exp.reshape(3, 3, -1),
                                  got.base_exp.reshape(n, 3, -1)[[3, 1, 4]])
