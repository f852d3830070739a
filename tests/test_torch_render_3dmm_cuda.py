"""The 3DMM tracker and the rasterizer on the card against the CPU.

Needs an NVIDIA GPU (marker ``cuda``; skipped without one) and imports no
JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_render_3dmm_cuda.py

``fit_landmarks``' first 20 Adam steps within 1e-4 of each leaf's largest
entry (the sums of its einsums run in other orders on the card);
``rasterize_topk``'s face ids equal (each operation rounds as on the CPU:
no fused multiply-add between PyTorch's elementwise kernels), on one frame
and a batch, over a grid surface seen head-on and turned.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mere_fusion_tpu_torch.tools import face_tracking as ft
from mere_fusion_tpu_torch.tools import render_3dmm as r3

REL = 1e-4


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card's run of the tracker and rasterizer)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def grid_surface(n: int = 40):
    """A bumpy grid surface of n² vertices (±80 units) and its triangles."""
    g = np.linspace(-1, 1, n)
    xx, yy = np.meshgrid(g, g)
    zz = 0.35 * (1 - 0.5 * (xx ** 2 + yy ** 2)) + 0.2 * np.exp(-(xx ** 2 + yy ** 2) / 0.05)
    mean = (np.stack([xx, yy, zz], -1).reshape(-1, 3) * 80).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    faces = np.concatenate([np.stack([idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:]], -1),
                            np.stack([idx[1:, :-1], idx[1:, 1:], idx[:-1, 1:]], -1)])
    return mean, faces.reshape(-1, 3).astype(np.int64)


@pytest.mark.cuda
def test_fit_landmarks_steps_match_the_cpu(cuda_device):
    rng = np.random.default_rng(0)
    n, f = 68, 6
    model = ft.MorphableModel(mean=rng.normal(0, 40, (n, 3)).astype(np.float32),
                              base_id=rng.normal(0, 3, (n * 3, 10)).astype(np.float32),
                              base_exp=rng.normal(0, 2, (n * 3, 8)).astype(np.float32))
    euler = torch.from_numpy(rng.normal(0, 0.15, (f, 3)).astype(np.float32))
    cam = torch.einsum("fij,nj->fni", ft.euler_to_rot(euler), torch.from_numpy(model.mean))
    cam = cam + torch.tensor([0.0, 0.0, -600.0])
    lmk = ft.project(cam, 1200.0, (256.0, 256.0)).numpy()
    for freeze in (False, True):
        card = ft.fit_landmarks(model, lmk, (512, 512), iters=20, freeze_focal=freeze,
                                device=cuda_device)
        cpu = ft.fit_landmarks(model, lmk, (512, 512), iters=20, freeze_focal=freeze,
                               device=torch.device("cpu"))
        for key in ("euler", "trans", "exp", "id", "focal", "pixel_rmse"):
            got, want = np.asarray(card[key]), np.asarray(cpu[key])
            scale = max(float(np.abs(want).max()), 1e-6)
            assert float(np.abs(got - want).max()) <= REL * scale, (freeze, key)


@pytest.mark.cuda
@pytest.mark.parametrize("yaw", [0.0, 0.3])
def test_rasterize_topk_ids_match_the_cpu(cuda_device, yaw):
    mean, faces = grid_surface()
    rot = ft.euler_to_rot(torch.tensor([[0.05, yaw, 0.02]]))[0]
    pts = torch.from_numpy(mean) @ rot.T + torch.tensor([0.0, 0.0, -600.0])
    uv = ft.project(pts, 600.0, (64.0, 64.0))
    z = -pts[:, 2]
    zn = (z.max() - z) / (z.max() - z.min() + 1e-6)
    want = r3.rasterize_topk(uv, zn, torch.from_numpy(faces), (128, 128), d_max=1.2)
    got = r3.rasterize_topk(uv.to(cuda_device), zn.to(cuda_device),
                            torch.from_numpy(faces).to(cuda_device), (128, 128), d_max=1.2)
    assert int((want >= 0).sum()) > 5_000
    assert torch.equal(got.cpu(), want)
    batch = r3.rasterize_topk(torch.stack([uv, uv]).to(cuda_device),
                              torch.stack([zn, zn]).to(cuda_device),
                              torch.from_numpy(faces).to(cuda_device), (128, 128), d_max=1.2)
    assert torch.equal(batch[1].cpu(), want)
