"""K1's CUDA kernel (csrc/attention.cu) against its plain PyTorch version.

Needs an NVIDIA GPU (marker ``cuda``; skipped without one) and imports no
JAX, so it runs on a machine with the card and no JAX:

    python -m pytest -m cuda tests/test_torch_attention_cuda.py

float32 with TF32 off within 1e-5 (only the summation order differs);
bfloat16 within 1e-2 at unit-normal inputs (output rounding at 2^-8
relative).
"""
from __future__ import annotations

import pytest
import torch

from mere_fusion_tpu_torch.ops import attention


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(16, 8, 1024, 40), (2, 8, 256, 80), (1, 2, 128, 128)])
def test_kernel_matches_plain_on_gpu(cuda_device, dtype, tol, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for _ in range(3))
    before = attention.launches
    out = attention.self_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    ref = attention.self_attention_plain(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_rejects_ragged_and_unsupported_on_gpu(cuda_device):
    z = torch.zeros(1, 1, 300, 40, device=cuda_device)
    with pytest.raises(ValueError, match="not divisible"):
        attention.self_attention(z, z, z)
    h = torch.zeros(1, 1, 64, 40, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        attention.self_attention(h, h, h)
    w = torch.zeros(1, 1, 64, 160, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        attention.self_attention(w, w, w)
