"""K1's CUDA kernel (csrc/attention.cu) against its plain PyTorch version.

Needs an NVIDIA GPU (marker ``cuda``; skipped without one) and imports no
JAX, so it runs on a machine with the card and no JAX:

    python -m pytest -m cuda tests/test_torch_attention_cuda.py

float32 with TF32 off within 1e-5 (the 3xTF32 kernel's products are f32
accurate; only the summation order differs); bfloat16 within 1e-2 at
unit-normal inputs (output rounding at 2^-8 relative). Both kernels are
also held on a peaked softmax and with the largest score in the last key
tile; and the f32 limit must fail the plain version with single TF32
products (``allow_tf32``), so that it tells a three-term split from one.
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
@pytest.mark.parametrize("shape", [(16, 8, 1024, 40), (2, 8, 256, 80), (1, 2, 128, 128),
                                   (1, 2, 192, 40)])
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
@pytest.mark.parametrize("head_dim", [40, 80, 128])
@pytest.mark.parametrize("case", ["peaked", "max_in_last_tile"])
def test_bf16_kernel_on_hard_softmax(cuda_device, case, head_dim):
    """At the serving shape's B, H and L: q scaled ×4 (a peaked softmax whose
    running max moves across key tiles), or every query and the last key
    tile's keys shifted by 8 along one unit vector (each row's scores there
    gain ~64: every row's largest score sits in the last tile, and the
    running max jumps there). The absolute 1e-2 limit is
    held with v scaled by 1/4, which keeps |o| under 2, where one bf16 ulp
    (2^-7) is under the limit; at unit-normal v a peaked output reaches ~4.6,
    where one ulp is 0.031 and any bf16 rounding difference exceeds 1e-2, so
    there the error is held at 1e-2 of the output's largest magnitude (the
    limit's own reason: rounding at 2^-8 relative)."""
    shape = (16, 8, 1024, head_dim)
    q, k, v = hard_softmax_inputs(cuda_device, case, head_dim)
    q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    if case == "max_in_last_tile":
        scores = q.float() @ k.float().transpose(-1, -2)
        assert (scores.argmax(-1) >= shape[2] - attention.BLOCK).all()
    for v_scale in (0.25, 1.0):
        vv = (v * v_scale).to(torch.bfloat16)
        out = attention.self_attention(q, k, vv).float()
        ref = attention.self_attention_plain(q, k, vv).float()
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        print(f"{case} D={head_dim} v×{v_scale}: max abs err {err:.3e}, "
              f"relative to the largest |o| {rel:.3e}")
        if v_scale < 1:
            assert err <= 1e-2
        assert rel <= 1e-2


def hard_softmax_inputs(device, case: str, head_dim: int):
    """q, k, v [16, 8, 1024, head_dim] f32: q × 4 ("peaked"), or every query
    and the last key tile's keys shifted by 8 along one unit vector
    ("max_in_last_tile": every row's largest score sits in the last tile)."""
    gen = torch.Generator(device=device).manual_seed(1)
    shape = (16, 8, 1024, head_dim)
    q, k, v = (torch.randn(shape, generator=gen, device=device) for _ in range(3))
    if case == "peaked":
        q = q * 4
    else:
        u = torch.randn(head_dim, generator=gen, device=device)
        u = 8 * u / u.norm()
        q = q + u
        k[:, :, -attention.BLOCK:] += u
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [40, 80, 128])
@pytest.mark.parametrize("case", ["peaked", "max_in_last_tile"])
def test_f32_kernel_on_hard_softmax(cuda_device, case, head_dim):
    """The 3xTF32 kernel on the hard softmaxes of the bf16 test, f32 in and
    out: within 1e-5 at v × 1/4 (|o| < 2) and within 1e-5 of the output's
    largest magnitude at unit v (a peaked |o| reaches ~4.6)."""
    q, k, v = hard_softmax_inputs(cuda_device, case, head_dim)
    if case == "max_in_last_tile":
        scores = q @ k.transpose(-1, -2)
        assert (scores.argmax(-1) >= k.shape[2] - attention.BLOCK).all()
        del scores
    for v_scale in (0.25, 1.0):
        vv = v * v_scale
        out = attention.self_attention(q, k, vv)
        ref = attention.self_attention_plain(q, k, vv)
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        print(f"f32 {case} D={head_dim} v×{v_scale}: max abs err {err:.3e}, "
              f"relative to the largest |o| {rel:.3e}")
        if v_scale < 1:
            assert err <= 1e-5
        assert rel <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 8, 1024, 40), (1, 2, 192, 40)])
def test_f32_limit_fails_single_tf32_products(cuda_device, shape):
    """The kernel holds 1e-5; the plain version with TF32 matmuls (one TF32
    product per term) does not, on the same inputs."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device) for _ in range(3))
    ref = attention.self_attention_plain(q, k, v)
    out = attention.self_attention(q, k, v)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        single = attention.self_attention_plain(q, k, v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err, control = ((x - ref).abs().max().item() for x in (out, single))
    print(f"f32 {shape}: kernel {err:.3e}, single TF32 products {control:.3e}")
    assert err <= 1e-5 < control


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["head_dim_37", "misaligned"])
def test_f32_kernel_copies_rows_four_bytes_at_a_time(cuda_device, case):
    """Rows that are not 16-byte aligned (head_dim 37, or a tensor offset by
    one float) reach shared memory by 4-byte copies: same limit."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    if case == "head_dim_37":
        q, k, v = (torch.randn(1, 2, 128, 37, generator=gen, device=cuda_device)
                   for _ in range(3))
    else:
        q, k, v = (torch.randn(2 * 128 * 40 + 1, generator=gen, device=cuda_device)[1:]
                   .view(1, 2, 128, 40) for _ in range(3))
    out = attention.self_attention(q, k, v)
    assert (out - attention.self_attention_plain(q, k, v)).abs().max().item() <= 1e-5


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
    odd = torch.zeros(1, 1, 64, 36, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        attention.self_attention(odd, odd, odd)
    shifted = torch.zeros(64 * 40 + 1, device=cuda_device, dtype=torch.bfloat16)[1:]
    shifted = shifted.view(1, 1, 64, 40)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention.self_attention(shifted, shifted, shifted)
