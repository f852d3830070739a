"""K5's CUDA kernels (csrc/int8_conv.cu) against their plain PyTorch version.

Needs an NVIDIA GPU (marker ``cuda``; skipped without one) and imports no
JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_quant_cuda.py

The kernel and the plain version share the per-channel operands
(``quant.int8_operands``), the integer sums are exact in both, and the
epilogue rounds acc·scale and + bias on their own in both: the limit is 0,
in float32 and in bfloat16 output. The limit must catch one output
channel's scale moved by one ulp (float32 output) and one int8 weight moved
by one (bfloat16 output).
"""
from __future__ import annotations

import pytest
import torch

from mere_fusion_tpu_torch.ops import quant

# the VAE decode's int8 conv shapes at batch 2 (the serving batch is 16:
# chip_smoke's int8 phase), and the UNet's odd ones: (n, cin, h, w, cout, k, stride)
SHAPES = [
    (2, 4, 32, 32, 512, 3, 1),       # the decoder's conv_in: cin 4, K padded in the gather
    (2, 512, 32, 32, 512, 3, 1),     # mid and up_0
    (2, 512, 64, 64, 512, 3, 1),     # up_0's upsample, up_1
    (2, 512, 128, 128, 256, 3, 1),   # up_2's first conv
    (2, 512, 128, 128, 256, 1, 1),   # up_2's 1×1 shortcut
    (2, 256, 128, 128, 128, 3, 1),
    (1, 320, 17, 23, 320, 3, 2),     # a UNet downsample, cout no multiple of 128, ragged M
    (1, 40, 9, 7, 72, 3, 1),         # cin no multiple of 16
]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def operands(dev, n, cin, h, w, cout, k, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, cin, h, w), generator=gen, device=dev).to(dtype)
    x[:, 0] *= 20.0                           # an outlier channel, which s moves into the weights
    weight = (torch.randn((cout, cin, k, k), generator=gen, device=dev)
              / (cin * k * k) ** 0.5).to(dtype)
    bias = torch.randn((cout,), generator=gen, device=dev).to(dtype)
    return x, weight, bias


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_on_gpu(cuda_device, shape, out_dtype):
    n, cin, h, w, cout, k, stride = shape
    x, weight, bias = operands(cuda_device, n, cin, h, w, cout, k, out_dtype)
    ops = quant.int8_operands(x, weight)
    before = quant.launches
    got = quant.conv_q(x, *ops, bias, stride, k // 2, out_dtype)
    torch.cuda.synchronize()
    assert quant.launches == before + 1
    ref = quant.conv_q_plain(x, *ops, bias, stride, k // 2, out_dtype)
    assert got.shape == ref.shape and got.dtype == out_dtype
    assert got.is_contiguous()
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_channels_last_input(cuda_device):
    x, weight, bias = operands(cuda_device, 2, 64, 24, 24, 64, 3, torch.bfloat16)
    ops = quant.int8_operands(x, weight)
    got = quant.conv_q_cuda(x.contiguous(memory_format=torch.channels_last), *ops, bias, 1, 1)
    assert torch.equal(got, quant.conv_q_plain(x, *ops, bias, 1, 1))


@pytest.mark.cuda
def test_the_limit_catches_its_controls(cuda_device):
    x, weight, bias = operands(cuda_device, 2, 512, 32, 32, 512, 3, torch.float32)
    mult, kq, scale = quant.int8_operands(x, weight)
    ref = quant.conv_q_plain(x, mult, kq, scale, bias, 1, 1)
    nudged = scale.clone()
    nudged[7] = torch.nextafter(nudged[7], torch.tensor(float("inf"), device=cuda_device))
    assert not torch.equal(quant.conv_q_cuda(x, mult, kq, nudged, bias, 1, 1), ref)
    xb, wb, bb = (t.to(torch.bfloat16) for t in (x, weight, bias))
    mult, kq, scale = quant.int8_operands(xb, wb)
    refb = quant.conv_q_plain(xb, mult, kq, scale, bb, 1, 1)
    moved = kq.clone()
    moved[3, 5, 1, 1] += 1 if moved[3, 5, 1, 1] < 127 else -1
    assert not torch.equal(quant.conv_q_cuda(xb, mult, moved, scale, bb, 1, 1), refb)


@pytest.mark.cuda
def test_qconv_launches_the_kernel(cuda_device):
    conv = quant.QConv(64, 32, 3, padding=1, quant=True).to(cuda_device, torch.bfloat16)
    x = torch.randn((2, 64, 16, 16), device=cuda_device, dtype=torch.bfloat16)
    before = quant.launches
    y = conv(x)
    assert quant.launches == before + 1
    assert torch.equal(y, quant.int8_conv_plain(x, conv.weight, conv.bias, 1, 1))
