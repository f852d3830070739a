"""K5's CUDA kernels (csrc/int8_conv.cu) against their plain PyTorch versions.

Needs an NVIDIA GPU (marker ``cuda``; skipped without one) and imports no
JAX, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_quant_cuda.py

Each kernel computes one step of the plain version in its order and
rounding, the integer sums are exact in both, and the epilogue rounds
acc·scale and + bias on their own in both: the limit is 0 for every step
(amax, factors, weight pack, quantize pass, conv) and for the whole int8
conv, in float32 and in bfloat16. The limit must catch one output
channel's scale moved by one ulp (float32 output) and one int8 weight moved
by one (bfloat16 output).
"""
from __future__ import annotations

import pytest
import torch

from mere_fusion_tpu_torch.ops import quant

# (n, cin, h, w, cout, k, stride). The conv's tile is 128 output channels ×
# 256 output pixels: a bn × bh × bw box of the output (rows of a power of two
# at most 256 wide, then whole images), loaded by TMA with zeros outside.
SHAPES = [
    (2, 4, 32, 32, 512, 3, 1),       # the decoder's conv_in: cin 4 (cp 16) in a 128-channel box
    (2, 512, 32, 32, 512, 3, 1),     # mid and up_0: 8 × 32 pixel tiles
    (2, 512, 64, 64, 512, 3, 1),     # up_0's upsample, up_1: 4 × 64
    (2, 512, 128, 128, 256, 3, 1),   # up_2's first conv: 2 × 128
    (2, 512, 128, 128, 256, 1, 1),   # up_2's 1×1 shortcut
    (2, 256, 128, 128, 128, 3, 1),
    (1, 128, 256, 256, 128, 3, 1),   # up_3: 1 × 256
    (1, 320, 17, 23, 320, 3, 2),     # a ragged downsample: cout 320 (a half tile), 9 × 12 out
    (1, 320, 17, 23, 320, 3, 1),     # the same rectangle at stride 1: pixels not a multiple of 8
    (1, 40, 9, 7, 72, 3, 1),         # cin no multiple of 16, boxes wider than the tensor
    (2, 320, 32, 32, 320, 3, 2),     # the UNet's first downsample
    (2, 960, 16, 16, 640, 3, 1),     # the UNet's cin 960: 7.5 chunks of 128
    (2, 640, 16, 16, 1280, 1, 1),    # a 1×1 shortcut to cout 1280
    (2, 2560, 8, 8, 1280, 3, 1),     # the UNet's largest K: 2,560·9, two images a tile
    (16, 1280, 4, 4, 1280, 3, 1),    # 4² images, 16 a tile
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
    if cin > 2:
        x[:, 2] = 0.0                         # a dead channel: s = 1 there
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
    got = quant.conv_q_cuda(x, *ops, bias, stride, k // 2, out_dtype)
    torch.cuda.synchronize()
    assert quant.launches == before + 1
    ref = quant.conv_q_plain(x, *ops, bias, stride, k // 2, out_dtype)
    assert got.shape == ref.shape and got.dtype == out_dtype
    assert got.is_contiguous()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_whole_int8_conv_matches_plain(cuda_device, shape, dtype):
    """int8_conv on the card (amax, factors, pack, quantize, conv: five
    kernels, one count) against int8_conv_plain run by PyTorch on the card."""
    n, cin, h, w, cout, k, stride = shape
    x, weight, bias = operands(cuda_device, n, cin, h, w, cout, k, dtype, seed=1)
    before = quant.launches
    got = quant.int8_conv(x, weight, bias, stride, k // 2)
    torch.cuda.synchronize()
    assert quant.launches == before + 1
    assert torch.equal(got, quant.int8_conv_plain(x, weight, bias, stride, k // 2))


# (n, cin, h, w, cout, k): one split and several, vector and scalar reads
OPERAND_SHAPES = [(2, 4, 32, 32, 512, 3), (16, 512, 64, 64, 512, 3), (2, 960, 16, 16, 640, 3),
                  (1, 320, 17, 23, 320, 3), (2, 2560, 8, 8, 1280, 3), (2, 512, 16, 16, 256, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", OPERAND_SHAPES)
def test_operand_kernels_match_plain(cuda_device, shape, dtype):
    n, cin, h, w, cout, k = shape
    x, weight, _ = operands(cuda_device, n, cin, h, w, cout, k, dtype, seed=2)
    ax, ak = quant.channel_amax(x, weight)
    for splits in (1, None):
        ax_part, ak_part = quant.channel_amax_cuda(x, weight, splits)
        assert torch.equal(ax_part.amax(dim=1), ax) and torch.equal(ak_part.amax(dim=1), ak)
    s, sx, mult = quant.smooth_factors(ax, ak)
    got = quant.smooth_factors_cuda(ax_part, ak_part)
    for name, a, b in zip(("s", "sx", "mult"), got, (s, sx, mult)):
        assert torch.equal(a, b), f"{name}: max abs err {(a - b).abs().max().item()}"
    kq, scale = quant.pack_weights(weight, s, sx)
    wq, scale_k = quant.pack_weights_cuda(weight, s, sx)
    cp = quant.padded_channels(cin)
    assert torch.equal(wq, quant.tap_major(kq, cp)) and torch.equal(scale_k, scale)
    xq = quant.quantize_activation_cuda(x, mult)
    ref = torch.nn.functional.pad(quant.quantize_activation_plain(x, mult).permute(0, 2, 3, 1),
                                  (0, cp - cin)).to(torch.int8)
    assert torch.equal(xq, ref)


@pytest.mark.cuda
def test_misaligned_input_reads_one_value_at_a_time(cuda_device):
    x, weight, bias = operands(cuda_device, 2, 64, 16, 16, 64, 3, torch.bfloat16)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
    shifted = flat[1:].view(x.shape)              # contiguous, 2 bytes off 16-byte alignment
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 and quant._vec(shifted) == 0
    assert torch.equal(quant.int8_conv(shifted, weight, bias, 1, 1),
                       quant.int8_conv_plain(x, weight, bias, 1, 1))


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
