"""K5: dynamic int8 convolution for MuseTalk's int8 serving tier.

Port of mere_fusion_tpu/ops/quant.py (``quantize_per_tensor``,
``quantize_per_out_channel``, ``int8_conv``, ``QConv``). The arithmetic is
the JAX package's:

- a per-input-channel SmoothQuant equalisation computed per call from the
  live amax (α = 0.7): s = ax^0.7 / ak^0.3 with both amax floored at 1e-8,
  s = 1 where either is 0; ax is reduced in the input's own dtype;
- a per-tensor activation scale sx = max(ax / s) / 127, floored at 1e-12;
- per-output-channel weight scales sw of s·K;
- round half to even, clip to ±127, an int8 × int8 → int32 convolution, and
  acc·(sx·sw) + bias in float32, cast to the output dtype.

The small per-channel vectors (``int8_operands``: the activation's
multiplier 1 / (s·sx), the weights' int8 values, sx·sw) are plain PyTorch
and shared by both routes, so that the kernel and its plain version agree
bit for bit:

- ``conv_q_plain``: the CPU path and the kernel's yardstick. The integer
  convolution is exact as an f64 convolution of the int8 values (|Σ| reaches
  4,608·127² ≈ 7.4·10⁷, more than an f32 sum holds exactly).
- ``conv_q_cuda``: the hand-written kernels of ``csrc/int8_conv.cu``, built
  with nvcc for sm_90a on first use and bound through ctypes: a quantize
  pass (bf16 or f32 NCHW in, int8 NHWC out, channels padded to a multiple
  of 16) and an implicit-GEMM convolution on the int8 tensor cores
  (mma.sync m16n8k32 s8) with the dequantising epilogue fused, written
  NCHW as nn.Conv2d writes it. It raises on anything the kernels do
  not take; there is no fallback.

``launches`` counts K5's launches in this process, one an int8 conv (its
quantize pass and its convolution).
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch
import torch.nn.functional as F
from torch import nn

ALPHA = 0.7          # the SmoothQuant exponent of the JAX package
CHANNEL_STEP = 16    # the quantized activation's channels are padded to a multiple of this

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "int8_conv.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0
_count_lock = threading.Lock()
_lib = None
_lib_lock = threading.Lock()


def quantize_per_tensor(x: torch.Tensor):
    """→ (int8 tensor, f32 scale): symmetric dynamic per-tensor scale."""
    xf = x.float()
    scale = xf.abs().max().clamp_min(1e-8) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def quantize_per_out_channel(weight: torch.Tensor):
    """[cout, cin, kh, kw] → (int8 weight, f32 scale [cout])."""
    wf = weight.float()
    scale = wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale[:, None, None, None]), -127, 127)
    return q.to(torch.int8), scale


def int8_operands(x: torch.Tensor, weight: torch.Tensor):
    """The per-call quantisation of ``int8_conv`` for x [N, cin, H, W] and
    weight [cout, cin, kh, kw]: (mult [cin], the activation's multiplier
    1 / (s·sx); kq [cout, cin, kh, kw], the int8 values of s·K; scale
    [cout], the dequantising sx·sw), on x's device, the two vectors float32."""
    # amax in x's own dtype (exact: abs and max do not round), as max(x) and
    # −min(x), which reads x twice and writes no |x| copy
    dims = (0, 2, 3)
    ax = torch.maximum(x.amax(dim=dims), -x.amin(dim=dims)).float()
    kf = weight.float()
    ak = kf.abs().amax(dim=(0, 2, 3))
    ok = (ax > 0) & (ak > 0)
    s = torch.where(ok, ax.clamp_min(1e-8) ** ALPHA / ak.clamp_min(1e-8) ** (1 - ALPHA),
                    torch.ones_like(ax))
    sx = (torch.where(ok, ax / s, ax).max() / 127.0).clamp_min(1e-12)
    mult = 1.0 / (s * sx)
    kq, sw = quantize_per_out_channel(kf * s[None, :, None, None])
    return mult, kq, sx * sw


def _geometry(x: torch.Tensor, kq: torch.Tensor, stride: int, padding: int):
    n, c, h, w = x.shape
    cout, cin, kh, kw = kq.shape
    if cin != c:
        raise ValueError(f"int8 conv: input has {c} channels, the weight {cin}")
    ho, wo = (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"int8 conv: empty output for input {tuple(x.shape)}")
    return n, c, h, w, cout, kh, kw, ho, wo


def quantize_activation_plain(x: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """round(x·mult[c]) clipped to ±127, as float32 [N, C, H, W]."""
    return torch.clamp(torch.round(x.float() * mult[None, :, None, None]), -127, 127)


def conv_q_plain(x, mult, kq, scale, bias, stride: int = 1, padding: int = 0,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The int8 convolution on shared operands (``int8_operands``), in plain
    PyTorch: the integer sums exact as an f64 convolution, then acc·scale
    and + bias as two f32 operations, cast to ``out_dtype`` (x's dtype when
    None)."""
    _geometry(x, kq, stride, padding)
    xq = quantize_activation_plain(x, mult)
    acc = F.conv2d(xq.double(), kq.double(), None, stride, padding)
    y = acc.float() * scale[None, :, None, None]
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    return y.to(out_dtype or x.dtype)


def build() -> str:
    """Build (or find in the cache) the kernel library; returns its path."""
    from mere_fusion_tpu_torch.ops.attention import nvcc_path
    from mere_fusion_tpu_torch.runtime.build import build_shared

    return build_shared(
        "mf_int8_conv", [_SRC],
        [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"])


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.mf_int8_quantize.argtypes = (
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
            lib.mf_int8_quantize.restype = ctypes.c_int
            lib.mf_int8_conv.argtypes = (
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                + [ctypes.c_void_p])
            lib.mf_int8_conv.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(x, mult, kq, scale, bias, out_dtype) -> None:
    for name, t in (("x", x), ("mult", mult), ("kq", kq), ("scale", scale),
                    *((("bias", bias),) if bias is not None else ())):
        if t.device.type != "cuda":
            raise ValueError(f"K5 needs CUDA tensors; {name} is on {t.device}")
        if t.device != x.device:
            raise ValueError("K5 operands lie on different devices")
    if x.dim() != 4 or kq.dim() != 4:
        raise ValueError(f"K5 takes x [N, C, H, W] and a weight [cout, cin, kh, kw]; got "
                         f"{tuple(x.shape)}, {tuple(kq.shape)}")
    if kq.dtype != torch.int8:
        raise TypeError(f"K5 takes the weights' int8 values, got {kq.dtype}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"K5 takes and gives float32 or bfloat16; x is {x.dtype}, the output "
                        f"{out_dtype}")
    cout, cin = kq.shape[:2]
    if mult.shape != (cin,) or scale.shape != (cout,) or (
            bias is not None and bias.shape != (cout,)):
        raise ValueError("K5's per-channel vectors do not match the weight")
    if x.numel() >= 2 ** 31 or x.shape[0] * x.shape[2] * x.shape[3] >= 2 ** 31:
        raise ValueError(f"K5 takes fewer than 2^31 elements, x is {tuple(x.shape)}")


def conv_q_cuda(x, mult, kq, scale, bias, stride: int = 1, padding: int = 0,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch K5 (the quantize pass, then the int8 implicit-GEMM conv) on
    x's device and PyTorch's current stream there. Returns a contiguous
    [N, cout, Ho, Wo] tensor."""
    global launches
    out_dtype = out_dtype or x.dtype
    _check(x, mult, kq, scale, bias, out_dtype)
    n, c, h, w, cout, kh, kw, ho, wo = _geometry(x, kq, stride, padding)
    x = x.contiguous()
    cp = -(-c // CHANNEL_STEP) * CHANNEL_STEP
    dev = x.device
    mult = mult.float().contiguous()
    scale = scale.float().contiguous()
    bias = bias.float().contiguous() if bias is not None else None
    # the weights' int8 values tap-major, channels padded with zeros: [cout, kh, kw, cp]
    wq = F.pad(kq.permute(0, 2, 3, 1), (0, cp - c)).contiguous()
    xq = torch.empty((n, h, w, cp), dtype=torch.int8, device=dev)
    out = torch.empty((n, cout, ho, wo), dtype=out_dtype, device=dev)
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.mf_int8_quantize(dev.index, _DTYPES[x.dtype], x.data_ptr(),
                               mult.data_ptr(), xq.data_ptr(), n, c, h * w, cp, stream)
    if err != 0:
        raise RuntimeError(f"K5's quantize pass failed to launch with cudaError {err}")
    err = lib.mf_int8_conv(dev.index, _DTYPES[out_dtype], xq.data_ptr(), wq.data_ptr(),
                           scale.data_ptr(), bias.data_ptr() if bias is not None else None,
                           out.data_ptr(), n, h, w, cp, cout, kh, kw, stride, padding, ho, wo,
                           stream)
    if err != 0:
        raise RuntimeError(f"K5's conv failed to launch with cudaError {err}")
    with _count_lock:
        launches += 1
    return out


def conv_q(x, mult, kq, scale, bias, stride: int = 1, padding: int = 0,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The int8 conv on shared operands: the plain version for CPU tensors,
    K5 for CUDA tensors."""
    fn = conv_q_plain if x.device.type == "cpu" else conv_q_cuda
    return fn(x, mult, kq, scale, bias, stride, padding, out_dtype)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
              stride: int = 1, padding: int = 0,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """conv2d(x, weight) + bias computed in int8 with int32 accumulation
    (NCHW, the JAX ``int8_conv``'s arithmetic): the plain version for CPU
    tensors, K5 for CUDA tensors."""
    return conv_q(x, *int8_operands(x, weight), bias, stride, padding, out_dtype)


def int8_conv_plain(x, weight, bias, stride: int = 1, padding: int = 0,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    return conv_q_plain(x, *int8_operands(x, weight), bias, stride, padding, out_dtype)


class QConv(nn.Conv2d):
    """``nn.Conv2d`` with an int8 route: the same parameters under the same
    names and shapes, so every diffusers-named state dict loads into either
    route; ``quant`` only switches the arithmetic (False: exactly
    ``nn.Conv2d``). The int8 route takes square stride and symmetric zero
    padding, no dilation and no groups, and gives the weight's dtype."""

    def __init__(self, *args, quant: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quant:
            return super().forward(x)
        if (self.groups != 1 or self.dilation != (1, 1) or self.padding_mode != "zeros"
                or self.stride[0] != self.stride[1] or isinstance(self.padding, str)
                or self.padding[0] != self.padding[1]):
            raise ValueError(f"the int8 route does not take {self}")
        return int8_conv(x, self.weight, self.bias, self.stride[0], self.padding[0],
                         out_dtype=self.weight.dtype)
