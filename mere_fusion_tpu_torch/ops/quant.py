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

Every division is a true (IEEE) division on every device: torch on CUDA
divides by a Python scalar as a multiply by its reciprocal, so the plain
functions divide by a tensor.

The plain version, step by step (``int8_operands`` is their composition):
``channel_amax`` (ax, ak), ``smooth_factors`` (s, sx, the activation's
multiplier 1 / (s·sx)), ``pack_weights`` (the int8 values of s·K and the
dequantising sx·sw), ``quantize_activation_plain`` and ``conv_q_plain``
(the integer convolution exact as an f64 convolution of the int8 values:
|Σ| reaches 23,040·127² ≈ 3.7·10⁸, more than an f32 sum holds exactly).
It is the CPU path and the kernels' yardstick.

On CUDA tensors ``int8_conv`` runs the five hand-written kernels of
``csrc/int8_conv.cu`` (built with nvcc for sm_90a on first use, bound
through ctypes), each bit-equal to its plain step: the per-channel amax
(``channel_amax_cuda``), the factors (``smooth_factors_cuda``), the weights
packed into the conv's [cout, kh·kw, cp] int8 layout
(``pack_weights_cuda``), the quantize pass (bf16 or f32 NCHW in, int8 NHWC
out, channels padded to a multiple of 16: ``quantize_activation_cuda``) and
the implicit-GEMM conv on wgmma s8 fed by TMA with the dequantising
epilogue fused, written NCHW (``conv_packed_cuda``). ``conv_q_cuda`` runs
the last two on operands made elsewhere (``int8_operands``). They raise on
anything the kernels do not take; there is no fallback.

``launches`` counts K5's launches in this process, one an int8 conv.
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
AMAX_BLOCKS = 528    # blocks the amax pass aims for: four an SM of an H100's 132
PACK_SMEM = 227 * 1024   # a packed weight row (kh·kw·cp bytes) lives in one block's shared memory

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "int8_conv.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0
_count_lock = threading.Lock()
_lib = None
_lib_lock = threading.Lock()


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division on every device."""
    return t / torch.full((), 127.0, device=t.device)


def quantize_per_tensor(x: torch.Tensor):
    """→ (int8 tensor, f32 scale): symmetric dynamic per-tensor scale."""
    xf = x.float()
    scale = _div127(xf.abs().max().clamp_min(1e-8))
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def quantize_per_out_channel(weight: torch.Tensor):
    """[cout, cin, kh, kw] → (int8 weight, f32 scale [cout])."""
    wf = weight.float()
    scale = _div127(wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8))
    q = torch.clamp(torch.round(wf / scale[:, None, None, None]), -127, 127)
    return q.to(torch.int8), scale


def channel_amax(x: torch.Tensor, weight: torch.Tensor):
    """(ax, ak) [cin] float32: max |x| over (N, H, W) in x's own dtype (exact:
    abs and max do not round), as max(x) and −min(x), which reads x twice
    and writes no |x| copy; and max |K| over (cout, kh, kw)."""
    dims = (0, 2, 3)
    ax = torch.maximum(x.amax(dim=dims), -x.amin(dim=dims)).float()
    ak = weight.float().abs().amax(dim=(0, 2, 3))
    return ax, ak


def smooth_factors(ax: torch.Tensor, ak: torch.Tensor):
    """(s [cin], sx 0-dim, mult [cin] = 1 / (s·sx)) from the amax, float32."""
    ok = (ax > 0) & (ak > 0)
    s = torch.where(ok, ax.clamp_min(1e-8) ** ALPHA / ak.clamp_min(1e-8) ** (1 - ALPHA),
                    torch.ones_like(ax))
    sx = _div127(torch.where(ok, ax / s, ax).max()).clamp_min(1e-12)
    return s, sx, 1.0 / (s * sx)


def pack_weights(weight: torch.Tensor, s: torch.Tensor, sx: torch.Tensor):
    """(kq [cout, cin, kh, kw] int8, the values of s·K quantised per output
    channel; scale [cout] float32, the dequantising sx·sw)."""
    kq, sw = quantize_per_out_channel(weight.float() * s[None, :, None, None])
    return kq, sx * sw


def int8_operands(x: torch.Tensor, weight: torch.Tensor):
    """The per-call quantisation of ``int8_conv`` for x [N, cin, H, W] and
    weight [cout, cin, kh, kw]: (mult [cin], the activation's multiplier
    1 / (s·sx); kq [cout, cin, kh, kw], the int8 values of s·K; scale
    [cout], the dequantising sx·sw), on x's device, the two vectors float32."""
    s, sx, mult = smooth_factors(*channel_amax(x, weight))
    kq, scale = pack_weights(weight, s, sx)
    return mult, kq, scale


def padded_channels(c: int) -> int:
    return -(-c // CHANNEL_STEP) * CHANNEL_STEP


def tap_major(kq: torch.Tensor, cp: int) -> torch.Tensor:
    """[cout, cin, kh, kw] → the conv kernel's weight layout [cout, kh·kw,
    cp], input channels padded with zeros."""
    cout, cin, kh, kw = kq.shape
    return F.pad(kq.permute(0, 2, 3, 1), (0, cp - cin)).reshape(cout, kh * kw, cp).contiguous()


def _geometry(x: torch.Tensor, weight: torch.Tensor, stride: int, padding: int):
    n, c, h, w = x.shape
    cout, cin, kh, kw = weight.shape
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
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, args in (
                    ("mf_int8_amax", [i, i, p, i, p, p, p] + [i] * 7 + [p]),
                    ("mf_int8_factors", [i, p, p, i, i, f, f, p, p, p, p]),
                    ("mf_int8_pack", [i, i, p, p, p, p, p] + [i] * 4 + [p]),
                    ("mf_int8_quantize", [i, i, p, p, p] + [i] * 5 + [p]),
                    ("mf_int8_conv", [i, i, p, p, p, p, i, p] + [i] * 11 + [p])):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, ctypes.c_int
            _lib = lib
    return _lib


def _call(name: str, *args) -> None:
    err = getattr(_load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"K5's {name} failed to launch with cudaError {err}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_cuda(**tensors) -> torch.device:
    dev = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"K5 needs CUDA tensors; {name} is on {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError("K5 operands lie on different devices")
        dev = t.device
    return dev


def _check_float(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.dtype not in _DTYPES:
            raise TypeError(f"K5 takes float32 or bfloat16; {name} is {t.dtype}")


def _check_conv(x, weight, bias, out_dtype) -> None:
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"K5 takes x [N, C, H, W] and a weight [cout, cin, kh, kw]; got "
                         f"{tuple(x.shape)}, {tuple(weight.shape)}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"K5 gives float32 or bfloat16, not {out_dtype}")
    if bias is not None and bias.shape != (weight.shape[0],):
        raise ValueError("K5's bias does not match the weight")
    if x.numel() >= 2 ** 31 or weight.numel() >= 2 ** 31:
        raise ValueError(f"K5 takes fewer than 2^31 elements, x is {tuple(x.shape)}")


def _vec(x: torch.Tensor) -> int:
    """1 where the passes may read x 8 values at a time (16-byte aligned rows)."""
    return int(x.shape[2] * x.shape[3] % 8 == 0 and x.data_ptr() % 16 == 0)


def _amax_splits(c: int, pixels: int) -> int:
    return max(1, min(-(-AMAX_BLOCKS // c), pixels // 2048))


def channel_amax_cuda(x: torch.Tensor, weight: torch.Tensor, splits: int | None = None):
    """``channel_amax`` on the card as partial maxima: (ax_part, ak_part)
    [cin, splits] float32, whose max over the last dim is ``channel_amax``."""
    dev = _check_cuda(x=x, weight=weight)
    _check_float(x=x, weight=weight)
    x, weight = x.contiguous(), weight.contiguous()
    n, c, h, w = x.shape
    cout, cin, kh, kw = weight.shape
    if cin != c:
        raise ValueError(f"int8 conv: input has {c} channels, the weight {cin}")
    splits = splits or _amax_splits(c, n * h * w)
    part = torch.empty((2, c, splits), dtype=torch.float32, device=dev)
    _call("mf_int8_amax", dev.index, _DTYPES[x.dtype], x.data_ptr(), _DTYPES[weight.dtype],
          weight.data_ptr(), part[0].data_ptr(), part[1].data_ptr(), n, c, h * w, cout,
          kh * kw, splits, _vec(x), _stream(dev))
    return part[0], part[1]


def smooth_factors_cuda(ax_part: torch.Tensor, ak_part: torch.Tensor):
    """``smooth_factors`` on the card from partial maxima [cin, splits]:
    (s [cin], sx 0-dim, mult [cin]), float32."""
    dev = _check_cuda(ax_part=ax_part, ak_part=ak_part)
    if ax_part.dtype != torch.float32 or ax_part.shape != ak_part.shape or ax_part.dim() != 2:
        raise ValueError("K5's factors take two float32 [cin, splits] tensors")
    c, splits = ax_part.shape
    out = torch.empty((2 * c + 1,), dtype=torch.float32, device=dev)
    s, mult, sx = out[:c], out[c:2 * c], out[2 * c]
    _call("mf_int8_factors", dev.index, ax_part.contiguous().data_ptr(),
          ak_part.contiguous().data_ptr(), c, splits, ALPHA, 1 - ALPHA, s.data_ptr(),
          mult.data_ptr(), sx.data_ptr(), _stream(dev))
    return s, sx, mult


def pack_weights_cuda(weight: torch.Tensor, s: torch.Tensor, sx: torch.Tensor):
    """``pack_weights`` on the card, straight into the conv's layout:
    (wq [cout, kh·kw, cp] int8 = ``tap_major(kq, cp)``, scale [cout])."""
    dev = _check_cuda(weight=weight, s=s, sx=sx)
    _check_float(weight=weight)
    weight = weight.contiguous()
    cout, c, kh, kw = weight.shape
    cp = padded_channels(c)
    if s.shape != (c,) or s.dtype != torch.float32 or sx.numel() != 1:
        raise ValueError("K5's weight pack takes s [cin] and sx, float32")
    if kh * kw * cp > PACK_SMEM:
        raise ValueError(f"K5 packs at most {PACK_SMEM} bytes a weight row, not {kh * kw * cp}")
    wq = torch.empty((cout, kh * kw, cp), dtype=torch.int8, device=dev)
    scale = torch.empty((cout,), dtype=torch.float32, device=dev)
    _call("mf_int8_pack", dev.index, _DTYPES[weight.dtype], weight.data_ptr(),
          s.contiguous().data_ptr(), sx.data_ptr(), wq.data_ptr(), scale.data_ptr(), cout, c,
          kh * kw, cp, _stream(dev))
    return wq, scale


def quantize_activation_cuda(x: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """The quantize pass: x [N, C, H, W] → int8 NHWC [N, H, W, cp], channels
    past C zero (``quantize_activation_plain`` in the conv's layout)."""
    dev = _check_cuda(x=x, mult=mult)
    _check_float(x=x)
    x = x.contiguous()
    n, c, h, w = x.shape
    if mult.shape != (c,) or mult.dtype != torch.float32:
        raise ValueError("K5's quantize pass takes mult [C] float32")
    cp = padded_channels(c)
    xq = torch.empty((n, h, w, cp), dtype=torch.int8, device=dev)
    _call("mf_int8_quantize", dev.index, _DTYPES[x.dtype], x.data_ptr(),
          mult.contiguous().data_ptr(), xq.data_ptr(), n, c, h * w, cp, _vec(x), _stream(dev))
    return xq


def conv_packed_cuda(xq: torch.Tensor, wq: torch.Tensor, kernel_size: tuple[int, int],
                     scale: torch.Tensor, bias: torch.Tensor | None, stride: int, padding: int,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """The conv kernel alone on packed operands: xq [N, H, W, cp] and wq
    [cout, kh·kw, cp] int8 → [N, cout, Ho, Wo] of out_dtype, acc·scale + bias."""
    dev = _check_cuda(xq=xq, wq=wq, scale=scale, bias=bias)
    _check_float(bias=bias)
    n, h, w, cp = xq.shape
    cout = wq.shape[0]
    kh, kw = kernel_size
    if (xq.dtype != torch.int8 or wq.dtype != torch.int8 or wq.shape != (cout, kh * kw, cp)
            or cp % CHANNEL_STEP or not (xq.is_contiguous() and wq.is_contiguous())):
        raise ValueError(f"K5's conv takes contiguous int8 xq [N, H, W, cp] and wq [cout, "
                         f"kh·kw, cp], cp a multiple of {CHANNEL_STEP}; got {tuple(xq.shape)}, "
                         f"{tuple(wq.shape)}")
    if scale.shape != (cout,) or scale.dtype != torch.float32 or (
            bias is not None and bias.shape != (cout,)):
        raise ValueError("K5's per-channel vectors do not match the weight")
    if not 1 <= stride <= 8:
        raise ValueError(f"K5 takes strides 1 to 8, not {stride}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"K5 gives float32 or bfloat16, not {out_dtype}")
    ho, wo = (h + 2 * padding - kh) // stride + 1, (w + 2 * padding - kw) // stride + 1
    if ho <= 0 or wo <= 0 or n * ho * wo >= 2 ** 31:
        raise ValueError(f"K5: no output of {ho}×{wo} at batch {n}")
    out = torch.empty((n, cout, ho, wo), dtype=out_dtype, device=dev)
    bias = bias.contiguous() if bias is not None else None
    _call("mf_int8_conv", dev.index, _DTYPES[out_dtype], xq.data_ptr(), wq.data_ptr(),
          scale.contiguous().data_ptr(), bias.data_ptr() if bias is not None else None,
          _DTYPES[bias.dtype] if bias is not None else 0, out.data_ptr(), n, h, w, cp, cout,
          kh, kw, stride, padding, ho, wo, _stream(dev))
    return out


def _count() -> None:
    global launches
    with _count_lock:
        launches += 1


def conv_q_cuda(x, mult, kq, scale, bias, stride: int = 1, padding: int = 0,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K5's quantize pass and conv on shared operands (``int8_operands``;
    the weights' int8 values repacked tap-major in PyTorch) on x's device
    and PyTorch's current stream there. Returns a contiguous [N, cout, Ho,
    Wo] tensor."""
    out_dtype = out_dtype or x.dtype
    _check_cuda(x=x, mult=mult, kq=kq, scale=scale, bias=bias)
    _check_conv(x, kq, bias, out_dtype)
    if kq.dtype != torch.int8:
        raise TypeError(f"K5 takes the weights' int8 values, got {kq.dtype}")
    _, c, _, _, _, kh, kw, _, _ = _geometry(x, kq, stride, padding)
    if mult.shape != (c,) or scale.shape != (kq.shape[0],):
        raise ValueError("K5's per-channel vectors do not match the weight")
    xq = quantize_activation_cuda(x, mult.float())
    out = conv_packed_cuda(xq, tap_major(kq, xq.shape[3]), (kh, kw), scale.float(), bias,
                           stride, padding, out_dtype)
    _count()
    return out


def int8_conv_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                   stride: int = 1, padding: int = 0,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The whole int8 conv on the card in five kernel launches: the amax,
    the factors, the weight pack, the quantize pass and the conv."""
    out_dtype = out_dtype or x.dtype
    _check_cuda(x=x, weight=weight, bias=bias)
    _check_float(x=x, weight=weight, bias=bias)
    _check_conv(x, weight, bias, out_dtype)
    _, _, _, _, _, kh, kw, _, _ = _geometry(x, weight, stride, padding)
    s, sx, mult = smooth_factors_cuda(*channel_amax_cuda(x, weight))
    wq, scale = pack_weights_cuda(weight, s, sx)
    out = conv_packed_cuda(quantize_activation_cuda(x, mult), wq, (kh, kw), scale, bias,
                           stride, padding, out_dtype)
    _count()
    return out


def int8_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
              stride: int = 1, padding: int = 0,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """conv2d(x, weight) + bias computed in int8 with int32 accumulation
    (NCHW, the JAX ``int8_conv``'s arithmetic): the plain version for CPU
    tensors, K5 for CUDA tensors."""
    fn = int8_conv_plain if x.device.type == "cpu" else int8_conv_cuda
    return fn(x, weight, bias, stride, padding, out_dtype)


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
