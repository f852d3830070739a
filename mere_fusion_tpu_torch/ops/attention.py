"""K1: fused self-attention for the MuseTalk UNet's long self-attentions.

Port of the Pallas TPU kernel mere_fusion_tpu/ops/attention.py
(``self_attention_fused``). Three functions:

- ``self_attention_plain``: the einsum path of the UNet in PyTorch — f32
  scores, f32 softmax, probabilities cast to ``v``'s dtype before ``p·v``.
  The CPU path and the yardstick the kernel is held against.
- ``self_attention_cuda``: launches the hand-written CUDA C++ kernel
  (``csrc/attention.cu``, built with nvcc for sm_90a on first use and bound
  through ctypes): in bfloat16 the tensor-core kernel (wgmma tiles fed by a
  TMA K/V ring, P rounded to bf16 unnormalised and divided by the f32 row
  sum once at the end), in float32 the 3xTF32 kernel (mma.sync tiles fed by
  a cp.async K/V ring, each f32 operand split into two TF32 terms and each
  product taken as three TF32 products, f32 accurate). It raises on
  anything the kernel does not take.
- ``self_attention``: the wrapper the model calls. A CPU tensor goes to the
  plain version; a CUDA tensor goes to the kernel, which launches or raises.

``launches`` counts the kernel's successful launches in this process.
"""
from __future__ import annotations

import ctypes
import math
import os
import shutil
import threading

import torch

BLOCK = 64            # query and key rows per tile of the kernel
MAX_HEAD_DIM = 128
BF16_HEAD_DIM_STEP = 8   # bf16 rows are read by TMA: 16-byte strides

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "attention.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's name in profiler rows, by dtype
KERNEL_NAMES = {torch.float32: "attention_3xtf32_kernel",
                torch.bfloat16: "attention_wgmma_kernel"}

launches = 0
_count_lock = threading.Lock()
_lib = None
_lib_lock = threading.Lock()


def self_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √d) v for [B, H, L, D] (any Lk), scores and softmax in
    float32, probabilities cast to v.dtype before the product with v."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the K1 kernel "
                           "is built from csrc/attention.cu on first use")
    return path


def build() -> str:
    """Build (or find in the cache) the kernel library; returns its path."""
    from mere_fusion_tpu_torch.runtime.build import build_shared

    return build_shared(
        "mf_attention", [_SRC],
        [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"])


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.mf_self_attention.argtypes = (
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_void_p])
            lib.mf_self_attention.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"K1 takes [B, H, L, D]; {name} has shape {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"K1 takes float32 or bfloat16, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"K1 needs contiguous input; {name} is not")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"K1 dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    b, h, lq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"K1 shapes disagree: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"K1 handles head_dim <= {MAX_HEAD_DIM}, got {d}")
    for name, n in (("q", lq), ("k", k.shape[2])):
        if n % BLOCK:
            raise ValueError(f"seq {n} of {name} not divisible by block {BLOCK}")
    if q.dtype == torch.bfloat16:
        if d % BF16_HEAD_DIM_STEP:
            raise ValueError(f"K1 in bfloat16 takes a head_dim that is a multiple of "
                             f"{BF16_HEAD_DIM_STEP}, got {d}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"K1 in bfloat16 needs 16-byte aligned input; {name} is not")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"K1 needs CUDA tensors; {name} is on {t.device}")
    if q.device != k.device or q.device != v.device:
        raise ValueError("K1 inputs lie on different devices")


def self_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch K1 on q, k, v's device and PyTorch's current stream there."""
    global launches
    _check(q, k, v)
    b, h, lq, d = q.shape
    out = torch.empty_like(q)
    lib = _load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mf_self_attention(
        q.device.index, _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), b * h, lq, k.shape[2], d, 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed with cudaError {err}")
    with _count_lock:
        launches += 1
    return out


def wgmma_instance(head_dim: int) -> str:
    """The bf16 kernel's instantiation for head_dim as it appears in its
    mangled name: attention_wgmma_kernel<ceil(d/16) k16 steps, the N of
    P·V> (48 at d = 40, where V carries the row sum as column 40, else 64)."""
    nks = -(-head_dim // 16)
    return f"attention_wgmma_kernelILi{nks}ELi{48 if head_dim == 40 else 64}E"


def tf32_instance(head_dim: int) -> str:
    """The f32 kernel's instantiation for head_dim as it appears in its
    mangled name: attention_3xtf32_kernel<ceil(d/8) k8 steps>."""
    return f"attention_3xtf32_kernelILi{-(-head_dim // 8)}E"


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused softmax(q kᵀ / √d) v for [B, H, L, D]: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return self_attention_plain(q, k, v)
    return self_attention_cuda(q, k, v)
