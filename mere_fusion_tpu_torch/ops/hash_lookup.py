"""K3: multi-level hash-table lookup with its table gradient.

Port of the Pallas TPU kernel mere_fusion_tpu/ops/hash_mxu.py (``lookup``,
forward ``_fwd_kernel``, backward ``_bwd_kernel``, and
``triplane_encode_mxu``, the ER-NeRF ``encode_x`` of every training-step
network call). For sample n, grid q and level l of G one-channel grids:

    out[n, q·L + l] = Σ_{k<4} w[q, n, l, k] · table_q[off_l + idx[q, n, l, k]]

with the int32 corner rows and f32 weights of
``ops/hashgrid.corner_indices_weights`` (plain torch, as the JAX package
computes them outside Pallas too), stacked over the grids as [G, N, L, 4].
The TPU kernel pads every level to lane rows and selects with one-hot
matmuls because the TPU has no fast gather; Hopper has one, so the CUDA
kernels (``csrc/hash_lookup.cu``) gather from the network's own flat tables
and scatter-add the gradient straight into their layout.

- ``lookup_plain``: ``hashgrid.corner_sum`` over each grid, in PyTorch
  (every product and sum rounded on its own, as the kernel does). The CPU
  path and the yardstick; autograd gives its gradients.
- ``Lookup``: a ``torch.autograd.Function`` whose forward and backward
  launch the CUDA kernels; the weights' gradient, needed only when the
  sample positions depend on a parameter, is a plain gather (as in the JAX
  package). Its wrappers raise on anything the kernels do not take.
- ``lookup``: CPU tensors take the plain version, CUDA tensors the kernels.
- ``triplane_encode``: ``encode_x`` with all three planes in one launch.

``fwd_launches`` and ``bwd_launches`` count the kernels' launches in this
process.
"""
from __future__ import annotations

import ctypes
import functools
import os
import threading

import torch

from mere_fusion_tpu_torch.ops.hashgrid import (
    GridSpec,
    corner_indices_weights,
    corner_sum,
    level_offsets,
)

CORNERS = 4
MAX_GRIDS = 3
MAX_LEVELS = 32

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "hash_lookup.cu")

fwd_launches = 0
bwd_launches = 0
_count_lock = threading.Lock()
_lib = None
_lib_lock = threading.Lock()


def lookup_plain(tables, idx, w, spec: GridSpec) -> torch.Tensor:
    """K3's function in PyTorch: tables [T, C] per grid, idx (row within the
    level) and w [G, N, L, 4] → [N, G·L·C] with grid-major, then level-major,
    then channel columns."""
    return torch.cat([corner_sum(t, i, wq, spec) for t, i, wq in zip(tables, idx, w)], dim=-1)


# ---- the CUDA kernels -----------------------------------------------------------

def build() -> str:
    """Build (or find in the cache) the kernel library; returns its path."""
    from mere_fusion_tpu_torch.ops.attention import nvcc_path
    from mere_fusion_tpu_torch.runtime.build import build_shared

    return build_shared(
        "mf_hash_lookup", [_SRC],
        [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"])


def load():
    """Build the kernel library if needed and bind it (once per process)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.mf_hash_lookup_fwd.argtypes = (
                [i32, i32] + [ptr] * 5 + [ctypes.POINTER(i32), i32, i64, ptr, ptr])
            lib.mf_hash_lookup_fwd.restype = i32
            lib.mf_hash_lookup_bwd.argtypes = (
                [i32, i32] + [ptr] * 2 + [ctypes.POINTER(i32), i32, i64, i64] + [ptr] * 3)
            lib.mf_hash_lookup_bwd.restype = i32
            _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _offsets(spec: GridSpec):
    """The kernels' level offsets for ``spec``, a ctypes int array."""
    offs = level_offsets(spec)
    return (ctypes.c_int * len(offs))(*offs)


def _check(tables, idx: torch.Tensor, w: torch.Tensor, spec: GridSpec) -> int:
    """Raise on anything the kernels do not take; returns N."""
    g, levels = len(tables), spec.num_levels
    if not 1 <= g <= MAX_GRIDS:
        raise ValueError(f"K3 takes 1 to {MAX_GRIDS} grids, got {g}")
    if levels > MAX_LEVELS or spec.level_dim != 1:
        raise ValueError(f"K3 takes at most {MAX_LEVELS} levels of one channel, got "
                         f"{levels} of {spec.level_dim}")
    n = w.shape[1] if w.dim() == 4 else -1
    for name, x, dtype, shape in (
            *((f"table[{q}]", t, torch.float32, (spec.total_params, 1))
              for q, t in enumerate(tables)),
            ("idx", idx, torch.int32, (g, n, levels, CORNERS)),
            ("w", w, torch.float32, (g, n, levels, CORNERS))):
        if not x.is_cuda or x.device != tables[0].device:
            raise ValueError(f"K3 needs every operand on one CUDA device; {name} is on "
                             f"{x.device}, table[0] on {tables[0].device}")
        if x.dtype != dtype:
            raise TypeError(f"K3 takes {name} as {dtype}, got {x.dtype}")
        if x.shape != shape:
            raise ValueError(f"K3 takes {name} of shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"K3 needs contiguous operands; {name} is not")
    if idx.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("K3 needs 16-byte aligned idx and w")
    if n <= 0:
        raise ValueError("K3 needs at least one sample")
    return n


def _tables(xs) -> list:
    return [x.data_ptr() for x in xs] + [None] * (MAX_GRIDS - len(xs))


def lookup_fwd_cuda(tables, idx: torch.Tensor, w: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """Launch K3's forward on the operands' device and PyTorch's current
    stream there; returns [N, G·L] float32."""
    global fwd_launches
    n = _check(tables, idx, w, spec)
    dev = tables[0].device
    out = torch.empty(n, len(tables) * spec.num_levels, dtype=torch.float32, device=dev)
    err = load().mf_hash_lookup_fwd(
        dev.index, len(tables), *_tables(tables), idx.data_ptr(), w.data_ptr(),
        _offsets(spec), spec.num_levels, n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 forward launch failed with cudaError {err}")
    with _count_lock:
        fwd_launches += 1
    return out


def lookup_bwd_cuda(idx: torch.Tensor, w: torch.Tensor, gout: torch.Tensor, spec: GridSpec,
                    tables, out: torch.Tensor | None = None) -> list:
    """Launch K3's backward: the tables' gradients [T, 1] float32, one per
    grid, from gout [N, G·L]. ``tables`` are only checked, not read. The
    kernel writes every row, so ``out`` (a [G, T, 1] float32 buffer to fill,
    by default a new one) needs no zeroing. It takes any table size: the
    kernel cuts each plane's rows into pieces that fit a block's shared
    memory."""
    global bwd_launches
    n = _check(tables, idx, w, spec)
    g, dev = len(tables), tables[0].device
    gout = gout.contiguous()
    if gout.device != dev or gout.dtype != torch.float32 or gout.shape != (
            n, g * spec.num_levels):
        raise ValueError(f"K3 backward takes gout [{n}, {g * spec.num_levels}] float32 "
                         f"on {dev}, got {tuple(gout.shape)} {gout.dtype} on {gout.device}")
    shape = (g, spec.total_params, 1)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    elif (out.shape != shape or out.dtype != torch.float32 or out.device != dev
          or not out.is_contiguous()):
        raise ValueError(f"K3 backward writes out {shape} float32 contiguous on {dev}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    err = load().mf_hash_lookup_bwd(
        dev.index, g, idx.data_ptr(), w.data_ptr(), _offsets(spec), spec.num_levels, n,
        spec.total_params, gout.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 backward launch failed with cudaError {err}")
    with _count_lock:
        bwd_launches += 1
    return list(out.unbind(0))


def weights_grad(tables, idx: torch.Tensor, gout: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """dL/dw [G, N, L, 4] by a plain gather: table[row] · gout."""
    offsets = torch.tensor(level_offsets(spec), dtype=torch.int64, device=gout.device)
    go = gout.reshape(gout.shape[0], len(tables), spec.num_levels, 1)
    return torch.stack([table[i + offsets[:, None], 0] * go[:, q]
                        for q, (table, i) in enumerate(zip(tables, idx))])


class Lookup(torch.autograd.Function):
    """K3 under autograd: ``Lookup.apply(spec, *tables, idx, w)``."""

    @staticmethod
    def forward(ctx, spec: GridSpec, *operands):
        tables, idx, w = operands[:-2], operands[-2], operands[-1]
        ctx.spec = spec
        ctx.save_for_backward(*operands)
        return lookup_fwd_cuda(tables, idx, w, spec)

    @staticmethod
    def backward(ctx, gout):
        *tables, idx, w = ctx.saved_tensors
        need_tables, need_w = ctx.needs_input_grad[1:-2], ctx.needs_input_grad[-1]
        dtables = [None] * len(tables)
        if any(need_tables):
            dtables = lookup_bwd_cuda(idx, w, gout, ctx.spec, tables)
        dw = weights_grad(tables, idx, gout, ctx.spec) if need_w else None
        return (None, *dtables, None, dw)


def lookup(tables, idx: torch.Tensor, w: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """K3: see the module docstring. CPU tensors take the plain version,
    CUDA tensors the kernels (which launch or raise)."""
    if tables[0].device.type == "cpu":
        return lookup_plain(tables, idx, w, spec)
    return Lookup.apply(spec, *tables, idx, w)


def triplane_corners(xyz: torch.Tensor, spec: GridSpec, bound: float = 1.0):
    """The (xy, yz, xz) planes' corner rows and weights of xyz [N, 3]:
    idx int32 and w float32, each [3, N, L, 4]."""
    coords = torch.stack((xyz[:, :2], xyz[:, 1:], xyz[:, ::2]))
    return corner_indices_weights(coords, spec, bound)


def triplane_encode(plane_xy, plane_yz, plane_xz, xyz: torch.Tensor, spec: GridSpec,
                    bound: float = 1.0, impl: str = "auto") -> torch.Tensor:
    """ER-NeRF ``encode_x``: [N, 3] in [−bound, bound] → [N, 3·L·C] in
    (xy, yz, xz) order, all three planes in one lookup. ``impl`` "auto" is
    ``lookup``; "plain" takes the plain version on any device."""
    idx, w = triplane_corners(xyz, spec, bound)
    tables = (plane_xy, plane_yz, plane_xz)
    if impl == "plain":
        return lookup_plain(tables, idx, w, spec)
    if impl != "auto":
        raise ValueError(f"unknown hash lookup impl {impl!r}")
    return lookup(tables, idx, w, spec)
