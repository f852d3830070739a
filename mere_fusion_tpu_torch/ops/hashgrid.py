"""Multi-level hash/tiled grid encoding (instant-NGP style).

Port of mere_fusion_tpu/ops/hashgrid.py (numerics of the reference CUDA
gridencoder: per level the scale is 2^(l·S)·H − 1, corner indices use the
stride-or-fast-hash rule with primes {1, 2654435761, 805459861}, and the
2^D corner embeddings are lerped). The JAX package's uint32 index math runs
here in int64 masked to 32 bits, with XLA's saturating float → uint32 cast;
the rows come out as int32. ``corner_sum`` is the plain weighted corner sum,
the one plain encode of the package (``grid_encode`` for the bake, and
``ops/hash_lookup.lookup_plain``, K3's plain version). Plain PyTorch
gathers: the JAX package leaves the corner rows to XLA too (K4, not a
Pallas kernel).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437, 2165219737)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class GridSpec:
    input_dim: int = 2
    num_levels: int = 12
    level_dim: int = 1
    base_resolution: int = 64
    log2_hashmap_size: int = 14
    desired_resolution: int = 512
    gridtype: str = "hash"          # "hash" | "tiled"
    align_corners: bool = False

    @property
    def per_level_scale(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return float(
            np.exp2(np.log2(self.desired_resolution / self.base_resolution)
                    / (self.num_levels - 1))
        )

    def level_params(self) -> list[tuple[float, int, int, int]]:
        """[(scale, resolution, hashmap_size, offset)] per level."""
        s = np.log2(self.per_level_scale)
        max_params = 2 ** self.log2_hashmap_size
        out = []
        offset = 0
        for l in range(self.num_levels):
            scale = float(np.exp2(l * s) * self.base_resolution - 1.0)
            resolution = int(np.ceil(scale)) + 1
            side = resolution if self.align_corners else resolution + 1
            params_in_level = min(max_params, side ** self.input_dim)
            params_in_level = int(np.ceil(params_in_level / 8) * 8)
            out.append((scale, resolution, params_in_level, offset))
            offset += params_in_level
        return out

    @property
    def total_params(self) -> int:
        _, _, n, off = self.level_params()[-1]
        return off + n


def row_rule(spec: GridSpec, resolution: int, hsize: int) -> tuple[list[int], bool]:
    """A level's corner → row rule (get_grid_index): each coordinate's stride
    in a dense row (0 for a coordinate past the table's size) and whether
    the level hashes its corners instead."""
    side = resolution if spec.align_corners else resolution + 1
    strides, stride = [], 1
    for _ in range(spec.input_dim):
        strides.append(stride if stride <= hsize else 0)
        if stride <= hsize:
            stride *= side
    return strides, spec.gridtype == "hash" and stride > hsize


def _corner_index(pg: list, spec: GridSpec, resolution: int, hsize: int) -> torch.Tensor:
    """Grid corner → table row (get_grid_index); pg holds D int64 arrays of
    values < 2^32."""
    strides, hashed = row_rule(spec, resolution, hsize)
    index = torch.zeros_like(pg[0])
    for d in range(spec.input_dim):
        index = index ^ ((pg[d] * _PRIMES[d]) & _U32) if hashed else \
            (index + pg[d] * strides[d]) & _U32
    return (index % hsize).to(torch.int32)


def corner_indices_weights(x: torch.Tensor, spec: GridSpec, bound: float):
    """Per-level corner table rows + bilinear weights for x [N, D].

    Returns (idx [N, L, 2^D] int32 local to each level's table,
    w [N, L, 2^D] float32). Every row is below the level's table size, at
    most 2^log2_hashmap_size, so 4-byte indices hold it."""
    # a true division on every device, as the JAX package's eager arithmetic
    # (PyTorch on CUDA divides by a Python scalar as a product by its f32
    # reciprocal, which differs by an ulp where 2·bound is not a power of two;
    # a 0-dim tensor on x's device takes the true division)
    x01 = (x + bound) / torch.full((), 2.0 * bound, dtype=x.dtype, device=x.device)
    corners = list(itertools.product((0, 1), repeat=spec.input_dim))
    idx_levels, w_levels = [], []
    for scale, resolution, hsize, _offset in spec.level_params():
        pos = x01 * scale + (0.0 if spec.align_corners else 0.5)
        pf = torch.floor(pos)
        frac = pos - pf
        # XLA's float → uint32 conversion saturates: a point below the box
        # (pos < 0, e.g. a jittered training point) takes cell 0, not a
        # wrapped one
        pfi = torch.clamp(pf.to(torch.int64), 0, _U32)
        idx_corners, w_corners = [], []
        for corner in corners:
            w = torch.ones(x.shape[:-1], dtype=x01.dtype, device=x.device)
            pg = []
            for d, c in enumerate(corner):
                w = w * (frac[..., d] if c else (1.0 - frac[..., d]))
                pg.append((pfi[..., d] + c) & _U32)
            idx_corners.append(_corner_index(pg, spec, resolution, hsize))
            w_corners.append(w)
        idx_levels.append(torch.stack(idx_corners, dim=-1))
        w_levels.append(torch.stack(w_corners, dim=-1))
    return (torch.stack(idx_levels, dim=-2),
            torch.stack(w_levels, dim=-2).to(torch.float32))


def level_offsets(spec: GridSpec) -> list[int]:
    """First table row of each level."""
    return [off for (_, _, _, off) in spec.level_params()]


def corner_sum(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
               spec: GridSpec) -> torch.Tensor:
    """The weighted corner sum over one table [T, C]: idx (row within the
    level) and w [..., L, 2^D] → [..., L·C], corner by corner, every product
    and sum rounded on its own."""
    offsets = torch.tensor(level_offsets(spec), dtype=torch.int64, device=idx.device)
    rows = table[idx + offsets[:, None]]                # [..., L, 2^D, C]
    acc = w[..., 0, None] * rows[..., 0, :]
    for k in range(1, idx.shape[-1]):
        acc = acc + w[..., k, None] * rows[..., k, :]
    return acc.reshape(*acc.shape[:-2], spec.num_levels * spec.level_dim)


def grid_encode(table: torch.Tensor, x: torch.Tensor, spec: GridSpec,
                bound: float = 1.0) -> torch.Tensor:
    """x [..., D] in [−bound, bound] → features [..., L·C]."""
    idx, w = corner_indices_weights(x, spec, bound)
    return corner_sum(table, idx, w, spec)
