"""The triplane sampler family: K2 and its siblings K2b, K2c and K2d.

Port of the Pallas TPU kernels of mere_fusion_tpu/ops/pallas_sampler.py and
of the host-side pieces around them: ``SamplerSpec``, ``pack_planes_major``
(bf16 planes with a mip pyramid along the contract axis),
``tile_permutation``/``to_tiles``/``from_tiles``, the planners
(``plan_jobs_span``, ``plan_jobs``/``plan_jobs_grouped``,
``plan_jobs_rays``: window origin and mip level per tile, plane and depth
group, and texel coordinates per sample), ``enc_selector`` and
``regroup_features``. The kernels, one per TPU kernel:

- **K2** ``sample_shade_comp_tiles`` (``_shade_comp_kernel``): sample +
  NeRF head + volume composite, per ray. The serving frame's kernel. Its
  head runs on the tensor cores: with bf16 weights as ``wgmma`` products
  over 64-sample row blocks, with f32 weights as ``mma.sync`` TF32 products
  over 32-sample row blocks, three a term (f32 accuracy).
- **K2b** ``sample_shade_tiles`` (``_shade_kernel``): sample + head, the
  activated σ and rgb per sample (the unfused oracle of K2's composite).
- **K2c** ``render_rays_tiles`` (``_render_rays_kernel``): K2 with each
  sample's texel coordinate made in the kernel from its ray's (o, d, zmin,
  zmax) and the mip placement of ``plan_jobs_rays``.
- **K2d** ``sample_tiles`` (``_sampler_kernel``): the windowed bilinear
  features alone, bf16.

K2b and K2c are instances of K2's two kernels (templates on a ``Stage`` in
csrc/sampler_core.cuh): the same grid, block, weight staging, fetch and
head; they differ from K2 only in where a sample's coordinates come from and
what a tile writes, and need K2's shared memory.

The TPU kernels' two-hot tent matmuls and DMA window ring exist because the
TPU has no fast gather; Hopper has one. What the port keeps is the function:
for each sample, the texel coordinate clamped into its job's window
(``clip(u − ou, 0, wu − 1.001)``), the bilinear filter with the u-weights
rounded to bf16 and the v-weights in f32, the head chain with every matmul's
left operand rounded to the weights' dtype, and the per-ray composite in
depth order.

Each kernel has three functions: ``<name>_plain``, the same function in
PyTorch (gathers and matmuls, chunked over tiles: the CPU path and the
yardstick); ``<name>_cuda``, which launches the hand-written CUDA C++ kernel
(``csrc/sampler.cu``, nvcc for sm_90a on first use, ctypes) and raises on
anything the kernel does not take; and ``<name>``, the wrapper: CPU tensors
go to the plain version, CUDA tensors to the kernel.

``launches`` (K2), ``shade_launches`` (K2b), ``rays_launches`` (K2c) and
``sample_launches`` (K2d) count each kernel's launches in this process.
"""
from __future__ import annotations

import ctypes
import os
import sys
import threading
from dataclasses import dataclass

import numpy as np
import torch

CP = 16               # padded channels per plane texel
THREADS = 256         # threads per block of the kernel
MAX_JOB_INTS = 64     # ints of a tile's job table the kernels take
SMEM_LIMIT = 232448   # bytes of shared memory a block may use on sm_90
# fixed widths of the ER-NeRF head the kernel is written for
HID, AUD, EYE_HID = 64, 32, 16

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "sampler.cu")
CORE_HEADER = os.path.join(_CSRC, "sampler_core.cuh")   # device code shared with S1/S2

#: K2's kernel by the dtype of its shade weights, as named in profiler rows
KERNEL_NAMES = {"bfloat16": "sample_shade_comp_wgmma_kernel",
                "float32": "sample_shade_comp_tf32_kernel"}
#: the Stage (csrc/sampler_core.cuh) each kernel instantiates K2's kernels at
STAGES = {"K2": 2, "K2b": 3, "K2c": 4}


def instance_tag(kernel: str, wdtype: str) -> str:
    """What the mangled name of ``kernel``'s instance (K2, K2b or K2c) of
    K2's kernel for shade weights of dtype ``wdtype`` holds, and no other
    instance's (ptxas's log, cuobjdump's SASS)."""
    return f"{KERNEL_NAMES[wdtype]}ILi{STAGES[kernel]}E"

launches = 0          # K2
shade_launches = 0    # K2b
rays_launches = 0     # K2c
sample_launches = 0   # K2d
_count_lock = threading.Lock()
_lib = None
_lib_lock = threading.Lock()


@dataclass(frozen=True)
class SamplerSpec:
    resolution: int          # plane texture resolution R
    channels: int            # real feature channels C (e.g. 12)
    tile_w: int = 8          # pixels per tile, x
    tile_h: int = 8          # pixels per tile, y
    k: int = 16              # samples per ray
    kg: int = 4              # depth groups per ray (k % kg == 0)
    wu: int = 64             # window extent along the contract axis
    wv: int = 32             # window extent along the lateral axis
    levels: int = 5          # mip levels (level 0 = full resolution)

    @property
    def cp(self) -> int:
        return CP

    @property
    def rays_per_tile(self) -> int:
        return self.tile_w * self.tile_h

    @property
    def sg(self) -> int:     # samples per depth group within a job
        return self.rays_per_tile * (self.k // self.kg)

    @property
    def mip_rows(self) -> tuple:
        """Row offset of each mip level in the packed plane, then the total."""
        offs, off = [], 0
        for lvl in range(self.levels):
            offs.append(off)
            off += max(self.resolution >> lvl, self.wu)
        return tuple(offs + [off])


def pack_planes_major(planes: dict, spec: SamplerSpec) -> torch.Tensor:
    """Baked planes (``[R, R, C]`` or flat ``[R·R, C]``, storage [row =
    second coord, col = first coord]) → bf16 ``[3, Σ mip rows, R·CP]``:
    plane xy contracts x, yz and xz contract z; mip level l is a 2^l×
    average-pooled copy at rows ``mip_rows[l]``, lanes ``[0, (R/2^l)·CP)``."""
    r, cp, c = spec.resolution, spec.cp, spec.channels

    def prep(p, transpose: bool):
        p = p.reshape(r, r, -1).to(torch.bfloat16)
        if transpose:
            p = p.transpose(0, 1)
        level = torch.cat([p, torch.zeros(r, r, cp - c, dtype=torch.bfloat16,
                                          device=p.device)], dim=-1)
        rows = spec.mip_rows
        out = torch.zeros(rows[-1], r * cp, dtype=torch.bfloat16, device=p.device)
        for lvl in range(spec.levels):
            rl = level.shape[0]
            out[rows[lvl]: rows[lvl] + rl, : rl * cp] = level.reshape(rl, rl * cp)
            if lvl + 1 < spec.levels:
                level = (level.reshape(rl // 2, 2, rl // 2, 2, cp).float()
                         .mean(dim=(1, 3)).to(torch.bfloat16))
        return out

    return torch.stack([prep(planes["plane_xy"], True),
                        prep(planes["plane_yz"], False),
                        prep(planes["plane_xz"], False)])


# ---- pixel tiles --------------------------------------------------------------

def tile_permutation(h: int, w: int, tile_w: int, tile_h: int) -> np.ndarray:
    """Pixel permutation row-major → tile-major."""
    idx = np.arange(h * w).reshape(h, w)
    tiles = [idx[ty:ty + tile_h, tx:tx + tile_w].reshape(-1)
             for ty in range(0, h, tile_h) for tx in range(0, w, tile_w)]
    return np.concatenate(tiles)


def to_tiles(x: torch.Tensor, h: int, w: int, tile_w: int, tile_h: int):
    """Row-major pixel array [H·W, ...] → tile-major [T, tile_h·tile_w, ...]."""
    lead = x.shape[1:]
    x = x.reshape(h // tile_h, tile_h, w // tile_w, tile_w, *lead).transpose(1, 2)
    return x.reshape(-1, tile_h * tile_w, *lead)


def from_tiles(x: torch.Tensor, h: int, w: int, tile_w: int, tile_h: int):
    """Inverse of to_tiles."""
    lead = x.shape[2:]
    x = x.reshape(h // tile_h, w // tile_w, tile_h, tile_w, *lead).transpose(1, 2)
    return x.reshape(h * w, *lead)


# ---- planning -----------------------------------------------------------------

#: per plane, the (u, v) coordinate axes of xyz, u the contract axis:
#: xy → (x, y), yz → (z, y), xz → (z, x)
PLANE_UV = ((0, 1), (2, 1), (2, 0))


def _plane_uv(tex):
    """Texel coordinates [..., 3] (x, y, z) → per-plane (u, v) stacked as
    [..., 3 planes, 2] (PLANE_UV)."""
    return torch.stack([torch.stack([tex[..., u], tex[..., v]], dim=-1) for u, v in PLANE_UV],
                       dim=-2)


def _fit_windows(lo, hi, spec: SamplerSpec):
    """Mip level and window origin per (tile, plane, group) from the
    footprint's texel extrema lo/hi [T, 3, kg, 2] (level-0 texels, u then v):
    the coarsest level the footprint needs to fit the window (usable extent
    w − 10: 8 of alignment slack, 2 of margin), then a 1-texel-margin origin
    rounded down to a multiple of 8 and clamped into that level. Returns
    (lvl [T, 3, kg] int32, ms = 2^lvl float32, mip_base int32, ou (absolute
    row in the mip stack), ov, overflow [T, 3] bool)."""
    r = spec.resolution
    ext = torch.clamp(hi - lo, min=0.0)
    need = torch.maximum(ext[..., 0] / (spec.wu - 10), ext[..., 1] / (spec.wv - 10))
    lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp(need, min=1e-6))),
                      0, spec.levels - 1).to(torch.int32)
    ms = torch.bitwise_left_shift(torch.ones_like(lvl), lvl).float()
    rl = r / ms
    mip_base = torch.tensor(spec.mip_rows[:-1], dtype=torch.int32, device=lo.device)[lvl.long()]
    lo_l = (lo + 0.5) / ms[..., None] - 0.5
    # only a footprint wider than the coarsest level's window still overflows
    overflow = (need / ms > 1.0).any(dim=-1)
    rli = rl.to(torch.int32)
    ou = torch.minimum(torch.clamp((lo_l[..., 0] - 1).to(torch.int32) & ~7, min=0),
                       torch.clamp(rli - spec.wu, min=0))
    ov = torch.minimum(torch.clamp((lo_l[..., 1] - 1).to(torch.int32) & ~7, min=0),
                       torch.clamp(rli - spec.wv, min=0))
    return lvl, ms, mip_base, ou + mip_base, ov, overflow


def _job_table(*per_group) -> torch.Tensor:
    """Per-group int32 fields [T, 3, kg] each → the job table [T, 3, 1 +
    n·kg]: the plane id, then the fields of each group in turn."""
    t, _, kg = per_group[0].shape
    plane_id = torch.arange(3, dtype=torch.int32, device=per_group[0].device)[None].expand(t, 3)
    fields = torch.stack(per_group, dim=-1).reshape(t, 3, len(per_group) * kg)
    return torch.cat([plane_id[..., None], fields], dim=-1)


def _mip_uv(uv, ms, mip_base):
    """Level-0 texel coordinates uv [T, 3, kg, 2, sg] → coordinates at each
    job's mip level, u lifted to absolute rows of the mip stack."""
    uv = (uv + 0.5) / ms[..., None, None] - 0.5
    uv[..., 0, :] += mip_base[..., None].float()
    return uv


def _endpoint_extrema(o_t, d_t, zmin, zmax, valid, spec: SamplerSpec, bound: float):
    """Footprint extrema lo/hi [T, 3, kg, 2] over each group's valid rays
    from the rays' two end samples per group: coordinates are monotonic
    along a ray (the clip to the box keeps them so), and each group's
    sample fractions include both of its ends."""
    from mere_fusion_tpu_torch.models.ernerf.renderer import linspace01

    kg, ks = spec.kg, spec.k // spec.kg
    scale = spec.resolution / (2.0 * bound)
    kf = linspace01(spec.k, zmin.device).reshape(kg, ks)
    ke = torch.stack([kf[:, 0], kf[:, -1]], dim=-1)              # [kg, 2]
    span = zmax - zmin
    z_e = zmin[:, None, :, None] + span[:, None, :, None] * ke[:, None, :]
    xyz_e = torch.clamp(o_t[:, None, :, None] + d_t[:, None, :, None] * z_e[..., None],
                        -bound, bound)                           # [T, kg, rpt, 2, 3]
    uv_e = _plane_uv((xyz_e + bound) * scale - 0.5)              # [T, kg, rpt, 2, 3, 2]
    uv_e = uv_e.permute(0, 4, 1, 5, 2, 3)                        # [T, 3, kg, 2, rpt, 2]
    vm = valid[:, None, None, None, :, None]
    big = torch.tensor(1e9, dtype=torch.float32, device=zmin.device)
    lo = torch.where(vm, uv_e, big).amin(dim=(4, 5))
    hi = torch.where(vm, uv_e, -big).amax(dim=(4, 5))
    return lo, hi


def plan_jobs_span(o_t, d_t, zmin, zmax, valid, spec: SamplerSpec, bound: float):
    """Window origins and texel coordinates for K2 from per-ray spans.

    o_t/d_t [T, rpt, 3], zmin/zmax [T, rpt] (zmax == zmin on invalid rays),
    valid [T, rpt]. Window fits use endpoint math only
    (``_endpoint_extrema``). Returns (scalars [T, 3, 1+2kg] int32 — plane,
    then (ou, ov) per group, ou absolute in the mip stack —, uv [T, 3, kg, 2,
    sg] float32 — u absolute, v mip-local —, overflow [T, 3] bool: a group's
    footprint wider than its window at the coarsest mip, whose samples clamp
    to the window edge)."""
    dev = zmin.device
    kg, k = spec.kg, spec.k
    ks = k // kg
    sg = spec.sg
    scale = spec.resolution / (2.0 * bound)
    lo, hi = _endpoint_extrema(o_t, d_t, zmin, zmax, valid, spec, bound)
    _, ms, mip_base, ou, ov, overflow = _fit_windows(lo, hi, spec)

    span = zmax - zmin
    kfs = ((torch.arange(kg, device=dev)[:, None] * ks
            + torch.arange(sg, device=dev)[None, :] % ks) / (k - 1.0))   # [kg, sg]
    rep = lambda a: torch.repeat_interleave(a, ks, dim=-1)       # [T, rpt] → [T, sg]
    z_s = rep(zmin)[:, None, :] + rep(span)[:, None, :] * kfs[None]      # [T, kg, sg]
    tex = [(torch.clamp(rep(o_t[..., c])[:, None, :] + rep(d_t[..., c])[:, None, :] * z_s,
                        -bound, bound) + bound) * scale - 0.5
           for c in range(3)]
    uv = _plane_uv(torch.stack(tex, dim=-1)).permute(0, 3, 1, 4, 2)     # [T, 3, kg, 2, sg]
    return _job_table(ou, ov), _mip_uv(uv.contiguous(), ms, mip_base), overflow


def plan_jobs_grouped(xyz_g, valid_g, spec: SamplerSpec, bound: float):
    """The job table and texel coordinates from sample positions already in
    the kernels' group-major order: xyz_g [T, kg, sg, 3] (sg = rpt·k/kg,
    ray-major within a group), valid_g [T, kg, sg]. Window fits take the
    extrema over every valid sample. Returns (scalars [T, 3, 1+2kg] int32,
    uv [T, 3, kg, 2, sg] float32, active [T] bool — a tile with a valid
    sample —, overflow [T, 3] bool), as plan_jobs_span's."""
    t = xyz_g.shape[0]
    scale = spec.resolution / (2.0 * bound)
    uv = _plane_uv((xyz_g + bound) * scale - 0.5).permute(0, 3, 1, 4, 2)  # [T, 3, kg, 2, sg]
    vmask = valid_g.reshape(t, 1, spec.kg, 1, -1)
    big = torch.tensor(1e9, dtype=torch.float32, device=xyz_g.device)
    lo = torch.where(vmask, uv, big).amin(dim=4)                 # [T, 3, kg, 2]
    hi = torch.where(vmask, uv, -big).amax(dim=4)
    _, ms, mip_base, ou, ov, overflow = _fit_windows(lo, hi, spec)
    active = valid_g.reshape(t, -1).any(dim=-1)
    return _job_table(ou, ov), _mip_uv(uv.contiguous(), ms, mip_base), active, overflow


def plan_jobs(xyz_tiles, valid_tiles, spec: SamplerSpec, bound: float):
    """plan_jobs_grouped for tile-major sample positions xyz_tiles [T,
    rpt·k, 3] ordered [ray, k] and valid_tiles [T, rpt, k]: the k samples of
    a ray split into kg depth groups of consecutive samples."""
    t = xyz_tiles.shape[0]
    rpt, kg = spec.rays_per_tile, spec.kg
    ks = spec.k // kg
    xyz_g = (xyz_tiles.reshape(t, rpt, kg, ks, 3).transpose(1, 2)
             .reshape(t, kg, rpt * ks, 3))
    valid_g = valid_tiles.reshape(t, rpt, kg, ks).transpose(1, 2).reshape(t, kg, rpt * ks)
    return plan_jobs_grouped(xyz_g, valid_g, spec, bound)


def plan_jobs_rays(o_t, d_t, zmin, zmax, valid, spec: SamplerSpec, bound: float):
    """The job table for K2c (``render_rays_tiles``), which makes each
    sample's coordinates itself from its ray: endpoint math only, as
    plan_jobs_span. Returns (scalars [T, 3, 1+4kg] int32 — plane, then (ou,
    ov, lvl, mip_base) per group —, overflow [T, 3] bool). Invalid rays
    must also carry zmax == zmin, so that the kernel derives dt = 0."""
    lo, hi = _endpoint_extrema(o_t, d_t, zmin, zmax, valid, spec, bound)
    lvl, _, mip_base, ou, ov, overflow = _fit_windows(lo, hi, spec)
    return _job_table(ou, ov, lvl, mip_base), overflow


def enc_selector(spec: SamplerSpec, dtype=torch.bfloat16) -> torch.Tensor:
    """[3·CP, 3·C] 0/1 matrix S with S[p·CP + c, p·C + c] = 1: maps K2d's
    padded plane-minor feature rows onto the network's enc_x order (planes
    xy, yz, xz, C channels each) as one exact product."""
    cp, c = spec.cp, spec.channels
    rows = torch.arange(3 * cp)
    p, ch = rows // cp, rows % cp
    keep = ch < c
    s = torch.zeros(3 * cp, 3 * c, dtype=dtype)
    s[rows[keep], (p * c + ch)[keep]] = 1
    return s


def regroup_features(feats, spec: SamplerSpec) -> torch.Tensor:
    """K2d's output [T, kg, sg, 3·CP] → per-sample features [T, rpt, k, 3·C]
    in encode_x_baked's order (xy, yz, xz), depth order within each ray."""
    t = feats.shape[0]
    rpt, k, kg, c = spec.rays_per_tile, spec.k, spec.kg, spec.channels
    f = feats.reshape(t, kg, rpt, k // kg, 3, spec.cp)[..., :c]
    return f.transpose(1, 2).reshape(t, rpt, k, 3 * c)


#: packed shade-weight operand names, in kernel argument order; see
#: engines.nerf_step.shade_weights for how each comes from the network.
SHADE_WEIGHTS = (
    "wx_aud",     # [3cp, 64]  aud_ch_att_net.net_0, rows lifted to 3·cp
    "w_aud1",     # [64, A]    aud_ch_att_net.net_1
    "wx_sig",     # [3cp, 64]  sigma_net.net_0 rows :3C, lifted
    "w_aud_sig",  # [A, 64]    diag(enc_a) · sigma_net.net_0 rows 3C:3C+A
    "wx_eye",     # [3cp, 16]  eye_att_net.net_0, lifted
    "w_eye1",     # [16, 8]    eye_att_net.net_1 in col 0
    "w_sig_e",    # [8, 64]    row 0 = eye_scalar · sigma_net.net_0 row 3C+A
    "w_sig1",     # [64, 64]   sigma_net.net_1
    "w_sigcol",   # [64, 16]   sigma_net.net_2 col 0 (σ) in col 0
    "w_geo",      # [64, 64]   sigma_net.net_2 cols 1:65 (geo_feat)
    "w_col_g",    # [64, 64]   color_net.net_0 rows 16:80 (geo part)
    "w_rgb",      # [64, 16]   color_net.net_1 cols 0:3 placed at cols 1:4
    "col_bias",   # [8, 64]    row 0 = ind · color_net.net_0 rows 80: (or 0)
)

#: the shapes the CUDA kernel takes (A = 32)
WEIGHT_SHAPES = {
    "wx_aud": (3 * CP, HID), "w_aud1": (HID, AUD), "wx_sig": (3 * CP, HID),
    "w_aud_sig": (AUD, HID), "wx_eye": (3 * CP, EYE_HID), "w_eye1": (EYE_HID, 8),
    "w_sig_e": (8, HID), "w_sig1": (HID, HID), "w_sigcol": (HID, 16),
    "w_geo": (HID, HID), "w_col_g": (HID, HID), "w_rgb": (HID, 16),
    "col_bias": (8, HID),
}




# ---- the plain versions ---------------------------------------------------------

def _tile_features(planes_major, jobs, uv, spec: SamplerSpec):
    """Per-sample triplane features [Tc, kg·sg, 3·CP] float32 for a chunk of
    tiles: jobs [Tc, 3, 1+2kg] int, uv [Tc, 3, kg, 2, sg]."""
    _, m, width = planes_major.shape
    rv = width // CP
    tex = planes_major.reshape(-1, CP)                 # [3·M·R, CP]
    p = jobs[:, :, 0].long()[:, :, None, None]          # [Tc, 3, 1, 1]
    ou = jobs[:, :, 1::2].long()[..., None]             # [Tc, 3, kg, 1]
    ov = jobs[:, :, 2::2].long()[..., None]
    uc = torch.clamp(uv[:, :, :, 0] - ou.float(), 0.0, spec.wu - 1.001)
    vc = torch.clamp(uv[:, :, :, 1] - ov.float(), 0.0, spec.wv - 1.001)
    i0, j0 = torch.floor(uc), torch.floor(vc)
    # tent weights of the two neighbours; u rounded to bf16 as the TPU does
    wu0 = torch.clamp(1.0 - (i0 - uc).abs(), min=0.0).to(torch.bfloat16).float()
    wu1 = torch.clamp(1.0 - (i0 + 1.0 - uc).abs(), min=0.0).to(torch.bfloat16).float()
    tv0 = torch.clamp(1.0 - (j0 - vc).abs(), min=0.0)
    tv1 = torch.clamp(1.0 - (j0 + 1.0 - vc).abs(), min=0.0)
    row = torch.clamp(ou + i0.long(), 0, m - 2)
    col = torch.clamp(ov + j0.long(), 0, rv - 2)
    base = (p * m + row) * rv + col

    def fetch(off):
        return tex[base + off].float()                  # [Tc, 3, kg, sg, CP]

    m0 = wu0[..., None] * fetch(0) + wu1[..., None] * fetch(rv)
    m1 = wu0[..., None] * fetch(1) + wu1[..., None] * fetch(rv + 1)
    feat = m0 * tv0[..., None] + m1 * tv1[..., None]
    tc, kg, sg = feat.shape[0], spec.kg, spec.sg
    return feat.permute(0, 2, 3, 1, 4).reshape(tc, kg * sg, 3 * CP)


def _mm(a, b, dtype):
    """a @ b with a rounded to ``dtype`` (the weights'), in float32."""
    return torch.matmul(a.to(dtype).to(torch.float32), b.to(torch.float32))


def _dot_seq(a, v, dtype):
    """a [.., K] · v [K], a rounded to ``dtype``, summed k = 0, 1, ... in
    float32: with bf16 operands each product is exact, so each step rounds
    as the kernel's fmaf chain does. torch.matmul of [M, K] by [K, 1] sums
    in an order of its own, which moved the eye logit of a trained avatar's
    sample by an ulp and flipped the bf16 rounding of values downstream."""
    a = a.to(dtype).to(torch.float32)
    v = v.to(torch.float32)
    out = a[..., 0] * v[0]
    for k in range(1, a.shape[-1]):
        out = out + a[..., k] * v[k]
    return out


def head_hidden(x, dsamp, w: dict):
    """The NeRF head chain of the JAX ``_shade_core`` on per-sample features
    x [.., 3·CP] with per-sample direction rows dsamp [.., 64], up to the
    inputs of its last two products: (h, the sigma net's last hidden layer,
    and relu(ch), the colour net's), both [.., 64] float32. Every matmul's
    left operand is rounded to the weights' dtype, products accumulate in
    float32."""
    dtype = w["wx_aud"].dtype
    f32 = torch.float32
    na, ns_, ne = w["wx_aud"].shape[1], w["wx_sig"].shape[1], w["wx_eye"].shape[1]
    hx = _mm(x, torch.cat([w["wx_aud"], w["wx_sig"], w["wx_eye"]], dim=1), dtype)
    aud_h = torch.relu(hx[..., :na])
    h0 = hx[..., na:na + ns_]
    eye_h = torch.relu(hx[..., na + ns_:na + ns_ + ne])
    aud_ch = _mm(aud_h, w["w_aud1"], dtype)
    h = h0 + _mm(aud_ch, w["w_aud_sig"], dtype)
    eye_att = torch.sigmoid(_dot_seq(eye_h, w["w_eye1"][:, 0], dtype)[..., None])
    h = torch.relu(h + eye_att * w["w_sig_e"][0].to(f32))
    h = torch.relu(_mm(h, w["w_sig1"], dtype))
    geo = _mm(h, w["w_geo"], dtype)
    ch = _mm(geo, w["w_col_g"], dtype) + dsamp + w["col_bias"][0].to(f32)
    return h, torch.relu(ch)


def shade_core_plain(x, dsamp, w: dict):
    """The NeRF head chain on per-sample features x [.., 3·CP] with per-sample
    direction rows dsamp [.., 64] (the JAX ``_shade_core``), as
    ``head_hidden``. Returns (σ logit [..], rgb logits [.., 3])."""
    dtype = w["wx_aud"].dtype
    h, rch = head_hidden(x, dsamp, w)
    sig = _mm(h, w["w_sigcol"][:, :1], dtype)[..., 0]
    rgb = _mm(rch, w["w_rgb"][:, 1:4], dtype)
    return sig, rgb


def _sample_rows(dproj, spec: SamplerSpec):
    """Per-ray direction projections [Tc, rpt, ≥64] → per-sample rows [Tc,
    kg·sg, 64] float32 in the kernels' (group, ray, sample) order."""
    tc, rpt = dproj.shape[:2]
    ks = spec.k // spec.kg
    return (dproj[..., :HID].float()[:, None, :, None, :]
            .expand(tc, spec.kg, rpt, ks, HID).reshape(tc, spec.kg * spec.sg, HID))


def _activate(sig, rgb):
    """σ = exp(logit), rgb = sigmoid(logit)·1.002 − 0.001 (ER-NeRF's)."""
    return torch.exp(sig), torch.sigmoid(rgb) * (1 + 2 * 0.001) - 0.001


def _composite(sig, rgb, dt, spec: SamplerSpec):
    """Per-ray volume composite of per-sample logits in (group, ray, sample)
    order: sig [Tc, kg·sg], rgb [Tc, kg·sg, 3], dt [Tc, rpt] (0 on invalid
    rays). Returns [Tc, rpt, 16]: lane 0 Σ weights, lanes 1:4 Σ weight·rgb."""
    tc, rpt, kg = sig.shape[0], spec.rays_per_tile, spec.kg
    ks = spec.k // kg
    # depth order per ray: group-major, then in-group sample
    sig = sig.reshape(tc, kg, rpt, ks).permute(0, 2, 1, 3).reshape(tc, rpt, kg * ks)
    rgb = rgb.reshape(tc, kg, rpt, ks, 3).permute(0, 2, 1, 3, 4).reshape(tc, rpt, kg * ks, 3)
    sigma, color = _activate(sig, rgb)
    sd = sigma * dt[..., None]
    alpha = 1.0 - torch.exp(-sd)
    excl = torch.cat([torch.zeros_like(sd[..., :1]), torch.cumsum(sd[..., :-1], dim=-1)],
                     dim=-1)
    trans = torch.exp(-excl)
    wgt = torch.where(trans > 1e-4, alpha * trans, torch.zeros_like(trans))
    out = torch.zeros(tc, rpt, 16, dtype=torch.float32, device=sig.device)
    out[..., 0] = wgt.sum(dim=-1)
    out[..., 1:4] = (wgt[..., None] * color).sum(dim=-2)
    return out


def sample_shade_comp_tiles_plain(planes_major, jobs, uv, dproj, dtv, weights: dict,
                                  spec: SamplerSpec, chunk: int = 128) -> torch.Tensor:
    """K2's function in PyTorch: see ``sample_shade_comp_tiles``."""
    t = uv.shape[0] // 3
    jobs = jobs.reshape(t, 3, 1 + 2 * spec.kg)
    uv = uv.reshape(t, 3, spec.kg, 2, spec.sg)
    out = torch.empty(t, spec.rays_per_tile, 16, dtype=torch.float32, device=uv.device)
    for s in range(0, t, chunk):
        e = min(t, s + chunk)
        x = _tile_features(planes_major, jobs[s:e], uv[s:e], spec)
        sig, rgb = shade_core_plain(x, _sample_rows(dproj[s:e], spec), weights)
        out[s:e] = _composite(sig, rgb, dtv[s:e, :, 0], spec)
    return out


def sample_shade_tiles_plain(planes_major, jobs, uv, dproj, weights: dict,
                             spec: SamplerSpec, chunk: int = 128) -> torch.Tensor:
    """K2b's function in PyTorch: see ``sample_shade_tiles``."""
    t = uv.shape[0] // 3
    jobs = jobs.reshape(t, 3, 1 + 2 * spec.kg)
    uv = uv.reshape(t, 3, spec.kg, 2, spec.sg)
    out = torch.zeros(t, spec.kg * spec.sg, 16, dtype=torch.float32, device=uv.device)
    for s in range(0, t, chunk):
        e = min(t, s + chunk)
        x = _tile_features(planes_major, jobs[s:e], uv[s:e], spec)
        sig, rgb = shade_core_plain(x, _sample_rows(dproj[s:e], spec), weights)
        out[s:e, :, 0], out[s:e, :, 1:4] = _activate(sig, rgb)
    return out


def sample_tiles_plain(planes_major, jobs, uv, spec: SamplerSpec,
                       chunk: int = 128) -> torch.Tensor:
    """K2d's function in PyTorch: see ``sample_tiles``."""
    t = uv.shape[0] // 3
    jobs = jobs.reshape(t, 3, 1 + 2 * spec.kg)
    uv = uv.reshape(t, 3, spec.kg, 2, spec.sg)
    out = torch.empty(t, spec.kg * spec.sg, 3 * CP, dtype=torch.bfloat16, device=uv.device)
    for s in range(0, t, chunk):
        e = min(t, s + chunk)
        out[s:e] = _tile_features(planes_major, jobs[s:e], uv[s:e], spec).to(torch.bfloat16)
    return out.reshape(t, spec.kg, spec.sg, 3 * CP)


def rays_uv(jobs, rays, spec: SamplerSpec, bound: float):
    """K2c's per-sample coordinates, as its kernel makes them: from the rays
    [T, rpt, 8] (o, d, zmin, zmax) and the job table [T, 3, 1+4kg] of
    plan_jobs_rays, sample j of group g at kf = (g·ks + j)/(k − 1) (a true
    division), z = zmin + span·kf, xyz = clip(o + d·z), level-0 texel
    (xyz + bound)·R/(2·bound) − 0.5, then at the job's mip level
    tex·2^−lvl + (0.5·2^−lvl − 0.5 + mip_base) for u and likewise without
    mip_base for v. Returns (K2's job table [T, 3, 1+2kg] — plane, ou, ov —,
    uv [T, 3, kg, 2, sg] float32)."""
    t = rays.shape[0]
    kg, k = spec.kg, spec.k
    ks = k // kg
    scale = spec.resolution / (2.0 * bound)
    # true f32 divisions: on CUDA torch divides by a Python scalar as a
    # multiply by its reciprocal, which the kernel does not
    kf = torch.from_numpy(np.arange(k, dtype=np.float32) / np.float32(k - 1)).to(rays.device)
    kf = kf.reshape(kg, 1, ks)
    zmin, span = rays[..., 6], rays[..., 7] - rays[..., 6]
    z = zmin[:, None, :, None] + span[:, None, :, None] * kf     # [T, kg, rpt, ks]
    xyz = torch.clamp(rays[:, None, :, None, 0:3] + rays[:, None, :, None, 3:6] * z[..., None],
                      -bound, bound)
    tex = ((xyz + bound) * scale - 0.5).reshape(t, kg, spec.sg, 3)
    lvl, mip_base = jobs[..., 3::4], jobs[..., 4::4]             # [T, 3, kg]
    inv = 1.0 / torch.bitwise_left_shift(torch.ones_like(lvl), lvl).float()
    cv = 0.5 * inv - 0.5
    cu = cv + mip_base.float()
    uv = torch.stack([torch.stack([tex[..., ui] * inv[:, q, :, None] + cu[:, q, :, None],
                                   tex[..., vi] * inv[:, q, :, None] + cv[:, q, :, None]],
                                  dim=2)
                      for q, (ui, vi) in enumerate(PLANE_UV)], dim=1)
    classic = torch.cat([jobs[..., :1], torch.stack([jobs[..., 1::4], jobs[..., 2::4]], dim=-1)
                         .reshape(t, 3, 2 * kg)], dim=-1)
    return classic, uv


def render_rays_tiles_plain(planes_major, jobs, rays, dproj, weights: dict,
                            spec: SamplerSpec, bound: float, chunk: int = 128) -> torch.Tensor:
    """K2c's function in PyTorch: see ``render_rays_tiles``."""
    t = rays.shape[0]
    classic, uv = rays_uv(jobs.reshape(t, 3, 1 + 4 * spec.kg), rays.float(), spec, bound)
    span = rays[..., 7] - rays[..., 6]
    dtv = (span / torch.full_like(span, spec.k))[..., None]
    return sample_shade_comp_tiles_plain(planes_major, classic, uv.reshape(3 * t, spec.kg, 2,
                                                                           spec.sg),
                                         dproj, dtv, weights, spec, chunk)


# ---- the CUDA kernels -----------------------------------------------------------

def build() -> str:
    """Build (or find in the cache) the kernel library; returns its path."""
    from mere_fusion_tpu_torch.ops.attention import nvcc_path
    from mere_fusion_tpu_torch.runtime.build import build_shared

    return build_shared(
        "mf_sampler", [_SRC],
        [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"], headers=(CORE_HEADER,))


_GEOMETRY = [ctypes.c_int] * 8        # tiles, rpt, kg, ks, wu, wv, rows, rv
_WEIGHTS = [ctypes.c_void_p] * len(SHADE_WEIGHTS)


def load():
    """Build the kernel library if needed and bind it (once per process)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            signatures = {
                # device, bf16, planes, jobs, uv, dproj, dtv, weights, out, geometry, stream
                "mf_sample_shade_comp": [i, i, p, p, p, p, p, *_WEIGHTS, p, *_GEOMETRY, p],
                # device, bf16, planes, jobs, uv, dproj, weights, out, geometry, stream
                "mf_sample_shade": [i, i, p, p, p, p, *_WEIGHTS, p, *_GEOMETRY, p],
                # device, bf16, planes, jobs, rays, dproj, weights, out, geometry,
                # bound, scale, stream
                "mf_render_rays": [i, i, p, p, p, p, *_WEIGHTS, p, *_GEOMETRY, f, f, p],
                # device, planes, jobs, uv, out, geometry, stream
                "mf_sample_tiles": [i, p, p, p, p, *_GEOMETRY, p],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _lib = lib
    return _lib


#: the fixed part of a tensor-core K2 block's shared memory (H_FIXED in
#: csrc/sampler_core.cuh): the bf16 W^T tiles, the f32 vectors, an x tile
#: and four warps' scratch rows for each of three warpgroups
HEAD_FIXED_BYTES = 106496


def head_smem_bytes(spec: SamplerSpec) -> int:
    """Dynamic shared memory of one block of K2 with bf16 weights (the
    tensor-core head, ``head_smem`` in csrc/sampler_core.cuh): the fixed
    part, the tile's dproj rows as bf16, a float4 per sample, the job table
    and 1024 bytes to align the base."""
    return (HEAD_FIXED_BYTES + spec.rays_per_tile * HID * 2 + 16 * spec.kg * spec.sg
            + 4 * 64 + 1024)


#: the fixed part of an f32 tensor-core K2 block's shared memory (F_FIXED
#: floats in csrc/sampler_core.cuh): the f32 Wᵀ rows, each padded by 8
#: floats, the f32 vectors, and each warp's 32 rows of x
TF32_FIXED_BYTES = 166208


def tf32_smem_bytes(spec: SamplerSpec) -> int:
    """Dynamic shared memory of one block of K2 with f32 weights (the 3×TF32
    tensor-core head, ``tf32_smem`` in csrc/sampler_core.cuh): the fixed
    part, a float4 per sample and the job table."""
    return TF32_FIXED_BYTES + 16 * spec.kg * spec.sg + 4 * 64


def block_smem_bytes(spec: SamplerSpec, wdtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of K2, K2b or K2c (instances of
    one kernel per weight dtype, with one layout) for shade weights of
    ``wdtype``: ``head_smem_bytes`` for bfloat16, else ``tf32_smem_bytes``."""
    return head_smem_bytes(spec) if wdtype == torch.bfloat16 else tf32_smem_bytes(spec)


def staged_stride(n: int) -> int:
    """The row stride, in floats, of n coordinates staged in a fetch-only
    kernel's shared memory (``staged_stride`` in csrc/sampler_core.cuh): a
    multiple of 4, padded by 4."""
    return (n + 3) // 4 * 4 + 4


def k2d_smem_bytes(spec: SamplerSpec) -> int:
    """Dynamic shared memory of one K2d block (``k2d_smem`` in
    csrc/sampler.cu): two buffers, each a tile's job table (64 ints) and one
    depth group's uv rows, [3][2][staged_stride(sg)] float32."""
    return 2 * (4 * MAX_JOB_INTS + 4 * 6 * staged_stride(spec.sg))


def _check_smem(kernel: str, spec: SamplerSpec, nbytes: int) -> None:
    """Raise, before anything is launched, if a block of ``nbytes`` of
    shared memory does not fit."""
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{kernel}: a tile of {spec.rays_per_tile} rays × {spec.k} samples in "
                         f"{spec.kg} groups needs {nbytes} B of shared memory > {SMEM_LIMIT}")


def _check(kernel: str, spec: SamplerSpec, planes_major, operands: dict, weights=None,
           job_fields: int = 2) -> None:
    """Raise on anything ``kernel`` does not take. operands: name → (tensor,
    dtype or None, shape); weights: the shade weights, whose dtype dproj
    must share."""
    want = {"planes_major": (planes_major, torch.bfloat16, None), **operands}
    if weights is not None:
        want.update({n: (weights[n], None, WEIGHT_SHAPES[n]) for n in SHADE_WEIGHTS})
    dev = planes_major.device
    for name, (x, dtype, shape) in want.items():
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{kernel} needs every operand on one CUDA device; {name} is on "
                             f"{x.device}, planes_major on {dev}")
        if dtype is not None and x.dtype != dtype:
            raise TypeError(f"{kernel} takes {name} as {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{kernel} takes {name} of shape {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel} needs contiguous operands; {name} is not")
    if weights is not None:
        wdt = weights["wx_aud"].dtype
        if wdt not in (torch.float32, torch.bfloat16) or any(
                x.dtype != wdt for x in [operands["dproj"][0],
                                         *(weights[n] for n in SHADE_WEIGHTS)]):
            raise TypeError(f"{kernel} takes dproj and all shade weights as one dtype, "
                            "float32 or bfloat16")
    if (planes_major.dim() != 3 or planes_major.shape[0] != 3
            or planes_major.shape[2] % CP or planes_major.shape[2] // CP < spec.wv
            or planes_major.shape[1] < spec.wu):
        raise ValueError(f"{kernel} takes planes_major [3, rows >= wu, R·{CP}], got "
                         f"{tuple(planes_major.shape)}")
    if spec.k % spec.kg or spec.k < 2 or 3 * (1 + job_fields * spec.kg) > MAX_JOB_INTS:
        raise ValueError(f"{kernel} needs k % kg == 0, k >= 2 and 3·(1 + {job_fields}·kg) "
                         f"<= {MAX_JOB_INTS} (k={spec.k}, kg={spec.kg})")
    if kernel in STAGES and weights is not None:
        wdt = weights["wx_aud"].dtype
        name = str(wdt).split(".")[1]
        if block_smem_bytes(spec, wdt) > SMEM_LIMIT:
            raise ValueError(f"{kernel} with {name} weights: a tile of {spec.rays_per_tile} "
                             f"rays × {spec.k} samples needs {block_smem_bytes(spec, wdt)} B of "
                             f"shared memory > {SMEM_LIMIT}")
        if wdt == torch.bfloat16 and operands["dproj"][0].data_ptr() % 16:
            raise ValueError(f"{kernel} with bfloat16 weights reads dproj in 16-byte rows; it "
                             "must be 16-byte aligned")


def _tiles(x, per_tile: int) -> int:
    """The tile count a leading dimension implies (at least one), or −1."""
    n = x.shape[0] if x.dim() else 0
    return n // per_tile if n and n % per_tile == 0 else -1


def _geometry(spec: SamplerSpec, t: int, planes_major) -> list:
    return [t, spec.rays_per_tile, spec.kg, spec.k // spec.kg, spec.wu, spec.wv,
            planes_major.shape[1], planes_major.shape[2] // CP]


def _launched(err: int, kernel: str, counter: str, module=None) -> None:
    """Raise on a failed launch; count a good one in ``module``'s (this
    module's by default) launch count ``counter``."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {err}")
    module = module or sys.modules[__name__]
    with _count_lock:
        setattr(module, counter, getattr(module, counter) + 1)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def sample_shade_comp_tiles_cuda(planes_major, jobs, uv, dproj, dtv, weights: dict,
                                 spec: SamplerSpec) -> torch.Tensor:
    """Launch K2 on the operands' device and PyTorch's current stream there."""
    t, rpt, kg = _tiles(uv, 3), spec.rays_per_tile, spec.kg
    _check("K2", spec, planes_major, {
        "jobs": (jobs, torch.int32, (t * 3 * (1 + 2 * kg),)),
        "uv": (uv, torch.float32, (3 * t, kg, 2, spec.sg)),
        "dproj": (dproj, None, (t, rpt, HID)),
        "dtv": (dtv, torch.float32, (t, rpt, 8))}, weights)
    dev = planes_major.device
    out = torch.empty(t, rpt, 16, dtype=torch.float32, device=dev)
    err = load().mf_sample_shade_comp(
        dev.index, int(dproj.dtype == torch.bfloat16), planes_major.data_ptr(),
        jobs.data_ptr(), uv.data_ptr(), dproj.data_ptr(), dtv.data_ptr(),
        *[weights[n].data_ptr() for n in SHADE_WEIGHTS], out.data_ptr(),
        *_geometry(spec, t, planes_major), _stream(dev))
    _launched(err, "K2", "launches")
    return out


def sample_shade_comp_tiles(planes_major, jobs, uv, dproj, dtv, weights: dict,
                            spec: SamplerSpec) -> torch.Tensor:
    """K2: fused sample + shade + composite over pixel tiles.

    planes_major [3, Σ mip rows, R·CP] bf16 (pack_planes_major); jobs
    [T·3·(1+2kg)] int32 (plan_jobs_span's scalars, flattened); uv
    [3T, kg, 2, sg] float32; dproj [T, rpt, 64] per-ray SH-direction
    projection; dtv [T, rpt, 8] float32 with each ray's dt·valid in lane 0;
    weights as SHADE_WEIGHTS. Products round their left operand to the
    weights' dtype. The kernel takes dproj and the weights as one dtype,
    float32 or bfloat16; the plain version any float dtypes. Returns [T, rpt, 16]
    float32 per ray: lane 0 Σ weights, lanes 1:4 Σ weight·rgb, others 0.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    if planes_major.device.type == "cpu":
        return sample_shade_comp_tiles_plain(planes_major, jobs, uv, dproj, dtv,
                                             weights, spec)
    return sample_shade_comp_tiles_cuda(planes_major, jobs, uv, dproj, dtv, weights, spec)


def sample_shade_tiles_cuda(planes_major, jobs, uv, dproj, weights: dict,
                            spec: SamplerSpec) -> torch.Tensor:
    """Launch K2b on the operands' device and PyTorch's current stream there."""
    t, rpt, kg = _tiles(uv, 3), spec.rays_per_tile, spec.kg
    _check("K2b", spec, planes_major, {
        "jobs": (jobs, torch.int32, (t * 3 * (1 + 2 * kg),)),
        "uv": (uv, torch.float32, (3 * t, kg, 2, spec.sg)),
        "dproj": (dproj, None, (t, rpt, 2 * HID))}, weights)
    dev = planes_major.device
    out = torch.empty(t, kg * spec.sg, 16, dtype=torch.float32, device=dev)
    err = load().mf_sample_shade(
        dev.index, int(dproj.dtype == torch.bfloat16), planes_major.data_ptr(),
        jobs.data_ptr(), uv.data_ptr(), dproj.data_ptr(),
        *[weights[n].data_ptr() for n in SHADE_WEIGHTS], out.data_ptr(),
        *_geometry(spec, t, planes_major), _stream(dev))
    _launched(err, "K2b", "shade_launches")
    return out


def sample_shade_tiles(planes_major, jobs, uv, dproj, weights: dict,
                       spec: SamplerSpec) -> torch.Tensor:
    """K2b: fused sample + shade, activated per sample.

    planes_major, jobs, uv and weights as K2's; dproj [T, rpt, 128] per-ray
    direction projection in lanes :64 (lanes 64: zero, as the TPU kernel
    takes it). Returns [T, kg·sg, 16] float32 per sample in group-major
    (kg, rpt, k/kg) order: lane 0 σ = exp(logit), lanes 1:4 rgb =
    sigmoid(logit)·1.002 − 0.001, other lanes 0. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if planes_major.device.type == "cpu":
        return sample_shade_tiles_plain(planes_major, jobs, uv, dproj, weights, spec)
    return sample_shade_tiles_cuda(planes_major, jobs, uv, dproj, weights, spec)


def render_rays_tiles_cuda(planes_major, jobs, rays, dproj, weights: dict,
                           spec: SamplerSpec, bound: float) -> torch.Tensor:
    """Launch K2c on the operands' device and PyTorch's current stream there."""
    t, rpt, kg = _tiles(rays, 1), spec.rays_per_tile, spec.kg
    _check("K2c", spec, planes_major, {
        "jobs": (jobs, torch.int32, (t * 3 * (1 + 4 * kg),)),
        "rays": (rays, torch.float32, (t, rpt, 8)),
        "dproj": (dproj, None, (t, rpt, HID))}, weights, job_fields=4)
    dev = planes_major.device
    out = torch.empty(t, rpt, 16, dtype=torch.float32, device=dev)
    err = load().mf_render_rays(
        dev.index, int(dproj.dtype == torch.bfloat16), planes_major.data_ptr(),
        jobs.data_ptr(), rays.data_ptr(), dproj.data_ptr(),
        *[weights[n].data_ptr() for n in SHADE_WEIGHTS], out.data_ptr(),
        *_geometry(spec, t, planes_major), float(bound),
        spec.resolution / (2.0 * bound), _stream(dev))
    _launched(err, "K2c", "rays_launches")
    return out


def render_rays_tiles(planes_major, jobs, rays, dproj, weights: dict, spec: SamplerSpec,
                      bound: float) -> torch.Tensor:
    """K2c: K2 with each sample's texel coordinates made in the kernel.

    jobs [T·3·(1+4kg)] int32 from plan_jobs_rays (per job: plane, then (ou,
    ov, lvl, mip_base) per group); rays [T, rpt, 8] float32 per ray (ox, oy,
    oz, dx, dy, dz, zmin, zmax), an invalid ray with zmin == zmax (dt =
    span/k is then 0); dproj [T, rpt, 64]; planes_major and weights as K2's.
    Coordinates as ``rays_uv``. Returns [T, rpt, 16] float32 as K2's. CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if planes_major.device.type == "cpu":
        return render_rays_tiles_plain(planes_major, jobs, rays, dproj, weights, spec, bound)
    return render_rays_tiles_cuda(planes_major, jobs, rays, dproj, weights, spec, bound)


def sample_tiles_cuda(planes_major, jobs, uv, spec: SamplerSpec) -> torch.Tensor:
    """Launch K2d on the operands' device and PyTorch's current stream there."""
    _check_smem("K2d", spec, k2d_smem_bytes(spec))
    t, kg = _tiles(uv, 3), spec.kg
    _check("K2d", spec, planes_major, {
        "jobs": (jobs, torch.int32, (t * 3 * (1 + 2 * kg),)),
        "uv": (uv, torch.float32, (3 * t, kg, 2, spec.sg))})
    dev = planes_major.device
    out = torch.empty(t, kg, spec.sg, 3 * CP, dtype=torch.bfloat16, device=dev)
    err = load().mf_sample_tiles(
        dev.index, planes_major.data_ptr(), jobs.data_ptr(), uv.data_ptr(), out.data_ptr(),
        *_geometry(spec, t, planes_major), _stream(dev))
    _launched(err, "K2d", "sample_launches")
    return out


def sample_tiles(planes_major, jobs, uv, spec: SamplerSpec) -> torch.Tensor:
    """K2d: the windowed bilinear triplane features alone.

    planes_major, jobs and uv as K2's. Returns [T, kg, sg, 3·CP] bfloat16:
    per sample, plane p's CP channels at lanes [p·CP, (p+1)·CP) (the pad
    channels sample the planes' zero pad). CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if planes_major.device.type == "cpu":
        return sample_tiles_plain(planes_major, jobs, uv, spec)
    return sample_tiles_cuda(planes_major, jobs, uv, spec)
