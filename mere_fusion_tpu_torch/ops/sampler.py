"""K2: fused triplane sample + NeRF head + volume composite, per pixel tile.

Port of the Pallas TPU kernel mere_fusion_tpu/ops/pallas_sampler.py
(``sample_shade_comp_tiles`` → ``_shade_comp_kernel``) and of the host-side
pieces around it: ``SamplerSpec``, ``pack_planes_major`` (bf16 planes with a
mip pyramid along the contract axis), ``tile_permutation``/``to_tiles``/
``from_tiles`` and the span planner ``plan_jobs_span`` (window origin and
mip level per tile, plane and depth group; texel coordinates per sample).

The TPU kernel's two-hot tent matmuls and DMA window ring exist because the
TPU has no fast gather; Hopper has one. What the port keeps is the function:
for each sample, the texel coordinate clamped into its job's window
(``clip(u − ou, 0, wu − 1.001)``), the bilinear filter with the u-weights
rounded to bf16 and the v-weights in f32, the head chain with every matmul's
left operand rounded to the weights' dtype, and the per-ray composite in
depth order.

- ``sample_shade_comp_tiles_plain``: the same function in PyTorch (gathers
  and matmuls), chunked over tiles. The CPU path and the yardstick.
- ``sample_shade_comp_tiles_cuda``: launches the hand-written CUDA C++
  kernel (``csrc/sampler.cu``, nvcc for sm_90a on first use, ctypes). It
  raises on anything the kernel does not take.
- ``sample_shade_comp_tiles``: the wrapper the render step calls: CPU
  tensors go to the plain version, CUDA tensors to the kernel.

``launches`` counts the kernel's successful launches in this process.
"""
from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

CP = 16               # padded channels per plane texel
THREADS = 256         # threads per block of the kernel
SMEM_LIMIT = 232448   # bytes of shared memory a block may use on sm_90
# fixed widths of the ER-NeRF head the kernel is written for
HID, AUD, EYE_HID = 64, 32, 16

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "sampler.cu")

launches = 0
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

def plan_jobs_span(o_t, d_t, zmin, zmax, valid, spec: SamplerSpec, bound: float):
    """Window origins and texel coordinates for K2 from per-ray spans.

    o_t/d_t [T, rpt, 3], zmin/zmax [T, rpt] (zmax == zmin on invalid rays),
    valid [T, rpt]. Each (tile, plane, group) footprint's extrema are its
    rays' endpoint samples (coordinates are monotonic along a ray), so the
    window fit needs endpoint math only. Returns (scalars [T, 3, 1+2kg]
    int32 — plane, then (ou, ov) per group, ou absolute in the mip stack —,
    uv [T, 3, kg, 2, sg] float32 — u absolute, v mip-local —, overflow
    [T, 3] bool: a group's footprint wider than its window at the coarsest
    mip, whose samples clamp to the window edge)."""
    from mere_fusion_tpu_torch.models.ernerf.renderer import linspace01

    dev = zmin.device
    t, rpt = zmin.shape
    kg, k = spec.kg, spec.k
    ks = k // kg
    sg = spec.sg
    r = spec.resolution
    scale = r / (2.0 * bound)

    kf = linspace01(k, dev).reshape(kg, ks)
    ke = torch.stack([kf[:, 0], kf[:, -1]], dim=-1)              # [kg, 2]
    span = zmax - zmin
    z_e = zmin[:, None, :, None] + span[:, None, :, None] * ke[:, None, :]
    xyz_e = torch.clamp(o_t[:, None, :, None] + d_t[:, None, :, None] * z_e[..., None],
                        -bound, bound)                           # [T, kg, rpt, 2, 3]
    tex_e = (xyz_e + bound) * scale - 0.5
    xe, ye, ze = tex_e[..., 0], tex_e[..., 1], tex_e[..., 2]
    uv_e = torch.stack([torch.stack([xe, ye], dim=2),
                        torch.stack([ze, ye], dim=2),
                        torch.stack([ze, xe], dim=2)], dim=1)    # [T, 3, kg, 2, rpt, 2]
    vm = valid[:, None, None, None, :, None]
    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    lo = torch.where(vm, uv_e, big).amin(dim=(4, 5))             # [T, 3, kg, 2]
    hi = torch.where(vm, uv_e, -big).amax(dim=(4, 5))
    ext = torch.clamp(hi - lo, min=0.0)

    need = torch.maximum(ext[..., 0] / (spec.wu - 10), ext[..., 1] / (spec.wv - 10))
    lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp(need, min=1e-6))),
                      0, spec.levels - 1).to(torch.int32)        # [T, 3, kg]
    ms = torch.bitwise_left_shift(torch.ones_like(lvl), lvl).float()
    rl = r / ms
    mip_base = torch.tensor(spec.mip_rows[:-1], dtype=torch.int32, device=dev)[lvl.long()]
    lo_l = (lo + 0.5) / ms[..., None] - 0.5
    overflow = (need / ms > 1.0).any(dim=-1)                     # [T, 3]
    rli = rl.to(torch.int32)
    ou = torch.minimum(torch.clamp((lo_l[..., 0] - 1).to(torch.int32) & ~7, min=0),
                       torch.clamp(rli - spec.wu, min=0))
    ov = torch.minimum(torch.clamp((lo_l[..., 1] - 1).to(torch.int32) & ~7, min=0),
                       torch.clamp(rli - spec.wv, min=0))
    ou = ou + mip_base

    plane_id = torch.arange(3, dtype=torch.int32, device=dev)[None].expand(t, 3)
    scalars = torch.cat([plane_id[..., None],
                         torch.stack([ou, ov], dim=-1).reshape(t, 3, 2 * kg)], dim=-1)

    kfs = ((torch.arange(kg, device=dev)[:, None] * ks
            + torch.arange(sg, device=dev)[None, :] % ks) / (k - 1.0))   # [kg, sg]
    rep = lambda a: torch.repeat_interleave(a, ks, dim=-1)       # [T, rpt] → [T, sg]
    z_s = rep(zmin)[:, None, :] + rep(span)[:, None, :] * kfs[None]      # [T, kg, sg]
    tex = [(torch.clamp(rep(o_t[..., c])[:, None, :] + rep(d_t[..., c])[:, None, :] * z_s,
                        -bound, bound) + bound) * scale - 0.5
           for c in range(3)]
    uv = torch.stack([torch.stack([tex[0], tex[1]], dim=2),
                      torch.stack([tex[2], tex[1]], dim=2),
                      torch.stack([tex[2], tex[0]], dim=2)], dim=1)      # [T, 3, kg, 2, sg]
    uv = (uv + 0.5) / ms[..., None, None] - 0.5
    uv[..., 0, :] += mip_base[..., None].float()
    return scalars, uv, overflow


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


# ---- the plain version ----------------------------------------------------------

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


def shade_core_plain(x, dsamp, w: dict):
    """The NeRF head chain on per-sample features x [.., 3·CP] with per-sample
    direction rows dsamp [.., 64] (the JAX ``_shade_core``): every matmul's
    left operand is rounded to the weights' dtype, products accumulate in
    float32. Returns (σ logit [..], rgb logits [.., 3])."""
    dtype = w["wx_aud"].dtype
    f32 = torch.float32

    def mm(a, b):
        return torch.matmul(a.to(dtype).to(f32), b.to(f32))

    na, ns_, ne = w["wx_aud"].shape[1], w["wx_sig"].shape[1], w["wx_eye"].shape[1]
    hx = mm(x, torch.cat([w["wx_aud"], w["wx_sig"], w["wx_eye"]], dim=1))
    aud_h = torch.relu(hx[..., :na])
    h0 = hx[..., na:na + ns_]
    eye_h = torch.relu(hx[..., na + ns_:na + ns_ + ne])
    aud_ch = mm(aud_h, w["w_aud1"])
    h = h0 + mm(aud_ch, w["w_aud_sig"])
    eye_att = torch.sigmoid(mm(eye_h, w["w_eye1"][:, :1]))
    h = torch.relu(h + eye_att * w["w_sig_e"][0].to(f32))
    h = torch.relu(mm(h, w["w_sig1"]))
    sig = mm(h, w["w_sigcol"][:, :1])[..., 0]
    geo = mm(h, w["w_geo"])
    ch = mm(geo, w["w_col_g"]) + dsamp + w["col_bias"][0].to(f32)
    rgb = mm(torch.relu(ch), w["w_rgb"][:, 1:4])
    return sig, rgb


def sample_shade_comp_tiles_plain(planes_major, jobs, uv, dproj, dtv, weights: dict,
                                  spec: SamplerSpec, chunk: int = 128) -> torch.Tensor:
    """K2's function in PyTorch: see ``sample_shade_comp_tiles``."""
    t = uv.shape[0] // 3
    rpt, kg = spec.rays_per_tile, spec.kg
    ks = spec.sg // rpt
    jobs = jobs.reshape(t, 3, 1 + 2 * kg)
    uv = uv.reshape(t, 3, kg, 2, spec.sg)
    out = torch.zeros(t, rpt, 16, dtype=torch.float32, device=uv.device)
    for s in range(0, t, chunk):
        e = min(t, s + chunk)
        tc = e - s
        x = _tile_features(planes_major, jobs[s:e], uv[s:e], spec)
        dsamp = (dproj[s:e].float()[:, None, :, None, :]
                 .expand(tc, kg, rpt, ks, dproj.shape[-1]).reshape(tc, kg * spec.sg, -1))
        sig, rgb = shade_core_plain(x, dsamp, weights)
        # depth order per ray: group-major, then in-group sample
        sig = sig.reshape(tc, kg, rpt, ks).permute(0, 2, 1, 3).reshape(tc, rpt, kg * ks)
        rgb = rgb.reshape(tc, kg, rpt, ks, 3).permute(0, 2, 1, 3, 4).reshape(tc, rpt, kg * ks, 3)
        sd = torch.exp(sig) * dtv[s:e, :, :1]
        alpha = 1.0 - torch.exp(-sd)
        excl = torch.cat([torch.zeros_like(sd[..., :1]), torch.cumsum(sd[..., :-1], dim=-1)],
                         dim=-1)
        trans = torch.exp(-excl)
        wgt = torch.where(trans > 1e-4, alpha * trans, torch.zeros_like(trans))
        color = torch.sigmoid(rgb) * (1 + 2 * 0.001) - 0.001
        out[s:e, :, 0] = wgt.sum(dim=-1)
        out[s:e, :, 1:4] = (wgt[..., None] * color).sum(dim=-2)
    return out


# ---- the CUDA kernel ------------------------------------------------------------

def build() -> str:
    """Build (or find in the cache) the kernel library; returns its path."""
    from mere_fusion_tpu_torch.ops.attention import nvcc_path
    from mere_fusion_tpu_torch.runtime.build import build_shared

    return build_shared(
        "mf_sampler", [_SRC],
        [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"])


def load():
    """Build the kernel library if needed and bind it (once per process)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.mf_sample_shade_comp.argtypes = (
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * (5 + len(SHADE_WEIGHTS) + 1)
                + [ctypes.c_int] * 8 + [ctypes.c_void_p])
            lib.mf_sample_shade_comp.restype = ctypes.c_int
            _lib = lib
    return _lib


def smem_bytes(spec: SamplerSpec) -> int:
    """Dynamic shared memory of one block (see csrc/sampler.cu)."""
    weights = (3 * CP * (2 * HID + EYE_HID) + HID * AUD + AUD * HID + EYE_HID + HID
               + 3 * HID * HID + HID + 4 * HID + HID)
    samples = spec.kg * spec.sg
    return 4 * (weights + spec.rays_per_tile * HID + 4 * samples) + 4 * 64


def _check(planes_major, jobs, uv, dproj, dtv, weights, spec: SamplerSpec) -> int:
    """Raise on anything the kernel does not take; returns the tile count."""
    dev = planes_major.device
    t = uv.shape[0] // 3 if uv.dim() == 4 else -1
    rpt, kg = spec.rays_per_tile, spec.kg
    want = {
        "planes_major": (planes_major, torch.bfloat16, None),
        "jobs": (jobs, torch.int32, (t * 3 * (1 + 2 * kg),)),
        "uv": (uv, torch.float32, (3 * t, kg, 2, spec.sg)),
        "dproj": (dproj, None, (t, rpt, HID)),
        "dtv": (dtv, torch.float32, (t, rpt, 8)),
    }
    want.update({name: (weights[name], None, WEIGHT_SHAPES[name]) for name in SHADE_WEIGHTS})
    for name, (x, dtype, shape) in want.items():
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"K2 needs every operand on one CUDA device; {name} is on "
                             f"{x.device}, planes_major on {dev}")
        if dtype is not None and x.dtype != dtype:
            raise TypeError(f"K2 takes {name} as {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"K2 takes {name} of shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"K2 needs contiguous operands; {name} is not")
    wdt = weights["wx_aud"].dtype
    if wdt not in (torch.float32, torch.bfloat16) or any(
            x.dtype != wdt for x in [dproj, *(weights[n] for n in SHADE_WEIGHTS)]):
        raise TypeError("K2 takes dproj and all shade weights as one dtype, float32 "
                        "or bfloat16")
    if (planes_major.dim() != 3 or planes_major.shape[0] != 3
            or planes_major.shape[2] % CP or planes_major.shape[2] // CP < spec.wv
            or planes_major.shape[1] < spec.wu):
        raise ValueError(f"K2 takes planes_major [3, rows >= wu, R·{CP}], got "
                         f"{tuple(planes_major.shape)}")
    if spec.k % kg or t <= 0 or 3 * (1 + 2 * kg) > 64:
        raise ValueError(f"K2 needs k % kg == 0, kg <= 10 and at least one tile "
                         f"(k={spec.k}, kg={kg}, tiles={t})")
    if smem_bytes(spec) > SMEM_LIMIT:
        raise ValueError(f"K2 tile of {rpt} rays × {spec.k} samples needs "
                         f"{smem_bytes(spec)} B of shared memory > {SMEM_LIMIT}")
    return t


def sample_shade_comp_tiles_cuda(planes_major, jobs, uv, dproj, dtv, weights: dict,
                                 spec: SamplerSpec) -> torch.Tensor:
    """Launch K2 on the operands' device and PyTorch's current stream there."""
    global launches
    t = _check(planes_major, jobs, uv, dproj, dtv, weights, spec)
    out = torch.empty(t, spec.rays_per_tile, 16, dtype=torch.float32,
                      device=planes_major.device)
    lib = load()
    stream = torch.cuda.current_stream(planes_major.device).cuda_stream
    err = lib.mf_sample_shade_comp(
        planes_major.device.index, int(dproj.dtype == torch.bfloat16),
        planes_major.data_ptr(), jobs.data_ptr(), uv.data_ptr(), dproj.data_ptr(),
        dtv.data_ptr(), *[weights[n].data_ptr() for n in SHADE_WEIGHTS],
        out.data_ptr(), t, spec.rays_per_tile, spec.kg, spec.k // spec.kg,
        spec.wu, spec.wv, planes_major.shape[1], planes_major.shape[2] // CP,
        stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed with cudaError {err}")
    with _count_lock:
        launches += 1
    return out


def sample_shade_comp_tiles(planes_major, jobs, uv, dproj, dtv, weights: dict,
                            spec: SamplerSpec) -> torch.Tensor:
    """Fused sample + shade + composite over pixel tiles.

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
