"""S1 and S2: K2's stages alone, to see where K2's time goes.

Port of the two Pallas TPU kernels of scripts/prof_r5m.py, replicas of K2
(``ops.sampler.sample_shade_comp_tiles``) cut down to a stage, on K2's
operands (``ops.sampler``'s layouts and ``SamplerSpec``):

- **S1** ``m1_only`` (``m1_only`` :40): per tile, sample s of a depth
  group, plane q and group g, the bf16 u tent of s over its job's window
  rows (``clip(u − ou, 0, wu − 1.001)``, tents ``max(0, 1 − |r − u'|)``
  rounded to bf16) times the window's first 128 lanes (v columns ov … ov+7
  × 16 channels: no v interpolation), accumulated in float32. ``blockdiag``
  False sums over planes then groups into [T, sg, 128]; True sums over
  planes only into [T, kg·sg, 128], with the reference's block-diagonal
  tent ``1 − |col − (u' + g·wu)|`` over absolute columns.
- **S2** ``sections`` (``sections`` :153), mode ``win``, ``shade`` or
  ``full``: K2 stopped after its fetch, its head or its composite. ``win``:
  [T, rpt, 16], out[r, c] = Σ over row blocks b and planes q of the
  samples' features x[b·rpt + r, q·16 + c] (rows in (group, ray, sample)
  order); ``shade``: rows r < rpt of σ_p + rgb_p, all 16 lanes, σ_p = h·
  w_sigcol and rgb_p = relu(ch)·w_rgb (every column of both); ``full``:
  K2's output, which is K2 itself (``ops.sampler.sample_shade_comp_tiles``,
  counted in ``sampler.launches``).

Each has ``<name>_plain`` (PyTorch, the CPU path and the yardstick),
``<name>_cuda`` (the hand-written CUDA C++ kernels of
``csrc/sampler_stages.cu``, built with nvcc for sm_90a on first use and
bound with ctypes; S2's ``win`` and ``shade`` are K2's kernel cut short,
made of the device code of ``csrc/sampler_core.cuh``) and the wrapper
``<name>``: CPU tensors take the plain version, CUDA tensors the kernel,
which raises on anything it does not take. ``m1_launches`` (S1) and
``section_launches`` (S2's ``win`` and ``shade``) count the kernels'
launches in this process.
"""
from __future__ import annotations

import ctypes
import os
import sys
import threading

import torch

from mere_fusion_tpu_torch.ops import sampler
from mere_fusion_tpu_torch.ops.sampler import CP, HID, SHADE_WEIGHTS, THREADS, SamplerSpec

LANES = 128                                # the lanes S1 keeps of each window row
SECTION_MODES = ("win", "shade", "full")   # S2's kernel takes the first two by number

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "sampler_stages.cu")

m1_launches = 0         # S1
section_launches = 0    # S2 win and shade
_lib = None
_lib_lock = threading.Lock()


# ---- the plain versions ---------------------------------------------------------

def m1_only_plain(planes_major, jobs, uv, spec: SamplerSpec, blockdiag: bool = False,
                  chunk: int = 16) -> torch.Tensor:
    """S1's function in PyTorch: see ``m1_only``."""
    t, kg, sg, wu = uv.shape[0] // 3, spec.kg, spec.sg, spec.wu
    jobs = jobs.reshape(t, 3, 1 + 2 * kg)
    uv = uv.reshape(t, 3, kg, 2, sg)
    _, m, width = planes_major.shape
    flat = planes_major.reshape(3 * m, width)
    lanes = torch.arange(LANES, device=uv.device)
    shift = torch.arange(kg, device=uv.device) * wu if blockdiag else torch.zeros(
        kg, dtype=torch.long, device=uv.device)
    out = torch.empty(t, kg * sg if blockdiag else sg, LANES, dtype=torch.float32,
                      device=uv.device)
    for s in range(0, t, chunk):
        e = min(t, s + chunk)
        p = jobs[s:e, :, 0].long()[..., None, None]               # [Tc, 3, 1, 1]
        ou = jobs[s:e, :, 1::2].long()                             # [Tc, 3, kg]
        ov = jobs[s:e, :, 2::2].long()
        uc = torch.clamp(uv[s:e, :, :, 0] - ou[..., None].float(), 0.0, wu - 1.001)
        if blockdiag:    # the block-diagonal tent's column, rounded as the reference's
            uc = uc + shift.float()[:, None]
        fi = torch.floor(uc)
        w0 = torch.clamp(1.0 - (fi - uc).abs(), min=0.0).to(torch.bfloat16).float()
        w1 = torch.clamp(1.0 - (fi + 1.0 - uc).abs(), min=0.0).to(torch.bfloat16).float()
        row = p * m + ou[..., None] + fi.long() - shift[:, None]   # [Tc, 3, kg, sg]
        col = (ov * CP)[..., None, None] + lanes                   # [Tc, 3, kg, 1, 128]
        m1 = (w0[..., None] * flat[row[..., None], col].float()
              + w1[..., None] * flat[row[..., None] + 1, col].float())   # [Tc, 3, kg, sg, 128]
        if blockdiag:
            acc = torch.zeros_like(m1[:, 0])
            for q in range(3):
                acc = acc + m1[:, q]
            out[s:e] = acc.reshape(e - s, kg * sg, LANES)
        else:
            acc = torch.zeros_like(m1[:, 0, 0])
            for q in range(3):
                for g in range(kg):
                    acc = acc + m1[:, q, g]
            out[s:e] = acc
    return out


def sections_plain(planes_major, jobs, uv, dproj, dtv, weights: dict, spec: SamplerSpec,
                   mode: str, chunk: int = 128) -> torch.Tensor:
    """S2's function in PyTorch: see ``sections``."""
    if mode not in SECTION_MODES:
        raise ValueError(f"section mode {mode!r} is not one of {SECTION_MODES}")
    if mode == "full":
        return sampler.sample_shade_comp_tiles_plain(planes_major, jobs, uv, dproj, dtv,
                                                     weights, spec, chunk)
    t, rpt = uv.shape[0] // 3, spec.rays_per_tile
    jobs = jobs.reshape(t, 3, 1 + 2 * spec.kg)
    uv = uv.reshape(t, 3, spec.kg, 2, spec.sg)
    out = torch.empty(t, rpt, 16, dtype=torch.float32, device=uv.device)
    dtype = weights["wx_aud"].dtype
    for s in range(0, t, chunk):
        e = min(t, s + chunk)
        x = sampler._tile_features(planes_major, jobs[s:e], uv[s:e], spec)   # [Tc, ns, 48]
        if mode == "win":       # every row block and lane block, in the reference's order
            acc = torch.zeros(e - s, rpt, 16, dtype=torch.float32, device=uv.device)
            for r0 in range(0, x.shape[1], rpt):
                for l0 in range(0, x.shape[2], 16):
                    acc = acc + x[:, r0:r0 + rpt, l0:l0 + 16]
            out[s:e] = acc
        else:
            dsamp = sampler._sample_rows(dproj[s:e], spec)[:, :rpt]
            h, rch = sampler.head_hidden(x[:, :rpt], dsamp, weights)
            out[s:e] = (sampler._mm(h, weights["w_sigcol"], dtype)
                        + sampler._mm(rch, weights["w_rgb"], dtype))
    return out


# ---- the CUDA kernels -----------------------------------------------------------

def build() -> str:
    """Build (or find in the cache) the kernel library; returns its path."""
    from mere_fusion_tpu_torch.ops.attention import nvcc_path
    from mere_fusion_tpu_torch.runtime.build import build_shared

    return build_shared(
        "mf_sampler_stages", [_SRC],
        [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"],
        headers=(sampler.CORE_HEADER,))


def load():
    """Build the kernel library if needed and bind it (once per process)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            geometry = [i] * 8                     # tiles, rpt, kg, ks, wu, wv, rows, rv
            # device, blockdiag, planes, jobs, uv, out, geometry, stream
            lib.mf_m1_only.argtypes = [i, i, p, p, p, p, *geometry, p]
            # device, stage, bf16, planes, jobs, uv, dproj, dtv, weights, out, geometry, stream
            lib.mf_sections.argtypes = [i, i, i, p, p, p, p, p, *[p] * len(SHADE_WEIGHTS), p,
                                        *geometry, p]
            lib.mf_m1_only.restype = lib.mf_sections.restype = ctypes.c_int
            _lib = lib
    return _lib


def smem_bytes(spec: SamplerSpec, mode: str) -> int:
    """Dynamic shared memory of one S2 block: K2's (``ops.sampler.smem_bytes``)
    but that its per-sample area of kg·sg float4 holds at least, in ``win``,
    a [16] partial sum per thread and, in ``shade``, a float4 per thread and
    the full w_sigcol and w_rgb as float32 (csrc/sampler_stages.cu,
    ``stage_res_rows``)."""
    ns = spec.kg * spec.sg
    need = {"win": THREADS * CP // 4, "shade": THREADS + 2 * HID * CP // 4}[mode]
    return sampler.smem_bytes(spec, "K2") + 16 * max(0, need - ns)


def m1_only_cuda(planes_major, jobs, uv, spec: SamplerSpec, blockdiag: bool = False):
    """Launch S1 on the operands' device and PyTorch's current stream there."""
    t, kg = sampler._tiles(uv, 3), spec.kg
    sampler._check("S1", spec, planes_major, {
        "jobs": (jobs, torch.int32, (t * 3 * (1 + 2 * kg),)),
        "uv": (uv, torch.float32, (3 * t, kg, 2, spec.sg))})
    if spec.wv * CP < LANES:
        raise ValueError(f"S1 keeps {LANES} lanes of each window row: wv·{CP} must be at "
                         f"least {LANES} (wv={spec.wv})")
    dev = planes_major.device
    out = torch.empty(t, kg * spec.sg if blockdiag else spec.sg, LANES, dtype=torch.float32,
                      device=dev)
    err = load().mf_m1_only(dev.index, int(blockdiag), planes_major.data_ptr(), jobs.data_ptr(),
                            uv.data_ptr(), out.data_ptr(),
                            *sampler._geometry(spec, t, planes_major), sampler._stream(dev))
    sampler._launched(err, "S1", "m1_launches", sys.modules[__name__])
    return out


def m1_only(planes_major, jobs, uv, spec: SamplerSpec, blockdiag: bool = False):
    """S1: K2's u interpolation alone (no v tent, no head).

    planes_major, jobs and uv as K2's (``ops.sampler.sample_shade_comp_tiles``;
    wv·16 ≥ 128). Returns float32 [T, sg, 128], or with ``blockdiag`` [T,
    kg·sg, 128] (see the module docstring). CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if planes_major.device.type == "cpu":
        return m1_only_plain(planes_major, jobs, uv, spec, blockdiag)
    return m1_only_cuda(planes_major, jobs, uv, spec, blockdiag)


def sections_cuda(planes_major, jobs, uv, dproj, dtv, weights: dict, spec: SamplerSpec,
                  mode: str):
    """Launch S2 at ``mode`` on the operands' device and PyTorch's current
    stream there: ``full`` is K2's launch."""
    if mode not in SECTION_MODES:
        raise ValueError(f"section mode {mode!r} is not one of {SECTION_MODES}")
    if mode == "full":
        return sampler.sample_shade_comp_tiles_cuda(planes_major, jobs, uv, dproj, dtv, weights,
                                                    spec)
    t, rpt, kg = sampler._tiles(uv, 3), spec.rays_per_tile, spec.kg
    sampler._check("S2", spec, planes_major, {
        "jobs": (jobs, torch.int32, (t * 3 * (1 + 2 * kg),)),
        "uv": (uv, torch.float32, (3 * t, kg, 2, spec.sg)),
        "dproj": (dproj, None, (t, rpt, HID)),
        "dtv": (dtv, torch.float32, (t, rpt, 8))}, weights)
    if mode == "win" and THREADS % rpt:
        raise ValueError(f"S2 win needs {THREADS} % rays per tile == 0 (rpt={rpt})")
    if smem_bytes(spec, mode) > sampler.SMEM_LIMIT:
        raise ValueError(f"S2 {mode}: a tile of {rpt} rays × {spec.k} samples needs "
                         f"{smem_bytes(spec, mode)} B of shared memory > {sampler.SMEM_LIMIT}")
    dev = planes_major.device
    out = torch.empty(t, rpt, 16, dtype=torch.float32, device=dev)
    err = load().mf_sections(
        dev.index, SECTION_MODES.index(mode), int(dproj.dtype == torch.bfloat16),
        planes_major.data_ptr(), jobs.data_ptr(), uv.data_ptr(), dproj.data_ptr(),
        dtv.data_ptr(), *[weights[n].data_ptr() for n in SHADE_WEIGHTS], out.data_ptr(),
        *sampler._geometry(spec, t, planes_major), sampler._stream(dev))
    sampler._launched(err, f"S2 {mode}", "section_launches", sys.modules[__name__])
    return out


def sections(planes_major, jobs, uv, dproj, dtv, weights: dict, spec: SamplerSpec,
             mode: str):
    """S2: K2 stopped after a stage.

    Operands as K2's (``ops.sampler.sample_shade_comp_tiles``: dproj [T,
    rpt, 64], dtv [T, rpt, 8] with dt in lane 0, the 13 shade weights;
    dproj and the weights one dtype, float32 or bfloat16, for the kernel).
    ``mode`` "win", "shade" or "full" (see the module docstring); returns
    float32 [T, rpt, 16]. CPU tensors take the plain version, CUDA tensors
    the kernel."""
    if planes_major.device.type == "cpu":
        return sections_plain(planes_major, jobs, uv, dproj, dtv, weights, spec, mode)
    return sections_cuda(planes_major, jobs, uv, dproj, dtv, weights, spec, mode)
