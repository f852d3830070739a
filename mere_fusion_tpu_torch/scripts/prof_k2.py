"""Where K2's time goes with bf16 and with f32 weights: each kernel against
probes of itself, on the card.

    python -m mere_fusion_tpu_torch.scripts.prof_k2

Each probe is ``csrc/sampler.cu`` with ``csrc/sampler_core.cuh`` with one
part of the tensor-core kernel (``sample_shade_comp_wgmma_kernel``) taken
out or changed, built beside it (nvcc, one process each, in parallel) and
timed on the dense 512² job set (``chip_smoke.k2_operands``, bf16 weights)
by CUDA events, in turns with the kernel (kernel, probes, probes reversed,
kernel). A probe that takes a part out no longer computes K2: only its time
is read. The design probes compute the same function with another order of
sums; their largest errors against the plain version are printed beside
the kernel's.

- ``fetch_only``: no head (the fetch writes its x tiles, nothing reads
  them; the composite folds stale logits);
- ``head_only``: no fetch (each sample's features are made from its index,
  no texel is read);
- ``no_composite``: no composite (nothing is written to the output);
- ``no_settle`` (design): no value near a bf16 rounding tie summed again in
  the plain version's order (``settle``), so the tensor cores' sums round
  as they fall;
- ``promoted`` (design): each layer's k16 steps from a zeroed accumulator,
  the partial sums added in f32, instead of one tensor-core accumulator;
- ``tie_half`` (design): values settled only within 2^-22 (not 2^-21) of
  their row's largest magnitude from a tie;
- ``tie_floor`` (design): values under 1/64 of their row's largest
  magnitude not settled;
- ``two_warpgroups`` (design): two warpgroups a block instead of three;
- ``f32_cvt_rna``, ``f32_lo_rna``, ``f32_one_tile``, ``f32_single`` (the
  f32 kernel, ``sample_shade_comp_tf32_kernel``, timed and checked on the
  same job set with f32 weights, in turns with it): both halves of each
  TF32 split by ``cvt.rna.tf32.f32``; a_lo rounded too (by the integer
  rounding a_hi takes); one m16 row tile a warp at 16 warps a block; one
  TF32 product a term (a_hi b_hi; no longer f32-accurate);
- ``dump`` (diagnostic, not timed): the kernel writing every hidden layer's
  f32 values before their bf16 rounding (after ``settle``) for the samples
  of the first DUMP_TILES tiles. Each layer is recomputed by the plain arithmetic from
  the kernel's own rounded inputs (torch.matmul in f32, TF32 off) and
  compared: the largest difference before rounding, relative to the
  layer's largest value, and the count of values whose bf16 rounding
  differs ("flips").

Prints one JSON line per measurement, the card's name and power limit, and
a JSON summary as the last line. Raises without CUDA.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# the composite of each tile's rays, in the tensor-core kernel
COMPOSITE = """    for (int r = tid; r < rpt; r += HEAD_THREADS)
      composite_ray(s_res, r, kg, ks, sg, dtv[((size_t)t * rpt + r) * 8],
                    out + ((size_t)t * rpt + r) * 16);
"""
HEADS = "      head_rows(base, x_wg, s_dp, s_res, n0, ns, sg, ks);\n"
FETCH = ("        sample_uv<1>(planes, s_jobs, uv, t, g, n - g * sg, kg, sg, umax, vmax, rows, rv, "
         "x, h);\n")
SYNTH_X = """#pragma unroll
        for (int k = 0; k < 24; ++k) x[k] = 0.01f * (float)((k + n + 5 * h) % 13) - 0.06f;
"""
SETTLE = """  const int most = (int)__reduce_max_sync(0xffffffffu, (unsigned)__popc(rest));
  if (most == 0) return;
"""
TIE = "constexpr float TIE = 4.76837158203125e-07f;   // 2^-21\n"
NEAR = "  return fabsf(v) > thr && fabsf(v - mid) <= thr;\n"
CHAIN = """template <int STEPS, int N, typename Start>
__device__ __forceinline__ void chain(float (&acc)[N], Start start) {
  wgmma_fence();
  start_steps<0, STEPS>(acc, start);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}
"""
# each k16 step from a zeroed accumulator, the partial sums added in f32 in
# order; two temporaries alternate so that step s + 1 runs while s is added
PROMOTED = """template <int S, int STEPS, int N, typename Start>
__device__ __forceinline__ void chain_step(float (&acc)[N], float (&t)[2][N], Start& start) {
  if constexpr (S + 1 < STEPS) {
    wgmma_fence();
    start(t[(S + 1) % 2], Step<S + 1>(), 0);
    wgmma_commit();
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  fence_regs(t[S % 2]);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = S == 0 ? t[S % 2][i] : __fadd_rn(acc[i], t[S % 2][i]);
  if constexpr (S + 1 < STEPS) chain_step<S + 1, STEPS>(acc, t, start);
}

template <int STEPS, int N, typename Start>
__device__ __forceinline__ void chain(float (&acc)[N], Start start) {
  float t[2][N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[0][i] = t[1][i] = 0.f;
  wgmma_fence();
  start(t[0], Step<0>(), 0);
  wgmma_commit();
  chain_step<0, STEPS>(acc, t, start);
}
"""

DUMP_TILES = 4
DUMP_WIDTH = 353   # aud 64, eye logit 1, aud_ch 32, h 64, h2 64, geo 64, colour 64
DUMP_LAYERS = {"aud": (0, 64), "eye": (64, 65), "aud_ch": (65, 97), "h": (97, 161),
               "h2": (161, 225), "geo": (225, 289), "colour": (289, 353)}
DUMP_HELPERS = """__device__ float* g_dump = nullptr;
constexpr int DUMP_TILES = %d, DUMP_WIDTH = %d;

__device__ __forceinline__ void dump_acc(int tile, int n0, int ns, int r, int t, int off,
                                         const float* v, int nregs) {
  if (g_dump == nullptr || tile >= DUMP_TILES) return;
  for (int i = 0; i < nregs; ++i) {
    const int n = n0 + r + ((i & 2) ? 8 : 0);
    if (n < ns)
      g_dump[((size_t)tile * ns + n) * DUMP_WIDTH + off + 8 * (i / 4) + 2 * t + (i & 1)] = v[i];
  }
}

// The head on the row block""" % (DUMP_TILES, DUMP_WIDTH)
DUMP_EDITS = [
    ("sampler_core.cuh", "// The head on the row block", DUMP_HELPERS),
    ("sampler_core.cuh", """float4* __restrict__ res, int n0, int ns, int sg,
                                          int ks) {""", """float4* __restrict__ res, int n0, int ns, int sg,
                                          int ks, int tile) {"""),
    ("sampler_core.cuh", "  uint32_t a[4][4];\n",
     "  dump_acc(tile, n0, ns, r, t, 0, acc, 32);\n  uint32_t a[4][4];\n"),
    ("sampler_core.cuh", "  const float eye0 = 1.f / (1.f + expf(-e0));\n", """  if (g_dump != nullptr && tile < DUMP_TILES && t == 0) {
    if (n0 + r < ns) g_dump[((size_t)tile * ns + n0 + r) * DUMP_WIDTH + 64] = e0;
    if (n0 + r + 8 < ns) g_dump[((size_t)tile * ns + n0 + r + 8) * DUMP_WIDTH + 64] = e1;
  }
  const float eye0 = 1.f / (1.f + expf(-e0));
"""),
    ("sampler_core.cuh", "  uint32_t ach[2][4];\n",
     "  dump_acc(tile, n0, ns, r, t, 65, accc, 16);\n  uint32_t ach[2][4];\n"),
    ("sampler_core.cuh", """                  dot_seq<AUD>(sc, lrow(i), base + H_AUDSIG, col(i)), i);
  });
""", """                  dot_seq<AUD>(sc, lrow(i), base + H_AUDSIG, col(i)), i);
  });
  dump_acc(tile, n0, ns, r, t, 97, acc, 32);
"""),
    ("sampler_core.cuh", "  float s0 = 0.f, s1 = 0.f;\n",
     "  dump_acc(tile, n0, ns, r, t, 161, acc, 32);\n  float s0 = 0.f, s1 = 0.f;\n"),
    ("sampler_core.cuh",
     "         [&](int i) { return dot_seq<HID>(sc, lrow(i), base + H_GEO, col(i)); });\n",
     "         [&](int i) { return dot_seq<HID>(sc, lrow(i), base + H_GEO, col(i)); });\n"
     "  dump_acc(tile, n0, ns, r, t, 225, acc, 32);\n"),
    ("sampler_core.cuh", "  float c0[2] = {0.f, 0.f}, c1[2] = {0.f, 0.f}, c2[2] = {0.f, 0.f};\n",
     "  dump_acc(tile, n0, ns, r, t, 289, acc, 32);\n"
     "  float c0[2] = {0.f, 0.f}, c1[2] = {0.f, 0.f}, c2[2] = {0.f, 0.f};\n"),
    ("sampler.cu", HEADS, HEADS.replace("sg, ks);", "sg, ks, t);")),
    ("sampler.cu", "// K2d: uv as K2's; out [tiles, kg, rpt * ks, 48] bf16.", """extern "C" int mf_probe_set_dump(void* p) {
  return (int)cudaMemcpyToSymbol(g_dump, &p, sizeof(p));
}

// K2d: uv as K2's; out [tiles, kg, rpt * ks, 48] bf16."""),
]

# probe name -> [(file, text in it, its replacement), ...]
PROBES = {
    "fetch_only": [("sampler.cu", HEADS, "")],
    "head_only": [("sampler.cu", FETCH, SYNTH_X)],
    "no_composite": [("sampler.cu", COMPOSITE, "")],
    "no_settle": [("sampler_core.cuh", SETTLE, "  const int most = 0;\n  return;\n")],
    "promoted": [("sampler_core.cuh", CHAIN, PROMOTED)],
    "tie_half": [("sampler_core.cuh", TIE, TIE.replace("4.76837158203125e-07f;   // 2^-21",
                                                       "2.384185791015625e-07f;  // 2^-22"))],
    "tie_floor": [("sampler_core.cuh", NEAR, NEAR.replace("fabsf(v) > thr", "fabsf(v) > 32768.f * thr"))],
    "two_warpgroups": [("sampler_core.cuh", "constexpr int HEAD_WGS = 3;",
                        "constexpr int HEAD_WGS = 2;")],
    "dump": DUMP_EDITS,
}
SPLIT = """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
"""
MMA3 = """        mma_tf32(acc[m][j], al[m], bh0, bh1);
        mma_tf32(acc[m][j], ah[m], bl0, bl1);
        mma_tf32(acc[m][j], ah[m], bh0, bh1);
"""
F32_PROBES = {
    "f32_cvt_rna": [("sampler_core.cuh", SPLIT, """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
""")],
    "f32_lo_rna": [("sampler_core.cuh", SPLIT, SPLIT.replace(
        "lo = __float_as_uint(x - __uint_as_float(hi));",
        "lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;"))],
    "f32_one_tile": [("sampler_core.cuh", "constexpr int TF_WARPS = 8;",
                      "constexpr int TF_WARPS = 16;"),
                     ("sampler_core.cuh", "constexpr int TF_MT = 2;", "constexpr int TF_MT = 1;")],
    "f32_single": [("sampler_core.cuh", MMA3, "        mma_tf32(acc[m][j], ah[m], bh0, bh1);\n")],
}
PROBES.update(F32_PROBES)
TIMED_PROBES = ("fetch_only", "head_only", "no_composite", "no_settle", "promoted", "tie_half",
                "tie_floor", "two_warpgroups")
DESIGN_PROBES = ("no_settle", "promoted", "tie_half", "tie_floor")


def build_all(out_dir: str) -> dict[str, str]:
    """The kernel's library and one per probe; returns name -> path."""
    from mere_fusion_tpu_torch.ops import sampler
    from mere_fusion_tpu_torch.ops.attention import nvcc_path
    from mere_fusion_tpu_torch.runtime.build import build_shared

    originals = {}
    for name, path in (("sampler.cu", sampler._SRC), ("sampler_core.cuh", sampler.CORE_HEADER)):
        with open(path) as f:
            originals[name] = f.read()
    sources = {"kernel": (sampler._SRC, sampler.CORE_HEADER)}
    for probe, edits in PROBES.items():
        texts = dict(originals)
        for file, old, new in edits:
            if texts[file].count(old) != 1:
                raise RuntimeError(f"probe {probe}: its text is not in csrc/{file} once")
            texts[file] = texts[file].replace(old, new)
        d = os.path.join(out_dir, probe)
        os.makedirs(d, exist_ok=True)
        for file, text in texts.items():
            with open(os.path.join(d, file), "w") as f:
                f.write(text)
        sources[probe] = (os.path.join(d, "sampler.cu"), os.path.join(d, "sampler_core.cuh"))
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC"]
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = pool.map(lambda item: build_shared(f"k2_{item[0]}", [item[1][0]], cmd,
                                                   headers=(item[1][1],)),
                         sources.items())
    return dict(zip(sources, paths))


def layer_flips(dump, planes, jobs, uv, dproj, weights, spec) -> dict:
    """Each hidden layer of the dumped tiles recomputed by the plain
    arithmetic from the kernel's own rounded inputs: per layer the values
    compared, the largest difference before rounding relative to the
    layer's largest value, and the values whose bf16 rounding differs."""
    import torch

    from mere_fusion_tpu_torch.ops import sampler

    t = dump.shape[0]
    kg = spec.kg
    x = sampler._tile_features(planes, jobs.reshape(-1, 3, 1 + 2 * kg)[:t],
                               uv.reshape(-1, 3, kg, 2, spec.sg)[:t], spec)
    dsamp = sampler._sample_rows(dproj[:t], spec)
    w = {k: v.float() for k, v in weights.items()}
    rb = lambda v: v.to(torch.bfloat16).float()
    k = {name: dump[..., a:b] for name, (a, b) in DUMP_LAYERS.items()}
    xr = rb(x)
    ref = {
        "aud": torch.relu(xr @ w["wx_aud"]),
        "eye": (rb(torch.relu(xr @ w["wx_eye"])) @ w["w_eye1"][:, :1]),
        "aud_ch": rb(torch.relu(k["aud"])) @ w["w_aud1"],
        "h": torch.relu((xr @ w["wx_sig"] + rb(k["aud_ch"]) @ w["w_aud_sig"])
                        + torch.sigmoid(k["eye"]) * w["w_sig_e"][0]),
        "h2": torch.relu(rb(k["h"]) @ w["w_sig1"]),
        "geo": rb(k["h2"]) @ w["w_geo"],
        "colour": torch.relu(rb(k["geo"]) @ w["w_col_g"] + dsamp + w["col_bias"][0]),
    }
    out = {}
    for name, r in ref.items():
        got = k[name]
        out[name] = {
            "values": got.numel(),
            "max_rel_diff": ((got - r).abs().max() / r.abs().max().clamp_min(1e-30)).item(),
            "flips": int((rb(got) != rb(r)).sum().item()) if name != "eye" else None}
    return out


def main() -> int:
    import torch

    from mere_fusion_tpu_torch.ops import sampler
    from mere_fusion_tpu_torch.runtime.build import BUILD_DIR
    from mere_fusion_tpu_torch.scripts.k1_turns import _chip_smoke

    if not torch.cuda.is_available():
        raise RuntimeError("prof_k2 measures on a CUDA card; none is visible")
    cs = _chip_smoke()
    libs = {}
    for name, path in build_all(os.path.join(BUILD_DIR, "prof_k2")).items():
        lib = ctypes.CDLL(path)
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.mf_sample_shade_comp.argtypes = [i, i, p, p, p, p, p, *sampler._WEIGHTS, p,
                                             *sampler._GEOMETRY, p]
        lib.mf_sample_shade_comp.restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda", 0)
    spec = cs.k2_spec()
    planes, jobs, uv, dproj, dtv, weights = cs.k2_operands(dev, cs.NERF_HW, spec,
                                                            torch.bfloat16)
    t = uv.shape[0] // 3
    out = torch.empty(t, spec.rays_per_tile, 16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        err = lib.mf_sample_shade_comp(
            0, 1, planes.data_ptr(), jobs.data_ptr(), uv.data_ptr(), dproj.data_ptr(),
            dtv.data_ptr(), *[weights[n].data_ptr() for n in sampler.SHADE_WEIGHTS],
            out.data_ptr(), *sampler._geometry(spec, t, planes), stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")

    order = ["kernel", *TIMED_PROBES, *reversed(TIMED_PROBES), "kernel"]
    times: dict[str, list[float]] = {}
    for name in order:
        ms = cs.time_ms(lambda: launch(libs[name]), iters=10, warmup=2)
        times.setdefault(name, []).append(ms)
        print(json.dumps({"variant": name, "ms": ms}), flush=True)
    ref = sampler.sample_shade_comp_tiles_plain(planes, jobs, uv, dproj, dtv, weights, spec)
    errors = {}
    for name in ("kernel", *DESIGN_PROBES):
        launch(libs[name])
        errors[name] = (out - ref).abs().max().item()
        print(json.dumps({"variant": name, "max_abs_err": errors[name]}), flush=True)
    lib = libs["dump"]
    lib.mf_probe_set_dump.argtypes = [ctypes.c_void_p]
    ns = spec.kg * spec.sg
    buf = torch.zeros(DUMP_TILES * ns * DUMP_WIDTH, device=dev)
    if lib.mf_probe_set_dump(buf.data_ptr()):
        raise RuntimeError("setting the dump buffer failed")
    launch(lib)
    torch.cuda.synchronize()
    flips = layer_flips(buf.view(DUMP_TILES, ns, DUMP_WIDTH), planes, jobs, uv, dproj, weights,
                        spec)
    for name, row in flips.items():
        print(json.dumps({"layer": name, **row}), flush=True)
    # the f32 kernel and its probes, f32 weights (TF32 off in the plain version)
    torch.backends.cuda.matmul.allow_tf32 = False
    planes, jobs, uv, dproj, dtv, weights = cs.k2_operands(dev, cs.NERF_HW, spec,
                                                            torch.float32)

    def launch_f32(lib):
        err = lib.mf_sample_shade_comp(
            0, 0, planes.data_ptr(), jobs.data_ptr(), uv.data_ptr(), dproj.data_ptr(),
            dtv.data_ptr(), *[weights[n].data_ptr() for n in sampler.SHADE_WEIGHTS],
            out.data_ptr(), *sampler._geometry(spec, t, planes), stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")

    f32_times: dict[str, list[float]] = {}
    for name in ["kernel", *F32_PROBES, *reversed(list(F32_PROBES)), "kernel"]:
        ms = cs.time_ms(lambda: launch_f32(libs[name]), iters=10, warmup=2)
        f32_times.setdefault(name, []).append(ms)
        print(json.dumps({"variant": name, "weights": "float32", "ms": ms}), flush=True)
    ref = sampler.sample_shade_comp_tiles_plain(planes, jobs, uv, dproj, dtv, weights, spec)
    f32_errors = {}
    for name in ("kernel", *F32_PROBES):
        launch_f32(libs[name])
        f32_errors[name] = (out - ref).abs().max().item()
        print(json.dumps({"variant": name, "weights": "float32",
                          "max_abs_err": f32_errors[name]}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"card": card, "tiles": t, "samples": t * spec.rays_per_tile * spec.k,
                      "ms": times, "max_abs_err": errors, "flips": flips,
                      "f32_ms": f32_times, "f32_max_abs_err": f32_errors}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
