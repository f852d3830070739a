"""Where the fetch-only kernels, S1 (``m1_only``) and K2d (``sample_tiles``),
spend their time, on the card: each kernel against probes of itself.

    python -m mere_fusion_tpu_torch.scripts.prof_fetch [ROOT ...]

Each ROOT is the root of a checkout (default: this one). Its
csrc/sampler_stages.cu (S1) and csrc/sampler.cu (K2d, with
csrc/sampler_core.cuh) are copied, edited and built into this checkout's
build directory, so one run can probe two designs in turns (e.g. ``git
archive`` of a parent unpacked into a gitignored directory, then ``.``).
Every build leaves out K2's and S2's launchers (a text edit too), so that
nvcc compiles S1 or K2d alone. The operands are ``chip_smoke``'s: S1 on the
profiling operands (``prof_r5k.make_inputs``, 2048 tiles of 16×8 rays, k 16,
kg 4, wu 64, wv 32), both modes; K2d on the dense 512² job set
(``chip_smoke.k2_operands``). Each variant is timed by CUDA events
(``chip_smoke.time_ms``) in turns (the list, then reversed), beside the
kernel's bound (``chip_smoke.stage_bound_ms``, ``family_bound_ms``).

Probes, by the design a checkout holds, each from text edits (each edit's
text must be in its file as often as the probe says):

- the first design (S1 one warp per output row, K2d one thread per sample):
  S1 ``no_texels`` (the texel loads replaced by a constant), ``no_stores``
  (the row's sum folded into one store per warp), ``unrolled`` (design: all
  3·kg steps' loads of a row issued before the first add; kg ≤ 4); K2d
  ``no_gathers`` (each texel load replaced by a constant), ``no_stores``
  (a store only of a value no sample makes);
- the resident-grid design (cp.async-staged coordinates, S1's loads of a
  row issued before its sums, K2d one thread per 16-byte chunk): S1
  ``no_texels``, ``no_stores``; K2d ``no_gathers``, ``no_stores``; for
  both ``wb_stores`` (design: write-back stores in place of the evict-first
  ``__stcs``); S1 ``no_sums`` (each lane's texel words folded by xor in
  place of the unpacking, products and sums) and ``u_global`` (design: u
  read through L1 where the records are made, not staged, so that the
  block's shared memory is 9 KB and L1 the rest); and the block's shape
  (designs; the kernel's S1 is one block of 1,024 threads an SM, each lane
  issuing 4 steps' loads at once, K2d two blocks of 512): S1 ``threads_512``
  (12 steps), ``threads_768`` (6), ``two_blocks`` (two blocks of 512, 4);
  K2d ``three_blocks``.

The kernel and every design probe are checked bit-equal to the plain
version before they are timed. Prints one JSON line per measurement, the
card's name and power limit, and a JSON summary (times by variant, bounds,
ptxas's registers and spills) as the last line. Raises without CUDA.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.join("mere_fusion_tpu_torch", "csrc")
# K2's and S2's launchers, left out of every build (their kernels are K2's)
STRIP = {"sampler.cu": ("// K2: uv [3 tiles, kg, 2, rpt * ks] f32;", "// K2d: uv as K2's;"),
         "sampler_stages.cu": ("// S2: stage 0 win, 1 shade;", None)}
FOLD = ("{{\n  float f = (acc[0] + acc[1]) + (acc[2] + acc[3]);\n"
        "  for (int o = 16; o; o >>= 1) f += __shfl_xor_sync(0xffffffffu, f, o);\n"
        "  if (lane == 0) {dst} = f;\n  }}\n")
ONE = "0x3f803f80u"   # two bf16 ones
GATHERS = ("    t00[k] = __ldg(a + k);\n    t01[k] = __ldg(a + 2 + k);\n"
           "    t10[k] = __ldg(b + k);\n    t11[k] = __ldg(b + 2 + k);\n")
NO_GATHERS = (f"    t00[k] = make_uint4((uint32_t)(size_t)(a + k), {ONE}, {ONE}, {ONE});\n"
              "    t01[k] = t00[k];\n"
              f"    t10[k] = make_uint4((uint32_t)(size_t)(b + k), {ONE}, {ONE}, {ONE});\n"
              "    t11[k] = t10[k];\n")
NEVER = "if ((w[0] & w[1] & w[2] & w[3]) == 0xffffffffu) "   # bf16 NaN pairs: no sample makes one

# ---- the first design --------------------------------------------------------
FIRST_S1 = "  constexpr int WARPS = THREADS / 32;"
FIRST_K2D = "// K2d: one thread per sample; its 48 features as bf16."
FIRST_LOOP = ("  float acc[4] = {0.f, 0.f, 0.f, 0.f};\n  for (int q = 0; q < 3; ++q) {",
              "  reinterpret_cast<float4*>(out + wid * 128)[lane]")
FIRST_STORE = ("  reinterpret_cast<float4*>(out + wid * 128)[lane] = "
               "make_float4(acc[0], acc[1], acc[2], acc[3]);\n")
UNROLLED = """  const int n = 3 * (g1 - g0);   // steps, q outer; at most 12 (kg <= 4)
  float w0[12], w1[12];
  uint2 v0[12], v1[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    if (j < n) {
      const int q = j / (g1 - g0), g = g0 + j % (g1 - g0);
      const int* job = jobs + ((size_t)t * 3 + q) * stride;
      const int p = min(max(job[0], 0), 2);
      const int ou = job[1 + 2 * g], ov = job[2 + 2 * g];
      const float u = uv[(((size_t)t * 3 + q) * kg + g) * 2 * sg + s];
      float uc = fminf(fmaxf(u - (float)ou, 0.f), umax);
      if (BLOCKDIAG) uc = __fadd_rn(uc, (float)(g * wu));
      const float fi = floorf(uc);
      w0[j] = u_tent(fi, uc);
      w1[j] = u_tent(fi + 1.f, uc);
      const int r0 = min(max(ou + (int)fi - (BLOCKDIAG ? g * wu : 0), 0), rows - 2);
      const int c0 = min(max(ov, 0), rv - 128 / CP);
      const uint2* a = reinterpret_cast<const uint2*>(
          planes + p * plane_elems + r0 * row_elems + (size_t)c0 * CP + lane * 4);
      v0[j] = __ldg(a);
      v1[j] = __ldg(a + row_elems / 4);
    }
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    if (j < n) {
      const uint32_t h0[2] = {v0[j].x, v0[j].y}, h1[2] = {v1[j].x, v1[j].y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t b0 = h0[i >> 1], b1 = h1[i >> 1];
        const float a0 = __uint_as_float((i & 1) ? (b0 & 0xffff0000u) : (b0 << 16));
        const float a1 = __uint_as_float((i & 1) ? (b1 & 0xffff0000u) : (b1 << 16));
        acc[i] = __fadd_rn(acc[i], __fadd_rn(__fmul_rn(w0[j], a0), __fmul_rn(w1[j], a1)));
      }
    }
  }
"""
FIRST_K2D_STORE = "    o[i] = make_uint4(w[0], w[1], w[2], w[3]);\n"

# ---- the resident-grid design ------------------------------------------------
GRID_S1 = "constexpr int S1_BATCH = "
GRID_K2D = "__global__ void __launch_bounds__(K2D_THREADS, K2D_PER_SM)\nsample_tiles_kernel("
GRID_TEXELS = "              v0[i] = __ldg(a);\n              v1[i] = __ldg(a + row2);\n"
GRID_NO_TEXELS = (f"              v0[i] = make_uint2((uint32_t)(size_t)a, {ONE});\n"
                  f"              v1[i] = make_uint2({ONE}, (uint32_t)(size_t)(a + row2));\n")
GRID_STORE = ("        __stcs(reinterpret_cast<float4*>(out_t + (size_t)(row0 + rb) * 128) + lane,\n"
              "               make_float4(acc[0], acc[1], acc[2], acc[3]));\n")
GRID_WB_STORE = ("        reinterpret_cast<float4*>(out_t + (size_t)(row0 + rb) * 128)[lane] =\n"
                 "            make_float4(acc[0], acc[1], acc[2], acc[3]);\n")
GRID_K2D_STORE = "      __stcs(o + c, make_uint4(w[0], w[1], w[2], w[3]));\n"
GRID_SUM = "                acc[k] = __fadd_rn(acc[k], fmaf(w1[i], a1, __fmul_rn(w0[i], a0)));\n"
GRID_NO_SUM = ("                acc[k] = __uint_as_float(__float_as_uint(acc[k]) ^ b0 ^ b1"
               " ^ __float_as_uint(w0[i] + w1[i]));\n")

GRID_U_STAGE = ("    const float* u0 = uv + (size_t)t * 6 * kg * sg;   // (plane, group) j's u at u0 + 2 j sg\n"
                "    stage_runs<S1_THREADS>(reinterpret_cast<float*>(sj + MAX_JOB_INTS), sgp,\n"
                "                           [&](int j) { return u0 + (size_t)j * 2 * sg; }, 3 * kg, "
                "sg, vec);\n")
GRID_U_READ = "su[(q * kg + g) * sgp + s]"
GRID_U_GLOBAL = "__ldg(uv + ((size_t)t * 3 * kg + q * kg + g) * 2 * sg + s)"
GRID_S1_BUFFER = "  return sizeof(int) * MAX_JOB_INTS + sizeof(float) * 3 * kg * staged_stride(sg);\n"
S1_THREADS, S1_PER_SM, S1_BATCH = ("constexpr int S1_THREADS = 1024;",
                                   "constexpr int S1_PER_SM = 1;", "constexpr int S1_BATCH = 4;")
K2D_PER_SM = "constexpr int K2D_PER_SM = 2;"


def s1_shape(threads: int, per_sm: int, batch: int) -> list:
    """S1's block of ``threads``, ``per_sm`` of them an SM, ``batch`` steps'
    loads at once."""
    return [("sampler_stages.cu", S1_THREADS, f"constexpr int S1_THREADS = {threads};", 1),
            ("sampler_stages.cu", S1_PER_SM, f"constexpr int S1_PER_SM = {per_sm};", 1),
            ("sampler_stages.cu", S1_BATCH, f"constexpr int S1_BATCH = {batch};", 1)]


# compute the function: checked, then timed
DESIGNS = ("unrolled", "wb_stores", "u_global", "threads_512", "threads_768", "two_blocks",
           "three_blocks")


def probes(kernel: str, texts: dict) -> dict:
    """``kernel`` ("S1" or "K2d") → {probe: [(file, text, replacement,
    times)]} for the design that ``texts`` ({file name: text} of a
    checkout's csrc) holds; "kernel" is the unedited kernel."""
    if kernel == "S1":
        src = texts["sampler_stages.cu"]
        if FIRST_S1 in src:
            a = src.index(FIRST_LOOP[0])
            loop = src[a:src.index(FIRST_LOOP[1], a)]
            return {"kernel": [],
                    "no_texels": [("sampler_stages.cu",
                                   "__ldg(a), v1 = __ldg(a + row_elems / 4)",
                                   f"make_uint2((uint32_t)(size_t)a, {ONE}), "
                                   f"v1 = make_uint2({ONE}, (uint32_t)(size_t)a)", 1)],
                    "no_stores": [("sampler_stages.cu", FIRST_STORE,
                                   FOLD.format(dst="out[wid]"), 1)],
                    "unrolled": [("sampler_stages.cu", loop, UNROLLED, 1)]}
        if GRID_S1 in src:
            return {"kernel": [],
                    "no_texels": [("sampler_stages.cu", GRID_TEXELS, GRID_NO_TEXELS, 1)],
                    "no_stores": [("sampler_stages.cu", GRID_STORE,
                                   FOLD.format(dst="out_t[row0 + rb]"), 1)],
                    "wb_stores": [("sampler_stages.cu", GRID_STORE, GRID_WB_STORE, 1)],
                    "no_sums": [("sampler_stages.cu", GRID_SUM, GRID_NO_SUM, 1)],
                    "u_global": [("sampler_stages.cu", GRID_U_STAGE, "", 1),
                                 ("sampler_stages.cu", GRID_U_READ, GRID_U_GLOBAL, 1),
                                 ("sampler_stages.cu", GRID_S1_BUFFER,
                                  "  return sizeof(int) * MAX_JOB_INTS;\n", 1)],
                    "threads_512": s1_shape(512, 1, 12),
                    "threads_768": s1_shape(768, 1, 6),
                    "two_blocks": s1_shape(512, 2, 4)}
    else:
        src = texts["sampler.cu"]
        gathers = [("sampler_core.cuh", GATHERS, NO_GATHERS, 1)]
        if FIRST_K2D in src:
            return {"kernel": [], "no_gathers": gathers,
                    "no_stores": [("sampler.cu", FIRST_K2D_STORE, "    " + NEVER
                                   + FIRST_K2D_STORE.lstrip(), 1)]}
        if GRID_K2D in src:
            return {"kernel": [], "no_gathers": gathers,
                    "no_stores": [("sampler.cu", GRID_K2D_STORE, "      " + NEVER
                                   + GRID_K2D_STORE.lstrip(), 1)],
                    "wb_stores": [("sampler.cu", GRID_K2D_STORE,
                                   "      o[c] = make_uint4(w[0], w[1], w[2], w[3]);\n", 1)],
                    "three_blocks": [("sampler.cu", K2D_PER_SM,
                                      "constexpr int K2D_PER_SM = 3;", 1)]}
    raise RuntimeError(f"{kernel}: no design this script knows is in the checkout's csrc")


def read_csrc(root: str) -> dict:
    texts = {}
    for name in ("sampler.cu", "sampler_stages.cu", "sampler_core.cuh"):
        with open(os.path.join(root, CSRC, name)) as f:
            texts[name] = f.read()
    return texts


def edited(texts: dict, source: str, edits: list) -> dict:
    """The checkout's source (with the core header) after K2's launchers are
    left out and ``edits`` are made; raises if an edit's text is not there
    as often as it says."""
    out = {source: texts[source], "sampler_core.cuh": texts["sampler_core.cuh"]}
    start, end = STRIP[source]
    a = out[source].index(start)
    b = out[source].index(end, a) if end else len(out[source])
    out[source] = out[source][:a] + out[source][b:]
    for file, old, new, times in edits:
        if out[file].count(old) != times:
            raise RuntimeError(f"a probe's text is not in {file} {times} time(s): {old[:60]!r}")
        out[file] = out[file].replace(old, new)
    return out


def build_all(roots: list[str]) -> dict:
    """(root, kernel, variant) → library path, every build in parallel."""
    from mere_fusion_tpu_torch.ops.attention import nvcc_path
    from mere_fusion_tpu_torch.runtime.build import BUILD_DIR, build_shared

    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    jobs = {}
    for r, root in enumerate(roots):
        texts = read_csrc(root)
        for kernel, source in (("S1", "sampler_stages.cu"), ("K2d", "sampler.cu")):
            for variant, edits in probes(kernel, texts).items():
                d = os.path.join(BUILD_DIR, "prof_fetch", f"r{r}_{kernel}_{variant}")
                os.makedirs(d, exist_ok=True)
                for name, text in edited(texts, source, edits).items():
                    with open(os.path.join(d, name), "w") as f:
                        f.write(text)
                jobs[(root, kernel, variant)] = (
                    f"pf_{kernel}_{variant}", [os.path.join(d, source)],
                    (os.path.join(d, "sampler_core.cuh"),))
    with ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 4)) as pool:
        paths = dict(zip(jobs, pool.map(
            lambda j: build_shared(j[0], j[1], cmd, headers=j[2]), jobs.values())))
    return paths


def ptxas(path: str, tag: str) -> dict:
    """ptxas's registers and spill bytes of the kernel whose name holds tag."""
    with open(path[:-3] + ".log") as f:
        log = f.read().splitlines()
    i = next(i for i, ln in enumerate(log) if "Compiling entry" in ln and tag in ln)
    notes = " ".join(log[i + 1:i + 4])
    return {"registers": int(re.search(r"Used (\d+) registers", notes).group(1)),
            "spill_bytes": sum(int(n) for n in re.findall(r"(\d+) bytes spill", notes))}


def main(argv: list[str] | None = None) -> int:
    import torch

    from mere_fusion_tpu_torch.ops import sampler, sampler_stages
    from mere_fusion_tpu_torch.ops.sampler import SamplerSpec
    from mere_fusion_tpu_torch.scripts import prof_r5k
    from mere_fusion_tpu_torch.scripts.k1_turns import _chip_smoke

    if not torch.cuda.is_available():
        raise RuntimeError("prof_fetch measures on a CUDA card; none is visible")
    roots = (sys.argv[1:] if argv is None else argv) or ["."]
    cs = _chip_smoke()
    paths = build_all(roots)
    p, i = ctypes.c_void_p, ctypes.c_int
    geometry = [i] * 8
    libs = {}
    for key, path in paths.items():
        lib = ctypes.CDLL(path)
        fn = lib.mf_m1_only if key[1] == "S1" else lib.mf_sample_tiles
        fn.argtypes = ([i, i, p, p, p, p, *geometry, p] if key[1] == "S1"
                       else [i, p, p, p, p, *geometry, p])
        fn.restype = i
        libs[key] = fn
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    label = (lambda root, v: v) if len(roots) == 1 else (lambda root, v: f"{root}:{v}")

    # S1 on the profiling operands, both modes; K2d on the dense job set
    s1_spec = SamplerSpec(resolution=prof_r5k.R, channels=prof_r5k.C, tile_w=16, tile_h=8,
                          k=16, kg=4, wu=64, wv=32)
    t1 = prof_r5k.N_RAYS // s1_spec.rays_per_tile
    jobs, uv, dproj, dtv, weights, planes = prof_r5k.make_inputs(
        s1_spec, t1, torch.Generator(device=dev).manual_seed(0), dev)
    s1_ops = (planes, jobs, uv.reshape(3 * t1, s1_spec.kg, 2, s1_spec.sg), dproj, dtv, weights)
    k2d_spec = cs.k2_spec()
    k2d_ops = cs.k2_operands(dev, cs.NERF_HW, k2d_spec, torch.bfloat16)
    cases = (("S1", False, s1_spec, s1_ops), ("S1_blockdiag", True, s1_spec, s1_ops),
             ("K2d", None, k2d_spec, k2d_ops))
    summary = {"roots": roots, "builds": {}}
    for (root, kernel, variant), path in paths.items():
        tags = ({"S1": "m1_only_kernelILb0E", "S1_blockdiag": "m1_only_kernelILb1E"}
                if kernel == "S1" else {"K2d": "sample_tiles_kernel"})
        for name, tag in tags.items():
            summary["builds"][label(root, f"{name}:{variant}")] = ptxas(path, tag)
    for case, blockdiag, spec, ops in cases:
        planes, jobs, uv = ops[:3]
        t = uv.shape[0] // 3
        geo = sampler._geometry(spec, t, planes)
        kernel = "S1" if blockdiag is not None else "K2d"
        if blockdiag is None:
            out = torch.empty(t, spec.kg, spec.sg, 3 * sampler.CP, dtype=torch.bfloat16,
                              device=dev)
            ref = sampler.sample_tiles_plain(planes, jobs, uv, spec)
            args = lambda: (dev.index, planes.data_ptr(), jobs.data_ptr(), uv.data_ptr(),
                            out.data_ptr(), *geo, stream)
        else:
            out = torch.empty(t, spec.kg * spec.sg if blockdiag else spec.sg,
                              sampler_stages.LANES, device=dev)
            ref = sampler_stages.m1_only_plain(planes, jobs, uv, spec, blockdiag)
            args = lambda: (dev.index, int(blockdiag), planes.data_ptr(), jobs.data_ptr(),
                            uv.data_ptr(), out.data_ptr(), *geo, stream)

        def launch(fn):
            def run():
                err = fn(*args())
                if err:
                    raise RuntimeError(f"launch failed with cudaError {err}")
            return run

        variants = {label(root, v): launch(fn) for (root, k, v), fn in libs.items()
                    if k == kernel}
        equal = {}
        for (root, k, v), fn in libs.items():
            if k == kernel and (v == "kernel" or v in DESIGNS):
                out.zero_()
                launch(fn)()
                torch.cuda.synchronize()
                equal[label(root, v)] = bool(torch.equal(out, ref))
                if not equal[label(root, v)]:
                    raise AssertionError(f"{case}: {label(root, v)} differs from the plain "
                                         "version")
        times: dict[str, list[float]] = {}
        for name in [*variants, *reversed(variants)]:
            ms = cs.time_ms(variants[name], iters=10, warmup=2)
            times.setdefault(name, []).append(ms)
            print(json.dumps({"case": case, "variant": name, "ms": ms}), flush=True)
        if blockdiag is None:
            bound, by = cs.family_bound_ms("K2d", spec, ops, None)
        else:
            bound, by = cs.stage_bound_ms(case, spec, ops, ref)
        summary[case] = {"bound_ms": bound, "bound_by": by, "bit_equal": equal, "ms": times}
        del out, ref
        torch.cuda.empty_cache()
    print(cs.card(), flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
