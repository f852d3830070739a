"""Where K3's encode kernel (the corners hashed in the kernel) spends its
time, on the card: the kernel against probes of itself.

    python -m mere_fusion_tpu_torch.scripts.prof_k3_encode

Three cases (``chip_smoke.k3_inputs``, the full-width 12-level triplane
spec): the training shape with the corner rows and weights saved for the
backward (65,536 points), a density-refresh chunk (65,536, nothing saved)
and an unbaked frame (1,048,576, nothing saved). Each variant is timed by
its device time (torch.profiler, as ``chip_smoke`` times K3), in turns (the
list, then reversed), beside each case's bound (``chip_smoke.
k3_encode_bound_ms``) and a model of the gathers' floor
(``gather_floor_model_ms``: one 32-byte L1 sector a corner, served at an
assumed one sector per SM per clock; a model, not a measurement).

Probes, built from csrc/hash_lookup.cu by text edits (each edit's text
must be in the file as often as the probe says):

- ``per_plane`` (design): one thread per (point, plane) looping over the
  levels, x01 divided once, out staged in shared memory and stored as one
  run per block, the saved rows and weights written as each thread's
  192-byte records (checked against the plain version like the kernel);
- ``index32`` (design): the thread's (point, plane, level) from 32-bit
  index arithmetic instead of 64-bit;
- ``mask_mod`` (design): a row's modulo as a mask for power-of-two table
  sizes and no division for a dense level's in-box rows;
- ``no_gathers``: each corner's table row replaced by its index (no gather;
  no longer the encode, timed only);
- ``no_saves``: the corner rows and weights not stored (the training case's
  stores; timed only);
- ``param_levels`` (design): the per-level constants read where the launch
  put them, the constant bank, instead of from the block's copy in shared
  memory (a warp's lanes read several levels').

Prints one JSON line per measurement, the card's name and power limit, and
a JSON summary as the last line. Raises without CUDA.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

KERNEL_HEAD = """template <bool SAVE>
__global__ void __launch_bounds__(THREADS)
encode_fwd_kernel("""
# one thread per (point, plane), t = 3 s + q, looping over the levels
PER_PLANE = """template <bool SAVE>
__global__ void __launch_bounds__(THREADS)
encode_fwd_kernel(Tables tb, const float* __restrict__ xyz, const __grid_constant__ Levels lv,
                  int levels, long long n_, float bound, float span, float shift,
                  float* __restrict__ out, int* __restrict__ idx_, float* __restrict__ w_) {
  extern __shared__ float s_out[];   // [THREADS][levels]
  const int n = (int)n_;
  int4* idx = reinterpret_cast<int4*>(idx_);
  float4* w = reinterpret_cast<float4*>(w_);
  const int t0 = blockIdx.x * THREADS, t = t0 + threadIdx.x;
  if (t < 3 * n) {
    const int s = t / 3, q = t - 3 * s;
    const float a = __ldg(xyz + 3 * s + (q == 1 ? 1 : 0));
    const float b = __ldg(xyz + 3 * s + (q == 0 ? 1 : 2));
    const float xa = __fdiv_rn(__fadd_rn(a, bound), span);
    const float xb = __fdiv_rn(__fadd_rn(b, bound), span);
    const float* table = pick(q, tb);
    const size_t rec = ((size_t)q * n + s) * levels;
#pragma unroll 4
    for (int l = 0; l < levels; ++l) {
      const float scale = lv.scale[l];
      const float pa = __fadd_rn(__fmul_rn(xa, scale), shift);
      const float pb = __fadd_rn(__fmul_rn(xb, scale), shift);
      const float fa = floorf(pa), fb = floorf(pb);
      const float ra = __fsub_rn(pa, fa), rb = __fsub_rn(pb, fb);
      const float qa = __fsub_rn(1.f, ra), qb = __fsub_rn(1.f, rb);
      const uint32_t ia = __float2uint_rz(fa), ib = __float2uint_rz(fb);
      const uint32_t hsize = lv.hsize[l], mul1 = lv.mul1[l];
      const bool hashed = lv.hashed[l] != 0;
      int row[CORNERS];
      float wt[CORNERS];
#pragma unroll
      for (int k = 0; k < CORNERS; ++k) {
        const uint32_t ga = ia + (uint32_t)(k >> 1), gb = ib + (uint32_t)(k & 1);
        const uint32_t h = hashed ? ga ^ (gb * 2654435761u) : ga + gb * mul1;
        row[k] = (int)(h % hsize);
        wt[k] = __fmul_rn((k >> 1) ? ra : qa, (k & 1) ? rb : qb);
      }
      const float* r = table + lv.offset[l];
      float acc = __fmul_rn(wt[0], __ldg(r + row[0]));
      acc = __fadd_rn(acc, __fmul_rn(wt[1], __ldg(r + row[1])));
      acc = __fadd_rn(acc, __fmul_rn(wt[2], __ldg(r + row[2])));
      acc = __fadd_rn(acc, __fmul_rn(wt[3], __ldg(r + row[3])));
      s_out[threadIdx.x * levels + l] = acc;
      if (SAVE) {
        idx[rec + l] = make_int4(row[0], row[1], row[2], row[3]);
        w[rec + l] = make_float4(wt[0], wt[1], wt[2], wt[3]);
      }
    }
  }
  __syncthreads();
  const int m = min(THREADS, 3 * n - t0) * levels;
  float* dst = out + (size_t)t0 * levels;
  for (int e = threadIdx.x; e < m; e += THREADS) dst[e] = s_out[e];
}
"""
INDEX64 = """  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n * MAX_GRIDS * levels) return;
  long long s;
  int q, l;
  if (SAVE) {   // t = (q n + s) levels + l
    const long long ql = t / levels;
    l = (int)(t - ql * levels);
    q = (int)(ql / n);
    s = ql - q * n;
  } else {      // t = (s 3 + q) levels + l
    const int gl = MAX_GRIDS * levels;
    s = t / gl;
    const int r = (int)(t - s * gl);
    q = r / levels;
    l = r - q * levels;
  }"""
INDEX32 = """  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int n32 = (int)n;
  if (t >= n32 * MAX_GRIDS * levels) return;
  int s, q, l;
  if (SAVE) {
    const int ql = t / levels;
    l = t - ql * levels;
    q = ql / n32;
    s = ql - q * n32;
  } else {
    const int gl = MAX_GRIDS * levels;
    s = t / gl;
    const int r = t - s * gl;
    q = r / levels;
    l = r - q * levels;
  }"""
MOD = "    row[k] = (int)(h % hsize);\n"
MASK_MOD = ("    row[k] = (int)((hsize & (hsize - 1)) == 0 ? h & (hsize - 1)\n"
            "                   : (h < hsize ? h : h % hsize));\n")
GATHERS = [f"__ldg(r + {i})" for i in ("row[0]", "row[1]", "row[2]", "row[3]")]
SAVES = """  if (SAVE) {
    reinterpret_cast<int4*>(idx)[t] = make_int4(row[0], row[1], row[2], row[3]);
    reinterpret_cast<float4*>(w)[t] = make_float4(wt[0], wt[1], wt[2], wt[3]);
  }
"""
LAUNCH_BLOCKS = "  const int blocks = blocks_for(n * MAX_GRIDS * levels);\n"
CASES = (("training", 65536, True), ("refresh", 65536, False), ("unbaked", 1 << 20, False))
DESIGNS = ("per_plane", "index32", "mask_mod", "param_levels")   # compute the encode: checked, then timed


def probes(source: str) -> dict:
    """probe name -> [(text of csrc/hash_lookup.cu, its replacement, the
    times it must occur)]; source is that file's text."""
    start = source.index(KERNEL_HEAD)
    kernel = source[start:source.index("\n}\n", start) + 3]
    return {
        "per_plane": [(kernel, PER_PLANE, 1),
                      (LAUNCH_BLOCKS, "  const int blocks = blocks_for(n * MAX_GRIDS);\n", 1),
                      ("<<<blocks, THREADS, 0, s>>>",
                       "<<<blocks, THREADS, sizeof(float) * THREADS * levels, s>>>", 2)],
        "index32": [(INDEX64, INDEX32, 1)],
        "mask_mod": [(MOD, MASK_MOD, 1)],
        "no_gathers": [(g, f"(float){g[10:-1]}", 1) for g in GATHERS],
        "no_saves": [(SAVES, "", 1)],
        "param_levels": [("s_lv.", "lv.", 5)],
    }


def build_all() -> dict[str, str]:
    """The kernel's library and one per probe; returns name -> path."""
    from mere_fusion_tpu_torch.ops import hash_lookup
    from mere_fusion_tpu_torch.ops.attention import nvcc_path
    from mere_fusion_tpu_torch.runtime.build import BUILD_DIR, build_shared

    d = os.path.join(BUILD_DIR, "prof_k3_encode")
    os.makedirs(d, exist_ok=True)
    with open(hash_lookup._SRC) as f:
        original = f.read()
    sources = {}
    for probe, edits in probes(original).items():
        text = original
        for old, new, times in edits:
            if text.count(old) != times:
                raise RuntimeError(f"probe {probe}: its text is not in csrc/hash_lookup.cu "
                                   f"{times} time(s)")
            text = text.replace(old, new)
        sources[probe] = os.path.join(d, f"{probe}.cu")
        with open(sources[probe], "w") as f:
            f.write(text)
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        kernel = pool.submit(hash_lookup.build)
        paths = dict(zip(sources, pool.map(
            lambda item: build_shared(f"k3e_{item[0]}", [item[1]], cmd), sources.items())))
        paths["kernel"] = kernel.result()
    return paths


def gather_floor_model_ms(n: int, levels: int) -> float:
    """A model of the least time for the encode's corner gathers: each a
    32-byte L1 sector of its own (random points share none), served at an
    assumed one sector per SM per clock at the card's top SM clock
    (nvidia-smi clocks.max.sm), 4 corners × 3 planes × levels a point. The
    rate is an assumption that no measurement here backs; the ``no_gathers``
    probe measures what the gathers cost."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 4 * 3 * levels * n / (sms * mhz * 1e6) * 1e3


def main() -> int:
    import torch

    from mere_fusion_tpu_torch.ops import hash_lookup
    from mere_fusion_tpu_torch.scripts.k1_turns import _chip_smoke

    if not torch.cuda.is_available():
        raise RuntimeError("prof_k3_encode measures on a CUDA card; none is visible")
    cs = _chip_smoke()
    paths = build_all()
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        lib.mf_hash_encode.argtypes = ([i32] + [p] * 4 + [i64] + [p] * 5 + [i32]
                                       + [ctypes.c_float] * 3 + [p] * 4)
        lib.mf_hash_encode.restype = i32
        libs[name] = lib
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    summary = {}
    for case, n, save in CASES:
        spec, tables, xyz, _ = cs.k3_inputs(dev, n, seed=1, spread=1.01)
        levels = spec.num_levels
        out = torch.empty(n, 3 * levels, device=dev)
        idx = torch.empty(3, n, levels, 4, dtype=torch.int32, device=dev) if save else None
        w = torch.empty(3, n, levels, 4, device=dev) if save else None

        def launch(lib):
            def run():
                err = lib.mf_hash_encode(
                    dev.index, *hash_lookup._tables(tables), xyz.data_ptr(), n,
                    *hash_lookup._levels(spec), levels, 1.0, 2.0, 0.5, out.data_ptr(),
                    idx.data_ptr() if save else None, w.data_ptr() if save else None, stream)
                if err:
                    raise RuntimeError(f"launch failed with cudaError {err}")
            return run

        variants = {name: launch(lib) for name, lib in libs.items()
                    if save or name != "no_saves"}
        pidx, pw = hash_lookup.triplane_corners(xyz, spec, 1.0)
        ref = hash_lookup.lookup_plain(tables, pidx, pw, spec)
        equal = {}
        for name in ("kernel", *DESIGNS):
            variants[name]()
            torch.cuda.synchronize()
            equal[name] = bool(torch.equal(out, ref) and (
                not save or (torch.equal(idx, pidx) and torch.equal(w, pw))))
            if not equal[name]:
                raise AssertionError(f"{case}: {name} differs from the plain version")
        times: dict[str, list[float]] = {}
        for name in [*variants, *reversed(variants)]:
            ms = cs.device_ms(variants[name], iters=50)
            times.setdefault(name, []).append(ms)
            print(json.dumps({"case": case, "variant": name, "device_ms": ms}), flush=True)
        bound, by = cs.k3_encode_bound_ms(n, spec, save)
        summary[case] = {"points": n, "saved": save, "bound_ms": bound, "bound_by": by,
                         "gather_floor_model_ms": gather_floor_model_ms(n, levels),
                         "bit_equal": equal, "device_ms": times}
        del tables, xyz, out, idx, w, pidx, pw, ref
        torch.cuda.empty_cache()
    print(cs.card(), flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
