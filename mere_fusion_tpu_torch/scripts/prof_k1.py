"""Where K1's time goes: the kernel against probes of itself, on the card.

    python -m mere_fusion_tpu_torch.scripts.prof_k1

Each probe is ``csrc/attention.cu`` with one part of the bf16 kernel taken
out or changed, built beside it (nvcc, one process each, in parallel) and
timed at the serving shape [16, 8, 1024, 40] by CUDA events, in turns with
the kernel (kernel, probes, probes reversed, kernel). A probe that takes a
part out no longer computes attention: only its time is read. The design
probes (``pipelined``, ``pingpong``, ``resident_grid``) compute the same
attention; their largest difference from the kernel is printed.

- ``no_exp``: the exponentials (ex2) return their argument;
- ``no_qk``: S = Q Kᵀ is not started (the softmax runs on stale registers);
- ``no_pv``: O += P V is not started;
- ``no_loads``: the producer signals each K/V stage without copying it;
- ``box64``: TMA boxes 64 columns wide (the padding moved from L2, as the
  kernel was first built);
- ``stages2``: a two-stage K/V ring instead of three;
- ``pipelined``: S of key tile j + 1 started before P·V of tile j, so the
  softmax overlaps the product within a warpgroup (FlashAttention-3's
  intra-warpgroup overlap; more registers);
- ``pingpong``: the two consumer warpgroups take turns starting S = Q Kᵀ
  (named barriers), FlashAttention-3's inter-warpgroup schedule;
- ``resident_grid``: the same kernel (its output equals the kernel's)
  launched as only the blocks that fit on the card at once, each looping
  over the 128-query work tiles, against one block per work tile: the tail
  wave of the last, partly filled round of blocks.

The float32 kernel (3xTF32 on mma.sync) has probes of its own, timed the
same way at the serving shape in f32, in turns with it:

- ``f32_single_tf32``: one TF32 product (hi × hi) per term instead of
  three (the share of the products; not f32 accurate);
- ``f32_no_pv``: O += P V not computed;
- ``f32_one_pv_accumulator``: P V chained over every key tile in one
  tensor-core accumulator, rescaled in place, instead of each tile's P V
  from zero added in f32 (a design probe: its error against the plain
  version is printed beside the kernel's).

Prints one JSON line per measurement, the work tiles and resident blocks,
the card's name and power limit, and a JSON summary as the last line.
Raises without CUDA.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

SERVE_SHAPE = (16, 8, 1024, 40)

# the resident grid: blocks that fit at once, and a way to read that number
RESIDENT_GRID = """  int blocks = g * ((lq + WG_BQ - 1) / WG_BQ), dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WG_THREADS, bytes);
  if (sms * per_sm < blocks) blocks = sms * per_sm;
"""
RESIDENT_QUERY = """
extern "C" int mf_probe_resident_blocks(int d) {
  return dispatch_wgmma(d, [&](auto nks, auto nv) {
    const auto kernel = attention_wgmma_kernel<decltype(nks)::value, decltype(nv)::value>;
    const int bytes = static_cast<int>(Layout<(decltype(nks)::value + 3) / 4>::dynamic);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WG_THREADS, bytes);
    return sms * per_sm;
  });
}
"""

# S(j + 1) started before P V(j), so the softmax of tile j + 1 overlaps the
# product of tile j (FA3's intra-warpgroup overlap); the last P V after the loop
SERIAL_LOOP = """    for (int j = 0; j < nk; ++j, ++it) {
      const uint32_t cur = it % STAGES;
      mbar_wait(full0 + 8 * cur, (it / STAGES) & 1);
      fence_regs(s);
      wgmma_fence();
      start_qk<NKS>(s, dq, dk + cur * STAGE);
      wgmma_wait<0>();
      fence_regs(s);
      if (online_softmax<!SUM_COL>(s, m0, m1, l0, l1, alpha0, alpha1, scale_log2)) {
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
#pragma unroll
          for (int i = 0; i < NA; ++i) acc[cb][i] *= (i & 2) ? alpha1 : alpha0;
      }
      pack_p(s, p);
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) fence_regs(acc[cb]);
      wgmma_fence();
      start_pv<CB, NA>(acc, p, dv + cur * STAGE);
      wgmma_wait<0>();
      fence_regs(p);
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) fence_regs(acc[cb]);
      mbar_arrive(empty0 + 8 * cur);
    }
"""
PIPELINED_LOOP = """    mbar_wait(full0 + 8 * (it % STAGES), (it / STAGES) & 1);
    fence_regs(s);
    wgmma_fence();
    start_qk<NKS>(s, dq, dk + (it % STAGES) * STAGE);
    wgmma_wait<0>();
    fence_regs(s);
    online_softmax<!SUM_COL>(s, m0, m1, l0, l1, alpha0, alpha1, scale_log2);
    pack_p(s, p);
    for (int j = 0; j + 1 < nk; ++j, ++it) {
      const uint32_t cur = it % STAGES, nxt = (it + 1) % STAGES;
      mbar_wait(full0 + 8 * nxt, ((it + 1) / STAGES) & 1);
      fence_regs(s);
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) fence_regs(acc[cb]);
      wgmma_fence();
      start_qk<NKS>(s, dq, dk + nxt * STAGE);
      start_pv<CB, NA>(acc, p, dv + cur * STAGE);
      wgmma_wait<1>();
      fence_regs(s);
      const bool moved = online_softmax<!SUM_COL>(s, m0, m1, l0, l1, alpha0, alpha1, scale_log2);
      wgmma_wait<0>();
      fence_regs(p);
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) fence_regs(acc[cb]);
      mbar_arrive(empty0 + 8 * cur);
      if (moved) {
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
#pragma unroll
          for (int i = 0; i < NA; ++i) acc[cb][i] *= (i & 2) ? alpha1 : alpha0;
      }
      pack_p(s, p);
    }
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) fence_regs(acc[cb]);
    wgmma_fence();
    start_pv<CB, NA>(acc, p, dv + (it % STAGES) * STAGE);
    wgmma_wait<0>();
    fence_regs(p);
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) fence_regs(acc[cb]);
    mbar_arrive(empty0 + 8 * (it % STAGES));
    ++it;
"""
# FA3's ping-pong: named barriers let the two warpgroups start S = Q K^T in
# turns, so one's softmax runs while the other's product does
NAMED_BARRIERS = """__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

"""

# probe name -> ([(text in csrc/attention.cu, its replacement), ...], text appended)
PROBES = {
    "no_exp": ([('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "  y = x;")], ""),
    "no_qk": ([("      start_qk<NKS>(s, dq, dk + cur * STAGE);", "      wgmma_commit();")], ""),
    "no_pv": ([("      start_pv<CB, NA>(acc, p, dv + cur * STAGE);", "      wgmma_commit();")], ""),
    "no_loads": ([("""          mbar_expect_tx(full, 2 * CB * WG_BK * box_cols(d) * 2);
          const int row = g * lk + j * WG_BK;
          for (int cb = 0; cb < CB; ++cb) {
            tma_load(sk + (s * CB + cb) * KV_BLOCK, &tk, cb * COLS, row, full);
            tma_load(sv + (s * CB + cb) * KV_BLOCK, &tv, cb * COLS, row, full);
          }""", "          mbar_arrive(full);")], ""),
    "box64": ([("int box_cols(int d) { return d < COLS ? d : COLS; }",
                "int box_cols(int d) { return COLS; }")], ""),
    "stages2": ([("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")], ""),
    "pipelined": ([(SERIAL_LOOP, PIPELINED_LOOP)], ""),
    "pingpong": ([
        ("// P (unnormalised) rounded to bf16 A fragments",
         NAMED_BARRIERS + "// P (unnormalised) rounded to bf16 A fragments"),
        ("  uint32_t it = 0, local = 0;\n  for (int tile",
         "  uint32_t it = 0, local = 0;\n  if (wg == 1) named_arrive(1);\n  for (int tile"),
        ("      wgmma_fence();\n      start_qk<NKS>(s, dq, dk + cur * STAGE);\n",
         "      wgmma_fence();\n      named_sync(1 + wg);\n"
         "      start_qk<NKS>(s, dq, dk + cur * STAGE);\n      named_arrive(2 - wg);\n")], ""),
    "resident_grid": ([("  const int blocks = g * ((lq + WG_BQ - 1) / WG_BQ);\n", RESIDENT_GRID)],
                      RESIDENT_QUERY),
}


# this tile's P V from zero, added to the rescaled O in f32 (the kernel)
F32_PV = """    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;

    // O = alpha O + P V, this tile's P V from zero on the tensor cores and
    // added in f32 (chained over every tile in one tensor-core accumulator,
    // the output is further from the plain version). Key block kk's
    // accumulator is P's A fragment with positions t, t + 4 standing for
    // keys 2t, 2t + 1, so B reads V's rows 2t, 2t + 1.
    float pv[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(s[kk][0], ah[0], al[0]);
      split_tf32(s[kk][2], ah[1], al[1]);
      split_tf32(s[kk][1], ah[2], al[2]);
      split_tf32(s[kk][3], ah[3], al[3]);
      const float* vb = sv + (8 * kk + 2 * t) * S + gr;
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_3xtf32(pv[n], ah, al, vb[8 * n], vb[S + 8 * n]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] = fmaf(acc[n][0], alpha0, pv[n][0]);
      acc[n][1] = fmaf(acc[n][1], alpha0, pv[n][1]);
      acc[n][2] = fmaf(acc[n][2], alpha1, pv[n][2]);
      acc[n][3] = fmaf(acc[n][3], alpha1, pv[n][3]);
    }
"""
# P V chained over the key tiles in one accumulator, rescaled in place
F32_ONE_PV = """    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P V: key block kk's accumulator is P's A fragment with positions
    // t, t + 4 standing for keys 2t, 2t + 1, so B reads V's rows 2t, 2t + 1
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(s[kk][0], ah[0], al[0]);
      split_tf32(s[kk][2], ah[1], al[1]);
      split_tf32(s[kk][1], ah[2], al[2]);
      split_tf32(s[kk][3], ah[3], al[3]);
      const float* vb = sv + (8 * kk + 2 * t) * S + gr;
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_3xtf32(acc[n], ah, al, vb[8 * n], vb[S + 8 * n]);
    }
"""
F32_PROBES = {
    "f32_single_tf32": ([("""  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);""", "  mma_tf32(d, ah, bh0, bh1);")], ""),
    "f32_no_pv": ([("      for (int n = 0; n < NT; ++n) mma_3xtf32(pv[n], ah, al, vb[8 * n], "
                    "vb[S + 8 * n]);\n", "")], ""),
    "f32_one_pv_accumulator": ([(F32_PV, F32_ONE_PV)], ""),
}
F32_DESIGN_PROBES = ("f32_one_pv_accumulator",)


def build_all(out_dir: str) -> dict[str, str]:
    """The kernel's library and one per probe; returns name -> path."""
    from mere_fusion_tpu_torch.ops import attention
    from mere_fusion_tpu_torch.runtime.build import build_shared

    with open(attention._SRC) as f:
        src = f.read()
    sources = {"kernel": attention._SRC}
    os.makedirs(out_dir, exist_ok=True)
    for name, (edits, tail) in {**PROBES, **F32_PROBES}.items():
        probe = src
        for old, new in edits:
            if probe.count(old) != 1:
                raise RuntimeError(f"probe {name}: its text is not in csrc/attention.cu once")
            probe = probe.replace(old, new)
        path = os.path.join(out_dir, f"attention_{name}.cu")
        with open(path, "w") as f:
            f.write(probe + tail)
        sources[name] = path
    cmd = [attention.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC"]
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = pool.map(lambda item: build_shared(f"k1_{item[0]}", [item[1]], cmd),
                         sources.items())
    return dict(zip(sources, paths))


def main() -> int:
    import torch
    import torch.nn.functional as F

    from mere_fusion_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        raise RuntimeError("prof_k1 measures on a CUDA card; none is visible")
    from mere_fusion_tpu_torch.runtime.build import BUILD_DIR

    libs = {}
    for name, path in build_all(os.path.join(BUILD_DIR, "prof_k1")).items():
        lib = ctypes.CDLL(path)
        lib.mf_self_attention.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])
        lib.mf_self_attention.restype = ctypes.c_int
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(SERVE_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    b, h, lq, d = SERVE_SHAPE
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        err = lib.mf_self_attention(0, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), b * h, lq, lq, d, 1 / math.sqrt(d), stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")

    def ms(fn, iters: int = 50) -> float:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    order = ["kernel", *PROBES, *reversed(PROBES), "kernel"]
    times: dict[str, list[float]] = {}
    for name in order:
        t = ms(lambda: launch(libs[name]))
        times.setdefault(name, []).append(t)
        print(json.dumps({"variant": name, "ms": t}), flush=True)
    times["sdpa"] = [ms(lambda: F.scaled_dot_product_attention(q, k, v)) for _ in range(2)]
    launch(libs["kernel"])
    kernel_out = out.clone()
    for name in ("pipelined", "pingpong", "resident_grid"):
        launch(libs[name])
        diff = (out.float() - kernel_out.float()).abs().max().item()
        print(json.dumps({"variant": name, "max_abs_diff_from_kernel": diff}), flush=True)
        if not diff <= 1e-2:
            raise AssertionError(f"{name} computes another function: {diff}")
    # the f32 kernel and its probes, at the serving shape in f32 (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    qf, kf, vf = (torch.randn(SERVE_SHAPE, generator=gen, device="cuda") for _ in range(3))
    out_f = torch.empty_like(qf)

    def launch_f32(lib):
        err = lib.mf_self_attention(0, 0, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                                    out_f.data_ptr(), b * h, lq, lq, d, 1 / math.sqrt(d), stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")

    f32_order = ["kernel", *F32_PROBES, *reversed(F32_PROBES), "kernel"]
    f32_times: dict[str, list[float]] = {}
    for name in f32_order:
        t = ms(lambda: launch_f32(libs[name]), iters=20)
        f32_times.setdefault(name, []).append(t)
        print(json.dumps({"variant": name, "dtype": "float32", "ms": t}), flush=True)
    f32_times["sdpa"] = [ms(lambda: F.scaled_dot_product_attention(qf, kf, vf), iters=20)
                         for _ in range(2)]
    ref = attention.self_attention_plain(qf, kf, vf)
    f32_errors = {}
    for name in ("kernel", *F32_DESIGN_PROBES):
        launch_f32(libs[name])
        f32_errors[name] = (out_f - ref).abs().max().item()
        print(json.dumps({"variant": name, "dtype": "float32",
                          "max_abs_err": f32_errors[name]}), flush=True)
    lib = libs["resident_grid"]
    lib.mf_probe_resident_blocks.argtypes = [ctypes.c_int]
    resident = lib.mf_probe_resident_blocks(d)
    tiles = b * h * -(-lq // 128)
    grid = {"work_tiles": tiles, "resident_blocks": resident, "waves": tiles / resident}
    print(json.dumps(grid), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"card": card, "shape": SERVE_SHAPE, **grid, "ms": times,
                      "f32_ms": f32_times, "f32_max_abs_err": f32_errors}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
