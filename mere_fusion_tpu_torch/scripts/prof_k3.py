"""Where K3's backward spends its time, on the card: the kernel against the
first design, two other designs, and probes of each.

    python -m mere_fusion_tpu_torch.scripts.prof_k3

At the training shape (``chip_smoke.k3_operands``: 65,536 seeded points,
the full-width 12-level triplane spec) each variant is timed by its device
time (torch.profiler, as ``chip_smoke`` times K3), in turns (the list, then
reversed). Probes that no longer compute the gradient are timed only.

- ``atomic``: the first design, one thread per (point, plane, level,
  corner), a global f32 atomicAdd each into a gradient zeroed first (the
  zero fill's device time included, as its wrapper paid it);
- ``atomic_skip_coarse``: the same without levels 0–3, the levels whose rows
  take 20–62 adds each (4–11 take 16);
- ``atomic_distinct``: the same adds with each thread's row replaced by its
  corner's index modulo its level's rows, so that no two neighbouring
  threads add to one row;
- ``sibling slabs S``: a cluster of ceil(L / 2) blocks per (plane, slab of
  points, S slabs), block b adding level pair b of the slab's points into
  its own shared memory, the siblings reading neighbouring sectors of the
  same records at once; each block then stores its rows (S = 1) or adds
  them into the zeroed gradient;
- ``owner C``: the design of one owner per row: a cluster of C blocks per
  (plane, level pair), each block holding a C-th of the pair's rows and
  adding every corner into its owner's shared memory (distributed shared
  memory atomics), then storing its own rows;
- ``kernel``: the port's kernel (``lookup_bwd_kernel``: tasks of level
  pairs, a cluster of 4 blocks each accumulating a copy of the task's rows,
  a cluster-wide sum and one store a row), with its largest error against
  the plain version's gradient relative to the gradient's largest entry;
- probes of the kernel, built from csrc/hash_lookup.cu by text edits
  (``probes``): ``no_adds`` (the reads of idx, w and gout kept, nothing
  added: the reads' floor), ``level_major`` (a thread's items taken
  level-major, so that a warp reads one level of 32 points),
  ``cluster_C`` (C blocks a task), ``group_G`` (at most G levels a task),
  ``unroll_U`` (U items loaded before their adds) and ``threads_512``
  (512 threads a block, 4 items each);
- ``sibling slabs 4 plain_adds`` / ``no_adds``: the sibling design with its
  shared-memory atomics as plain read-modify-writes (racy), or with no adds.

Prints each kernel's instruction counts by opcode (cuobjdump -sass), one
JSON line per measurement, the card's name and power limit, and a JSON
summary as the last line. Raises without CUDA.
"""
from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

SIBLING_SLABS = (1, 2, 4, 7)
OWNER_CLUSTERS = (4, 8)

# the first design (its kernel as it was), with the two probes as arguments
ATOMIC_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

struct Offsets { int v[32]; };

__device__ __forceinline__ int level_offset(const Offsets& off, int l) {
  int o = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) o = j == l ? off.v[j] : o;
  return o;
}

__global__ void __launch_bounds__(256)
atomic_bwd(const int* idx, const float* w, Offsets off, int ngrid, int levels, long long n,
           long long rows, const float* gout, float* dtable, int skip_below, int distinct) {
  const long long t = (long long)blockIdx.x * 256 + threadIdx.x;
  const int gl = ngrid * levels;
  if (t >= n * gl * 4) return;
  const int k = (int)(t & 3);
  const long long r = t >> 2;
  const long long s = r / gl;
  const int ql = (int)(r - s * gl);
  const int q = ql / levels, l = ql - q * levels;
  if (l < skip_below) return;
  const long long e = ((q * n + s) * levels + l) * 4 + k;
  const int o = level_offset(off, l);
  const int row = distinct ? (int)(t % ((l + 1 < levels ? level_offset(off, l + 1) : (int)rows) - o))
                           : idx[e];
  atomicAdd(dtable + q * rows + o + row, __fmul_rn(w[e], gout[r]));
}

// a cluster of ceil(levels / 2) blocks per (plane, slab of points), block b
// adding level pair b of the slab's points into its own shared memory (the
// siblings read neighbouring sectors of the same records at the same time,
// so each sector comes from DRAM once); then each block stores its rows
// (one slab) or adds them into the zeroed gradient (several)
__global__ void __launch_bounds__(1024)
sibling_bwd(const int* __restrict__ idx, const float* __restrict__ w,
            const __grid_constant__ Offsets off, int levels, long long n, long long rows,
            int slabs, const float* __restrict__ gout, float* __restrict__ dtable, int mode) {
  extern __shared__ float acc[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), b = (int)cl.block_rank();
  const int cid = blockIdx.x / cs, q = cid / slabs, s = cid - q * slabs;
  const int l0 = 2 * b, l1 = min(l0 + 2, levels);
  const int own0 = off.v[l0];
  const int own = (l1 < levels ? off.v[l1] : (int)rows) - own0;
  const int second = l1 - l0 > 1 ? off.v[l0 + 1] - own0 : 0;
  for (int r = threadIdx.x; r < own; r += 1024) acc[r] = 0.f;
  __syncthreads();
  const long long P0 = n * s / slabs, P1 = n * (s + 1) / slabs;
  for (long long p = P0 + threadIdx.x; p < P1; p += 1024) {
    const long long e = ((q * n + p) * levels + l0) * 4;
    const int4 i0 = __ldg(reinterpret_cast<const int4*>(idx + e));
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(w + e));
    const float g0 = __ldg(gout + p * 3 * levels + q * levels + l0);
    int4 i1 = make_int4(0, 0, 0, 0);
    float4 w1 = make_float4(0.f, 0.f, 0.f, 0.f);
    float g1 = 0.f;
    if (l1 - l0 > 1) {
      i1 = __ldg(reinterpret_cast<const int4*>(idx + e + 4));
      w1 = __ldg(reinterpret_cast<const float4*>(w + e + 4));
      g1 = __ldg(gout + p * 3 * levels + q * levels + l0 + 1);
    }
    if (mode == 1) {   // plain adds (racy): the atomics' cost
      acc[i0.x] += __fmul_rn(w0.x, g0);
      acc[i0.y] += __fmul_rn(w0.y, g0);
      acc[i0.z] += __fmul_rn(w0.z, g0);
      acc[i0.w] += __fmul_rn(w0.w, g0);
      float* a1 = acc + second;
      a1[i1.x] += __fmul_rn(w1.x, g1);
      a1[i1.y] += __fmul_rn(w1.y, g1);
      a1[i1.z] += __fmul_rn(w1.z, g1);
      a1[i1.w] += __fmul_rn(w1.w, g1);
      continue;
    }
    if (mode == 2) {   // no adds: the reads' cost
      if (__fmul_rn(w0.x + w1.y, g0 + g1) == 1234.5f && i0.x + i1.w == -7) acc[0] = 1.f;
      continue;
    }
    atomicAdd(acc + i0.x, __fmul_rn(w0.x, g0));
    atomicAdd(acc + i0.y, __fmul_rn(w0.y, g0));
    atomicAdd(acc + i0.z, __fmul_rn(w0.z, g0));
    atomicAdd(acc + i0.w, __fmul_rn(w0.w, g0));
    if (l1 - l0 > 1) {
      float* a1 = acc + second;
      atomicAdd(a1 + i1.x, __fmul_rn(w1.x, g1));
      atomicAdd(a1 + i1.y, __fmul_rn(w1.y, g1));
      atomicAdd(a1 + i1.z, __fmul_rn(w1.z, g1));
      atomicAdd(a1 + i1.w, __fmul_rn(w1.w, g1));
    }
  }
  __syncthreads();
  float* dst = dtable + q * rows + own0;
  for (int r = threadIdx.x; r < own; r += 1024) {
    if (slabs == 1) dst[r] = acc[r];
    else if (acc[r] != 0.f) atomicAdd(dst + r, acc[r]);
  }
  cl.sync();
}

// a cluster of C blocks per (plane, level pair), block b owning the b-th
// C-th of the pair's rows: every corner is added into its owner's shared
// memory (a distributed shared memory atomic), then each block stores its rows
__global__ void __launch_bounds__(1024)
owner_bwd(const int* __restrict__ idx, const float* __restrict__ w,
          const __grid_constant__ Offsets off, int levels, long long n, long long rows,
          const float* __restrict__ gout, float* __restrict__ dtable) {
  extern __shared__ float acc[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int pairs = (levels + 1) / 2, cid = blockIdx.x / cs, q = cid / pairs;
  const int l0 = 2 * (cid - q * pairs), l1 = min(l0 + 2, levels), nl = l1 - l0;
  const int a = off.v[l0], span = (l1 < levels ? off.v[l1] : (int)rows) - a;
  const int share = ((span + cs - 1) / cs + 3) & ~3;
  for (int r = threadIdx.x; r < share; r += 1024) acc[r] = 0.f;
  cl.sync();   // every owner's rows are zero before any add
  const long long p0 = n * rank / cs, p1 = n * (rank + 1) / cs;
  const int items = (int)(p1 - p0) * nl;
  for (int base = threadIdx.x; base < items; base += 4096) {
    int4 i[4];
    float4 wv[4];
    float g[4];
    int lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + u * 1024, pj = j / nl, l = l0 + (j - pj * nl);
      const long long p = p0 + pj, e = ((q * n + p) * levels + l) * 4;
      const bool live = j < items;
      lo[u] = off.v[l] - a;
      i[u] = live ? __ldg(reinterpret_cast<const int4*>(idx + e)) : make_int4(0, 0, 0, 0);
      wv[u] = live ? __ldg(reinterpret_cast<const float4*>(w + e))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      g[u] = live ? __ldg(gout + p * 3 * levels + q * levels + l) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (base + u * 1024 >= items) continue;
      const int r[4] = {lo[u] + i[u].x, lo[u] + i[u].y, lo[u] + i[u].z, lo[u] + i[u].w};
      const float v[4] = {__fmul_rn(wv[u].x, g[u]), __fmul_rn(wv[u].y, g[u]),
                          __fmul_rn(wv[u].z, g[u]), __fmul_rn(wv[u].w, g[u])};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int b = r[k] / share;
        atomicAdd(cl.map_shared_rank(acc, b) + (r[k] - b * share), v[k]);
      }
    }
  }
  cl.sync();   // every add is in
  const int s0 = min(span, rank * share), s1 = min(span, s0 + share);
  float* dst = dtable + q * rows + a;
  for (int r = s0 + threadIdx.x; r < s1; r += 1024) dst[r] = acc[r - s0];
}

extern "C" int probe_owner_bwd(const void* idx, const void* w, const int* offsets, int levels,
                               long long n, long long rows, int cs, const void* gout,
                               void* dtable, void* stream) {
  Offsets off = {};
  for (int l = 0; l < levels; ++l) off.v[l] = offsets[l];
  const int pairs = (levels + 1) / 2;
  int most = 0;
  for (int b = 0; b < pairs; ++b) {
    const int a = off.v[2 * b], e = 2 * b + 2 < levels ? off.v[2 * b + 2] : (int)rows;
    most = e - a > most ? e - a : most;
  }
  const size_t bytes = 4 * (size_t)(((most + cs - 1) / cs + 3) & ~3);
  cudaError_t err = cudaFuncSetAttribute(owner_bwd,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(3 * pairs * cs);
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, owner_bwd, (const int*)idx, (const float*)w, off, levels, n,
                           rows, (const float*)gout, (float*)dtable);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int probe_sibling_bwd(const void* idx, const void* w, const int* offsets, int levels,
                                 long long n, long long rows, int slabs, const void* gout,
                                 void* dtable, int mode, void* stream) {
  Offsets off = {};
  for (int l = 0; l < levels; ++l) off.v[l] = offsets[l];
  const int cs = (levels + 1) / 2;
  int most = 0;
  for (int b = 0; b < cs; ++b) {
    const int a = off.v[2 * b], e = 2 * b + 2 < levels ? off.v[2 * b + 2] : (int)rows;
    most = e - a > most ? e - a : most;
  }
  const size_t bytes = 4 * (size_t)most;
  cudaError_t err = cudaFuncSetAttribute(sibling_bwd,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(3 * slabs * cs);
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sibling_bwd, (const int*)idx, (const float*)w, off, levels, n,
                           rows, slabs, (const float*)gout, (float*)dtable, mode);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int probe_atomic_bwd(const void* idx, const void* w, const int* offsets, int levels,
                                long long n, long long rows, const void* gout, void* dtable,
                                int skip_below, int distinct, void* stream) {
  Offsets off = {};
  for (int l = 0; l < levels; ++l) off.v[l] = offsets[l];
  const long long threads = n * 3 * levels * 4;
  atomic_bwd<<<(unsigned)((threads + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)w, off, 3, levels, n, rows, (const float*)gout,
      (float*)dtable, skip_below, distinct);
  return (int)cudaGetLastError();
}
"""

ADDS = """      add_in(acc, lo[u] + i[u].x, span, __fmul_rn(wv[u].x, go[u]));
      add_in(acc, lo[u] + i[u].y, span, __fmul_rn(wv[u].y, go[u]));
      add_in(acc, lo[u] + i[u].z, span, __fmul_rn(wv[u].z, go[u]));
      add_in(acc, lo[u] + i[u].w, span, __fmul_rn(wv[u].w, go[u]));
"""
NO_ADDS = ("      if (__fmul_rn(wv[u].x + wv[u].y + wv[u].z + wv[u].w, go[u]) == 1234.5f &&\n"
           "          lo[u] + i[u].x + i[u].y + i[u].z + i[u].w == -7) acc[0] = 1.f;\n")
ITEM = "const int j = base + u * BWD_THREADS, pj = j / nl;"
LEVEL_MAJOR = ("const int j = base + u * BWD_THREADS, pj = j % (int)(p1 - p0);\n"
               "      const int k = j / (int)(p1 - p0);")
LEVEL = "const int l = t.l0 + (j - pj * nl);"


def probes(source: str) -> dict:
    """probe name -> [(text of csrc/hash_lookup.cu, its replacement)];
    source is that file's text, where the constants' lines are found."""
    def const(name, value):
        line = re.search(rf"constexpr int {name} = [^;]*;", source).group(0)
        return line, f"constexpr int {name} = {value};"

    return {
        "no_adds": [(ADDS, NO_ADDS)],
        "level_major": [(ITEM, LEVEL_MAJOR), (LEVEL, "const int l = t.l0 + k;")],
        "cluster_2": [const("BWD_CLUSTER", "2")],
        "cluster_6": [const("BWD_CLUSTER", "6")],
        "cluster_8": [const("BWD_CLUSTER", "8")],
        "group_1": [const("BWD_GROUP", "1")],
        "group_3": [const("BWD_GROUP", "3")],
        "unroll_1": [const("BWD_UNROLL", "1")],
        "unroll_4": [const("BWD_UNROLL", "4")],
        "threads_512": [const("BWD_THREADS", "512"), const("BWD_UNROLL", "4")],
    }


def sass_ops(path: str, tag: str) -> dict:
    """Instruction counts by opcode of the kernel whose name holds tag."""
    from mere_fusion_tpu_torch.ops.attention import nvcc_path

    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          timeout=300, check=True).stdout.splitlines()
    first = next(i for i, ln in enumerate(sass) if "Function" in ln and tag in ln)
    end = next((i for i in range(first + 1, len(sass)) if "Function" in sass[i]), len(sass))
    ops = collections.Counter()
    for ln in sass[first:end]:
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", ln)
        if m:
            ops[m.group(1)] += 1
    return dict(ops.most_common(30))


def build_all() -> dict[str, str]:
    """The first design's library, and one per probe of the kernel."""
    from mere_fusion_tpu_torch.ops import hash_lookup
    from mere_fusion_tpu_torch.ops.attention import nvcc_path
    from mere_fusion_tpu_torch.runtime.build import BUILD_DIR, build_shared

    d = os.path.join(BUILD_DIR, "prof_k3")
    os.makedirs(d, exist_ok=True)
    sources = {"atomic": os.path.join(d, "atomic_bwd.cu")}
    with open(sources["atomic"], "w") as f:
        f.write(ATOMIC_SRC)
    with open(hash_lookup._SRC) as f:
        original = f.read()
    for probe, edits in probes(original).items():
        text = original
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"probe {probe}: its text is not in csrc/hash_lookup.cu once")
            text = text.replace(old, new)
        sources[probe] = os.path.join(d, f"{probe}.cu")
        with open(sources[probe], "w") as f:
            f.write(text)
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC"]
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        kernel = pool.submit(hash_lookup.build)
        paths = dict(zip(sources, pool.map(
            lambda item: build_shared(f"k3_{item[0]}", [item[1]], cmd), sources.items())))
        paths["kernel"] = kernel.result()
    return paths


def main() -> int:
    import torch

    from mere_fusion_tpu_torch.ops import hash_lookup
    from mere_fusion_tpu_torch.scripts.k1_turns import _chip_smoke

    if not torch.cuda.is_available():
        raise RuntimeError("prof_k3 measures on a CUDA card; none is visible")
    cs = _chip_smoke()
    paths = build_all()
    for name, tag in (("kernel", "lookup_bwd_kernel"), ("atomic", "atomic_bwd"),
                      ("atomic", "owner_bwd")):
        print(json.dumps({"sass": tag, "ops": sass_ops(paths[name], tag)}), flush=True)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    atomic_lib = ctypes.CDLL(paths["atomic"])
    atomic_lib.probe_atomic_bwd.argtypes = [p, p, ctypes.POINTER(i), i, ll, ll, p, p, i, i, p]
    atomic_lib.probe_atomic_bwd.restype = i
    atomic_lib.probe_sibling_bwd.argtypes = [p, p, ctypes.POINTER(i), i, ll, ll, i, p, p, i, p]
    atomic_lib.probe_sibling_bwd.restype = i
    atomic_lib.probe_owner_bwd.argtypes = [p, p, ctypes.POINTER(i), i, ll, ll, i, p, p, p]
    atomic_lib.probe_owner_bwd.restype = i
    probe_libs = {}
    for name in (k for k in paths if k not in ("atomic", "kernel")):
        lib = ctypes.CDLL(paths[name])
        lib.mf_hash_lookup_bwd.argtypes = [i, i, p, p, ctypes.POINTER(i), i, ll, ll, p, p, p]
        lib.mf_hash_lookup_bwd.restype = i
        probe_libs[name] = lib
    dev = torch.device("cuda", 0)
    spec, tables, idx, w, gout = cs.k3_operands(dev)
    n, rows, levels = w.shape[1], spec.total_params, spec.num_levels
    offsets = hash_lookup._offsets(spec)
    dtable = torch.empty(3, rows, 1, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def atomic(skip_below=0, distinct=0):
        def launch():
            dtable.zero_()
            err = atomic_lib.probe_atomic_bwd(idx.data_ptr(), w.data_ptr(), offsets, levels, n,
                                              rows, gout.data_ptr(), dtable.data_ptr(),
                                              skip_below, distinct, stream)
            if err:
                raise RuntimeError(f"launch failed with cudaError {err}")
        return launch

    def probe(lib):
        def launch():
            err = lib.mf_hash_lookup_bwd(0, 3, idx.data_ptr(), w.data_ptr(), offsets, levels, n,
                                         rows, gout.data_ptr(), dtable.data_ptr(), stream)
            if err:
                raise RuntimeError(f"launch failed with cudaError {err}")
        return launch

    def sibling(slabs, mode=0):
        def launch():
            if slabs > 1:
                dtable.zero_()
            err = atomic_lib.probe_sibling_bwd(idx.data_ptr(), w.data_ptr(), offsets, levels, n,
                                               rows, slabs, gout.data_ptr(), dtable.data_ptr(),
                                               mode, stream)
            if err:
                raise RuntimeError(f"launch failed with cudaError {err}")
        return launch

    def owner(cs):
        def launch():
            err = atomic_lib.probe_owner_bwd(idx.data_ptr(), w.data_ptr(), offsets, levels, n,
                                             rows, cs, gout.data_ptr(), dtable.data_ptr(), stream)
            if err:
                raise RuntimeError(f"launch failed with cudaError {err}")
        return launch

    variants = {"atomic": atomic(), "atomic_skip_coarse": atomic(skip_below=4),
                "atomic_distinct": atomic(distinct=1),
                **{f"sibling slabs {sl}": sibling(sl) for sl in SIBLING_SLABS},
                "sibling slabs 4 plain_adds": sibling(4, 1), "sibling slabs 4 no_adds": sibling(4, 2)}
    variants.update({f"owner {c}": owner(c) for c in OWNER_CLUSTERS})
    variants["kernel"] = lambda: hash_lookup.lookup_bwd_cuda(idx, w, gout, spec, tables,
                                                             out=dtable)
    variants.update({name: probe(lib) for name, lib in probe_libs.items()})
    dref = cs.k3_plain_grad(spec, tables, idx, w, gout)
    scale = max(d.abs().max().item() for d in dref)
    errors = {}
    for name, fn in variants.items():
        fn()
        torch.cuda.synchronize()
        errors[name] = max((dtable[q] - dref[q]).abs().max().item() for q in range(3)) / scale
        print(json.dumps({"variant": name, "max_rel_err": errors[name]}), flush=True)
    times: dict[str, list[float]] = {}
    for name in [*variants, *reversed(variants)]:
        ms = cs.device_ms(variants[name], iters=50)
        times.setdefault(name, []).append(ms)
        print(json.dumps({"variant": name, "device_ms": ms}), flush=True)
    bound, by = cs.k3_bound_ms(tables, idx, w, gout)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"card": card, "points": n, "bound_ms": bound, "bound_by": by,
                      "device_ms": times, "max_rel_err": errors}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
