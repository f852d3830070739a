// K3: multi-level hash-table lookup, forward and backward (sm_90a).
//
// Replaces the Pallas TPU kernel mere_fusion_tpu/ops/hash_mxu.py:216
// (lookup: forward _fwd_kernel :107, backward _bwd_kernel :130, custom VJP
// :223-243). For sample n, grid q (one hash grid per triplane plane) and
// level l of one-channel tables (the ER-NeRF planes' level_dim) it computes
//   out[n, q L + l] = sum_{k<4} w[q, n, l, k] table_q[off_l + idx[q, n, l, k]]
// and its table gradient
//   dtable_q[off_l + idx[q, n, l, k]] += w[q, n, l, k] gout[n, q L + l].
// The TPU kernel pads each level to [H, 128 C] lane rows, carries the
// indices as f32 and selects rows with a one-hot matmul, because the TPU has
// no fast gather. Hopper has one, so this kernel reads the network's own flat
// tables ([T, 1] per grid, level l at row offset off_l) and writes the
// gradient straight into that layout: no pad, no unpad.
//
// Bound at the ER-NeRF training shape (N = 65,536 points, 3 planes x 12
// levels, C = 1, 163,584 rows a plane): the int32 corner indices are 37.7 MB
// (every row is below the 2^14 table size, as the TPU kernel's f32 indices
// are 4 bytes), the f32 corner weights 37.7 MB, the output 9.4 MB and the
// tables 2 MB, so the forward moves ~87 MB, ~0.026 ms at 3.35 TB/s; its 8
// operations per (point, plane, level) are 19 MFLOP, nothing beside the
// bytes. The backward reads the same indices and weights and gout and
// writes the 2 MB gradient: the same bytes. Bytes bound both.
//
// Design (simple and right first):
//   - forward: one thread per (point, plane, level); its 4 indices arrive as
//     one 16-byte load and its 4 weights as another, the 4 table rows are
//     gathered through the read-only path (the 2 MB of tables stay in the
//     50 MB L2), and the corner sum runs in the plain version's order with
//     every product and sum rounded on its own (no contraction into FMAs),
//     so kernel and plain version agree bit for bit;
//   - backward: the rows of a plane's gradient are cut into tasks of at
//     most BWD_ROWS rows (224 KB of f32): pairs of neighbouring levels where
//     the pair fits, single levels where only one fits, equal slices of a
//     level that does not fit alone (a larger --log2_hashmap_size). One
//     cluster of BWD_CLUSTER blocks per (plane, task): each block keeps the
//     task's rows in shared memory, adds its share of the points' corners
//     that fall in them, then sums its share of the rows over the cluster's
//     copies through distributed shared memory and stores them. Every row is
//     written once: no global atomic, no zero fill. A thread takes one
//     (point, level) at a time, point-major, so the two threads of a point's
//     level pair read neighbouring 16 bytes of its 192-byte record. The first
//     design (one thread per corner, a global f32 atomicAdd each into a
//     zeroed gradient: 9.4 M L2 atomics at the training shape, 62 a row at
//     level 0) and what holds this one are in
//     mere_fusion_tpu_torch/scripts/prof_k3.py and PERF.md. Shared-memory
//     f32 atomics are compare-and-swap loops on sm_90a and add in an order
//     that changes from run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_GRIDS = 3;
constexpr int MAX_LEVELS = 32;
constexpr int CORNERS = 4;
constexpr int THREADS = 256;
constexpr int BWD_THREADS = 1024;
constexpr int BWD_UNROLL = 2;          // (point, level) items a thread loads before it adds
constexpr int BWD_CLUSTER = 4;         // blocks per (plane, task)
constexpr int BWD_GROUP = 2;           // levels a task takes at most
constexpr int BWD_ROWS = 56 * 1024;    // rows a task takes at most (224 KB of 227)

struct Tables {
  const float* t[MAX_GRIDS];         // [T, 1] per grid
};

struct Offsets {
  int v[MAX_LEVELS];                 // first row of each level in a table
};

// A kernel parameter indexed by a run-time value is copied to each thread's
// stack first; these pick an entry with compile-time indices only, so the
// parameters stay in the constant bank.
__device__ __forceinline__ const float* pick(int q, const Tables& tb) {
  return q == 0 ? tb.t[0] : (q == 1 ? tb.t[1] : tb.t[2]);
}

__device__ __forceinline__ int level_offset(const Offsets& off, int l) {
  int o = 0;
#pragma unroll
  for (int j = 0; j < MAX_LEVELS; ++j) o = j == l ? off.v[j] : o;
  return o;
}

// idx and w are [G, n, levels, 4]; out is [n, G * levels].
__global__ void __launch_bounds__(THREADS)
lookup_fwd_kernel(Tables tb, const int* idx, const float* w, Offsets off, int ngrid,
                  int levels, long long n, float* out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int gl = ngrid * levels;
  if (t >= n * gl) return;
  const long long s = t / gl;
  const int ql = (int)(t - s * gl);
  const int q = ql / levels, l = ql - q * levels;
  const long long e = ((q * n + s) * levels + l) * CORNERS;
  const int4 i = *reinterpret_cast<const int4*>(idx + e);
  const float4 wv = *reinterpret_cast<const float4*>(w + e);
  const float* r = pick(q, tb) + level_offset(off, l);
  float acc = __fmul_rn(wv.x, __ldg(r + i.x));
  acc = __fadd_rn(acc, __fmul_rn(wv.y, __ldg(r + i.y)));
  acc = __fadd_rn(acc, __fmul_rn(wv.z, __ldg(r + i.z)));
  acc = __fadd_rn(acc, __fmul_rn(wv.w, __ldg(r + i.w)));
  out[t] = acc;
}

// A backward task: rows [r0, r1) of a plane's gradient, in levels [l0, l1).
struct Task {
  int l0, l1, r0, r1;
};

__host__ __device__ inline int level_end(const Offsets& off, int levels, int rows, int l) {
  return l + 1 < levels ? off.v[l + 1] : rows;
}

// Cuts a plane's rows into tasks (see the header) and returns their count;
// sets *task to task `want` when want is one of them.
__host__ __device__ inline int plan(const Offsets& off, int levels, int rows, int want,
                                    Task* task) {
  int count = 0;
  for (int l = 0; l < levels;) {
    const int a = off.v[l];
    int l1 = l + 1;
    while (l1 < levels && l1 - l < BWD_GROUP && level_end(off, levels, rows, l1) - a <= BWD_ROWS)
      ++l1;
    const int e = level_end(off, levels, rows, l1 - 1);
    const int slices = (e - a + BWD_ROWS - 1) / BWD_ROWS;   // over 1 only for a level alone
    const int size = ((e - a + slices - 1) / slices + 3) & ~3;
    if (want >= count && want < count + slices) {
      const int r0 = a + (want - count) * size;
      *task = {l, l1, r0, r0 + size < e ? r0 + size : e};
    }
    count += slices;
    l = l1;
  }
  return count;
}

__device__ __forceinline__ void add_in(float* acc, int r, int span, float v) {
  if ((unsigned)r < (unsigned)span) atomicAdd(acc + r, v);
}

// gout is [n, G * levels]; dtable is [G, rows], every row of which is
// written. One cluster of BWD_CLUSTER blocks per (grid q, task); each block
// adds its share of the points' corners into a shared-memory copy of the
// task's rows, then sums its share of the rows over the cluster's copies and
// stores them.
__global__ void __launch_bounds__(BWD_THREADS)
lookup_bwd_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                  const __grid_constant__ Offsets off, int ngrid, int levels, long long n,
                  int rows, int tasks, const float* __restrict__ gout,
                  float* __restrict__ dtable) {
  extern __shared__ float4 acc4[];      // the task's rows, whole float4s
  float* acc = reinterpret_cast<float*>(acc4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / BWD_CLUSTER, q = cid / tasks;
  Task t;
  plan(off, levels, rows, cid - q * tasks, &t);
  const int span = t.r1 - t.r0, nl = t.l1 - t.l0;
  for (int r = threadIdx.x; r < span; r += BWD_THREADS) acc[r] = 0.f;
  __syncthreads();

  // items (point, level) of points [p0, p1), point-major, a thread's
  // BWD_UNROLL items at a time, every load of them issued before their adds
  const long long p0 = n * rank / BWD_CLUSTER, p1 = n * (rank + 1) / BWD_CLUSTER;
  const int items = (int)(p1 - p0) * nl, gl = ngrid * levels;
  for (int base = threadIdx.x; base < items; base += BWD_THREADS * BWD_UNROLL) {
    int4 i[BWD_UNROLL];
    float4 wv[BWD_UNROLL];
    float go[BWD_UNROLL];
    int lo[BWD_UNROLL];   // the item's level's first row, from the task's
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      const int j = base + u * BWD_THREADS, pj = j / nl;
      const long long p = p0 + pj;
      const int l = t.l0 + (j - pj * nl);
      const bool live = j < items;
      const long long e = ((q * n + p) * levels + l) * CORNERS;
      lo[u] = off.v[l] - t.r0;
      i[u] = live ? __ldg(reinterpret_cast<const int4*>(idx + e)) : make_int4(0, 0, 0, 0);
      wv[u] = live ? __ldg(reinterpret_cast<const float4*>(w + e))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      go[u] = live ? __ldg(gout + p * gl + q * levels + l) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      if (base + u * BWD_THREADS >= items) continue;
      add_in(acc, lo[u] + i[u].x, span, __fmul_rn(wv[u].x, go[u]));
      add_in(acc, lo[u] + i[u].y, span, __fmul_rn(wv[u].y, go[u]));
      add_in(acc, lo[u] + i[u].z, span, __fmul_rn(wv[u].z, go[u]));
      add_in(acc, lo[u] + i[u].w, span, __fmul_rn(wv[u].w, go[u]));
    }
  }
  cluster.sync();   // every block's adds are in

  // this block's share of the rows (a multiple of 4, so that it is read as
  // float4), summed over the cluster's copies (a row's loads all issued
  // before its adds) and stored
  const int share = ((span + BWD_CLUSTER - 1) / BWD_CLUSTER + 3) & ~3;
  const int s0 = min(span, rank * share), s1 = min(span, s0 + share);
  float* dst = dtable + q * (long long)rows + t.r0;
  for (int r = s0 + 4 * threadIdx.x; r < s1; r += 4 * BWD_THREADS) {
    float4 v[BWD_CLUSTER];
#pragma unroll
    for (int b = 0; b < BWD_CLUSTER; ++b)
      v[b] = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(acc + r, (rank + b) % BWD_CLUSTER));
    float4 sum = v[0];
#pragma unroll
    for (int b = 1; b < BWD_CLUSTER; ++b) {
      sum.x += v[b].x;
      sum.y += v[b].y;
      sum.z += v[b].z;
      sum.w += v[b].w;
    }
    // the task's last rows need not fill a float4
    const float part[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (r + k < s1) dst[r + k] = part[k];
  }
  cluster.sync();   // no block leaves while another still reads its rows
}

int blocks_for(long long threads) { return (int)((threads + THREADS - 1) / THREADS); }

bool valid(int ngrid, int levels, long long n, const int* offsets, Offsets* off) {
  if (ngrid < 1 || ngrid > MAX_GRIDS || levels < 1 || levels > MAX_LEVELS || n < 1) return false;
  // one thread per (point, plane, level, corner): the grid's x extent must hold them
  if (n * ngrid * levels * CORNERS > (long long)THREADS * 0x7fffffffLL) return false;
  for (int l = 0; l < levels; ++l) off->v[l] = offsets[l];
  return true;
}

}  // namespace

// Tables t0..t2 [T, 1] f32 for the first `ngrid` grids (the rest may be
// null); idx [ngrid, n, levels, 4] int32 (row within the level) and w of the
// same shape f32, both 16-byte aligned; offsets: `levels` host ints, each
// level's first row; out [n, ngrid * levels] f32. All contiguous on CUDA
// device `device`; `stream` belongs to the device. Returns the cudaError_t
// of the launch.
extern "C" int mf_hash_lookup_fwd(int device, int ngrid, const void* t0, const void* t1,
                                  const void* t2, const void* idx, const void* w,
                                  const int* offsets, int levels, long long n, void* out,
                                  void* stream) {
  Offsets off = {};
  if (!valid(ngrid, levels, n, offsets, &off)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Tables tb = {{static_cast<const float*>(t0), static_cast<const float*>(t1),
                      static_cast<const float*>(t2)}};
  lookup_fwd_kernel<<<blocks_for(n * ngrid * levels), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      tb, static_cast<const int*>(idx), static_cast<const float*>(w), off, ngrid, levels, n,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// idx and w as for the forward, gout [n, ngrid * levels] f32, dtable
// [ngrid, rows] f32, all of whose rows the kernel writes (no zeroing
// needed); offsets: the level offsets, increasing from offsets[0] = 0, every
// row of [0, rows) in some level. Returns the cudaError_t of the launch.
extern "C" int mf_hash_lookup_bwd(int device, int ngrid, const void* idx, const void* w,
                                  const int* offsets, int levels, long long n, long long rows,
                                  const void* gout, void* dtable, void* stream) {
  Offsets off = {};
  if (!valid(ngrid, levels, n, offsets, &off) || rows < 1 || rows > 0x7fffffffLL ||
      offsets[0] != 0 || n * BWD_GROUP > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < levels; ++l)
    if (level_end(off, levels, (int)rows, l) <= off.v[l]) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Task t = {};
  const int tasks = plan(off, levels, (int)rows, -1, &t);
  int most = 0;   // the largest task's rows
  for (int k = 0; k < tasks; ++k) {
    plan(off, levels, (int)rows, k, &t);
    most = t.r1 - t.r0 > most ? t.r1 - t.r0 : most;
  }
  const int bytes = (int)sizeof(float4) * ((most + 3) / 4);
  err = cudaFuncSetAttribute(lookup_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ngrid * tasks * BWD_CLUSTER);
  cfg.blockDim = dim3(BWD_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = BWD_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lookup_bwd_kernel, static_cast<const int*>(idx),
                           static_cast<const float*>(w), off, ngrid, levels, n, (int)rows, tasks,
                           static_cast<const float*>(gout), static_cast<float*>(dtable));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
