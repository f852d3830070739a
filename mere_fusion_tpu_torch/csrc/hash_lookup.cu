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
//   - backward: one thread per (point, plane, level, corner), atomicAdd of
//     w * gout into a zeroed f32 gradient. Coarse levels collide (level 0 has
//     4,232 rows for 262,144 adds a plane); accumulating a level in shared
//     memory before one flush is the redesign, not this kernel. Atomics add
//     in an order that changes from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_GRIDS = 3;
constexpr int MAX_LEVELS = 32;
constexpr int CORNERS = 4;
constexpr int THREADS = 256;

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

// gout is [n, G * levels]; dtable is [G, rows] and zeroed.
__global__ void __launch_bounds__(THREADS)
lookup_bwd_kernel(const int* idx, const float* w, Offsets off, int ngrid, int levels,
                  long long n, long long rows, const float* gout, float* dtable) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int gl = ngrid * levels;
  if (t >= n * gl * CORNERS) return;
  const int k = (int)(t & (CORNERS - 1));
  const long long r = t >> 2;        // (point, plane, level): gout's entry
  const long long s = r / gl;
  const int ql = (int)(r - s * gl);
  const int q = ql / levels, l = ql - q * levels;
  const long long e = ((q * n + s) * levels + l) * CORNERS + k;
  atomicAdd(dtable + q * rows + level_offset(off, l) + idx[e], __fmul_rn(w[e], gout[r]));
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
// [ngrid, rows] f32 zeroed, which the kernel adds into. Returns the
// cudaError_t of the launch.
extern "C" int mf_hash_lookup_bwd(int device, int ngrid, const void* idx, const void* w,
                                  const int* offsets, int levels, long long n, long long rows,
                                  const void* gout, void* dtable, void* stream) {
  Offsets off = {};
  if (!valid(ngrid, levels, n, offsets, &off) || rows < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  lookup_bwd_kernel<<<blocks_for(n * ngrid * levels * CORNERS), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(w), off, ngrid, levels, n, rows,
      static_cast<const float*>(gout), static_cast<float*>(dtable));
  return (int)cudaGetLastError();
}
