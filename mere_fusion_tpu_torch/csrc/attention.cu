// K1: fused exact self-attention for the MuseTalk UNet (sm_90a).
//
// Replaces the Pallas TPU kernel mere_fusion_tpu/ops/attention.py
// (self_attention_fused -> _attn_kernel): o = softmax(q k^T / sqrt(d)) v over
// [G, L, D] with scores, softmax and accumulation in float32. The UNet calls
// it for its self-attentions with L >= 512; at serving size that is
// G = 16 batch x 8 heads = 128, L = 1024, D = 40, bf16.
//
// Bound at the serving shape: 4*G*L^2*D = 21.5 GFLOP against 42 MB of q, k,
// v and o, i.e. ~22 us at the H100's 989 TFLOP/s bf16 tensor rate versus
// ~12.5 us at 3.35 TB/s: the work is bounded by arithmetic. What matters is
// that the [G, L, L] score matrix (0.5 GB in f32) never reaches device
// memory; the TPU kernel got that by holding whole K/V rows in VMEM
// (~0.5 MB), which does not fit the 227 KB of shared memory a block has.
//
// Design (simple and exact first; tensor cores via wgmma/TMA are later work):
//   - one block of 256 threads per (g, 64-query tile); K/V stream through
//     shared memory 64 rows at a time and are converted to f32 on load;
//   - online softmax: running row max and sum stay in f32 (shared memory),
//     the f32 output accumulator stays in registers and is rescaled per tile,
//     so nothing of size L x L exists anywhere;
//   - each thread owns a 4x4 patch of the 64x64 score tile and a 4 x ceil(D/16)
//     patch of the output; only the D real columns are touched (no padding),
//     and Q/K rows use an odd shared-memory stride so column reads are free of
//     bank conflicts;
//   - the products are scalar f32 FMAs on the CUDA cores, so the f32 path is
//     true f32 (no TF32) and the bf16 path is at least as exact as the
//     TPU kernel, which rounds p to bf16 before p*v.
// Requires L % 64 == 0 for q and k and D <= 128; the wrapper checks and
// raises before calling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int PS = BK + 1;    // row stride of the probability tile
constexpr int MAX_D = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int qk_stride(int d) { return d | 1; }

size_t smem_bytes(int d) {
  const int ds = qk_stride(d);
  return sizeof(float) * (size_t)(BQ * ds + BK * ds + BK * d + BQ * PS + 3 * BQ);
}

// DJ = ceil(D / 16): output columns per thread.
template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int lq, int lk, int d, float scale) {
  extern __shared__ float smem[];
  const int ds = qk_stride(d);
  float* sq = smem;                 // [BQ][ds]  query tile
  float* sk = sq + BQ * ds;         // [BK][ds]  key tile
  float* sv = sk + BK * ds;         // [BK][d]   value tile
  float* sp = sv + BK * d;          // [BQ][PS]  scores, then probabilities
  float* row_max = sp + BQ * PS;    // [BQ] running max
  float* row_sum = row_max + BQ;    // [BQ] running sum of exp
  float* row_scale = row_sum + BQ;  // [BQ] rescale of this tile

  const int q_tiles = lq / BQ;
  const int g = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* qg = q + ((size_t)g * lq + q0) * d;
  const T* kg = k + (size_t)g * lk * d;
  const T* vg = v + (size_t)g * lk * d;

  for (int e = tid; e < BQ * d; e += THREADS) sq[(e / d) * ds + e % d] = to_f32(qg[e]);
  if (tid < BQ) {
    row_max[tid] = -INFINITY;
    row_sum[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < lk; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; Q and row state are written
    const T* kt = kg + (size_t)k0 * d;
    const T* vt = vg + (size_t)k0 * d;
    for (int e = tid; e < BK * d; e += THREADS) {
      sk[(e / d) * ds + e % d] = to_f32(kt[e]);
      sv[e] = to_f32(vt[e]);
    }
    __syncthreads();

    // scores for rows ty + 16i and keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sq[(ty + 16 * i) * ds + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sk[(tx + 16 * j) * ds + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sp[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j] * scale;
    __syncthreads();

    // online softmax: four neighbouring lanes share one row
    {
      const int r = tid / 4;
      const int part = tid % 4;
      float* row = sp + r * PS;
      float mx = -INFINITY;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_max[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane has read row_max[r] before it changes
      if (part == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        row_scale[r] = alpha;
        row_sum[r] = row_sum[r] * alpha + sum;
        row_max[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_scale[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < BK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sp[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int col = tx + 16 * j;
        if (col < d) {
          const float vb = sv[c * d + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vb, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float inv = 1.f / row_sum[r];
    T* orow = o + ((size_t)g * lq + q0 + r) * d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) orow[col] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int DJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int g,
                   int lq, int lk, int d, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(d);
  auto kernel = attention_kernel<T, DJ>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)g * (unsigned)(lq / BQ);
  kernel<<<blocks, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lq, lk, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int g,
                     int lq, int lk, int d, float scale, cudaStream_t stream) {
  switch ((d + 15) / 16) {
    case 1: return launch<T, 1>(q, k, v, o, g, lq, lk, d, scale, stream);
    case 2: return launch<T, 2>(q, k, v, o, g, lq, lk, d, scale, stream);
    case 3: return launch<T, 3>(q, k, v, o, g, lq, lk, d, scale, stream);
    case 4: return launch<T, 4>(q, k, v, o, g, lq, lk, d, scale, stream);
    case 5: return launch<T, 5>(q, k, v, o, g, lq, lk, d, scale, stream);
    case 6: return launch<T, 6>(q, k, v, o, g, lq, lk, d, scale, stream);
    case 7: return launch<T, 7>(q, k, v, o, g, lq, lk, d, scale, stream);
    case 8: return launch<T, 8>(q, k, v, o, g, lq, lk, d, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, o: [g, lq, d]; k, v: [g, lk, d], all
// contiguous on CUDA device `device`; `stream` belongs to that device.
// Returns the cudaError_t of the launch.
extern "C" int mf_self_attention(int device, int dtype, const void* q,
                                 const void* k, const void* v, void* o, int g,
                                 int lq, int lk, int d, float scale, void* stream) {
  if (g <= 0 || lq <= 0 || lk <= 0 || lq % BQ || lk % BK || d <= 0 || d > MAX_D)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, o, g, lq, lk, d, scale, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(q, k, v, o, g, lq, lk, d, scale, s);
  return (int)cudaErrorInvalidValue;
}
