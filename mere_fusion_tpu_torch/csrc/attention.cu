// K1: fused exact self-attention for the MuseTalk UNet (sm_90a).
//
// Replaces the Pallas TPU kernel mere_fusion_tpu/ops/attention.py:49
// (self_attention_fused -> _attn_kernel): o = softmax(q k^T / sqrt(d)) v over
// [G, L, D] with scores, softmax and accumulation in float32. The UNet calls
// it for its self-attentions with L >= 512; at serving size that is
// G = 16 batch x 8 heads = 128, L = 1024, D = 40, bf16.
//
// What bounds it at the serving shape: the two products are 4*G*L^2*D =
// 21.5 GFLOP, ~22 us at the H100's 989 TFLOP/s bf16 tensor rate, against
// 42 MB of q, k, v and o (~12.5 us at 3.35 TB/s): arithmetic. Beside the
// products the softmax takes G*L^2 = 134 M exponentials; at 16 ex2 per SM per
// clock that is ~32 us at 1.98 GHz on 132 SMs, so the special-function units
// set a floor above the tensor bound. The [G, L, L] score matrix (0.5 GB in
// f32) must never reach device memory; the TPU kernel got that by holding
// whole K/V rows in VMEM (~0.5 MB), which does not fit a block's 227 KB.
//
// bf16 (attention_wgmma_kernel): products on the tensor cores, loads off the
// critical path, softmax in registers.
//   - One block per 128 queries of one (b, h): two consumer warpgroups of 64
//     query rows each and one producer warp; two blocks an SM at D = 40.
//     The grid has a block per 128-query work tile (1024 at the serving
//     shape); the blocks loop over work tiles, so a grid of only the
//     resident blocks also works (measured slower by scripts/prof_k1.py).
//   - The producer's TMA loads (cp.async.bulk.tensor, completion on an
//     mbarrier) bring Q once per work tile and 64-key K/V tiles into a
//     three-stage ring, so copies run ahead of the products. Tiles are staged
//     in 128-byte rows with the 128 B swizzle that wgmma reads. A box reads
//     only the D real columns (D = 40: 80 of the 128 bytes a row), so L2
//     moves no padding: the kernel was bound by that traffic while its boxes
//     were 64 columns wide. The rest of each row is zeroed once per block.
//   - S = Q K^T is wgmma m64n64k16 with both operands in shared memory (depth
//     padded to a multiple of 16 by those zero columns) into f32 registers.
//   - Online softmax on the accumulators: the row max over the four lanes of
//     a quad (shuffles), exp2 with the scale folded in as scale * log2(e).
//     P is rounded to bf16 unnormalised, in place, into the A fragments of
//     O += P V: wgmma with A from registers and the V tile read N-major (the
//     transpose flag). The output is rescaled only when a row's max moves.
//     The row sum stays in f32 and divides O once at the end; at D = 40 it
//     rides the product (V's column 40 is 1.0, so the f32 accumulator of
//     column 40 sums the bf16 P), elsewhere it is summed on the CUDA cores.
//     No score passes through shared memory and nothing of size L x L exists.
//   - What holds it now (scripts/prof_k1.py, probes of this kernel with one
//     part taken out): no one unit; taking out the exponentials, either
//     product or the loads each saves little, so the dependent steps of a
//     tile (S, its softmax, P V) and their latencies set the time.
// float32 (attention_kernel): the CUDA-core kernel below, unchanged since it
// was first written. Its products are true f32 FMAs (no TF32), which the f32
// model check needs:
//   - one block of 256 threads per (g, 64-query tile); K/V stream through
//     shared memory 64 rows at a time and are converted to f32 on load;
//   - online softmax: running row max and sum stay in f32 (shared memory),
//     the f32 output accumulator stays in registers and is rescaled per tile;
//   - each thread owns a 4x4 patch of the 64x64 score tile and a 4 x ceil(D/16)
//     patch of the output; only the D real columns are touched (no padding),
//     and Q/K rows use an odd shared-memory stride so column reads are free of
//     bank conflicts.
// Requires L % 64 == 0 for q and k and D <= 128, and in bf16 D % 8 == 0 and
// 16-byte aligned tensors (TMA's strides and addresses); the wrapper checks
// and raises before calling. cuTensorMapEncodeTiled is taken through
// cudaGetDriverEntryPoint, so the library does not link libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// bf16: wgmma tiles fed by a TMA K/V ring

constexpr int WG_BQ = 128;                 // queries per work tile (two warpgroups)
constexpr int WG_BK = 64;                  // keys per ring stage
constexpr int STAGES = 3;                  // ring depth
constexpr int CONSUMERS = 256;             // two consumer warpgroups
constexpr int WG_THREADS = CONSUMERS + 32; // and one producer warp
constexpr int COLS = 64;                   // bf16 columns of a 128-byte swizzled row
constexpr uint32_t KV_BLOCK = WG_BK * COLS * 2;  // bytes of one 64-row column block
constexpr uint32_t Q_BLOCK = WG_BQ * COLS * 2;   // bytes of one Q column block
constexpr uint32_t WG_Q_ROWS = 64 * COLS * 2;    // one warpgroup's 64 Q rows
constexpr float LOG2E = 1.4426950408889634f;

// Columns a TMA box reads: all d of a head_dim under 64 (rows of 2 d bytes
// land in 128-byte swizzled rows whose other columns stay as they are), else
// 64 (columns past d read as zeros).
__host__ __device__ __forceinline__ int box_cols(int d) { return d < COLS ? d : COLS; }

// Shared memory of a block, in bytes from a 1024-aligned base (the 128 B
// swizzle repeats every 8 rows of 128 bytes). CB column blocks of 64 cover D.
template <int CB>
struct Layout {
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + CB * Q_BLOCK;
  static constexpr uint32_t v = k + STAGES * CB * KV_BLOCK;
  static constexpr uint32_t bar = v + STAGES * CB * KV_BLOCK;
  static constexpr uint32_t bars = 2 + 2 * STAGES;  // q_full, q_empty, full[], empty[]
  static constexpr size_t dynamic = bar + 8 * bars + 1024;  // + slack to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits for the completion of the barrier's phase of this parity. A wait that
// never ends would hang the card: after 2^24 polls it traps instead, which
// fails the launch with an error the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// 2-D TMA load of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// wgmma descriptor of a tile in shared memory laid out in 128 B swizzled
// rows: start address, leading and stride byte offsets (16 B units), layout
// 1 = 128 B swizzle. The stride between 8-row groups is 1024 bytes; the
// leading offset is not read for K-major operands and is set to the same
// 1024 so that an N-major operand of at most 64 columns reads right whichever
// field the layout takes its 8-row stride from.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma window.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// ... and the A fragments a register-sourced wgmma reads until it completes.
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}

#define MF_ACC32                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define MF_D32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B for a 64 x 64 x 16 step, A [64 x 16] and B [16 x 64] both K-major
// in shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MF_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MF_ACC32
      : "l"(a), "l"(b), "r"(accumulate));
}

#define MF_ACC24                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
#define MF_D24                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23}"

// d += A B for a 64 x N x 16 step (N = 64 or 48), A from registers (the
// accumulator fragment layout rounded to bf16 pairs), B N-major in shared
// memory (the transpose flag).
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MF_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MF_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 " MF_D24
      ", {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : MF_ACC24
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// S = Q K^T for one warpgroup's 64 rows and one 64-key tile, over NKS k16
// steps of the padded depth, from the descriptors of the tiles' first
// columns (offsets in 16-byte units): started and committed, not waited for.
template <int NKS>
__device__ __forceinline__ void start_qk(float (&s)[32], uint64_t q, uint64_t k) {
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const uint32_t off = (ks % 4) * 32;  // 16 bf16 along the swizzled row
    wgmma_ss(s, q + ((ks / 4) * Q_BLOCK + off) / 16, k + ((ks / 4) * KV_BLOCK + off) / 16, ks > 0);
  }
  wgmma_commit();
}

// O += P V for one 64-key tile, V N-major: 16 keys are 16 rows of 128 bytes.
template <int CB, int NA>
__device__ __forceinline__ void start_pv(float (&acc)[CB][NA], const uint32_t (&p)[4][4], uint64_t v) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
      wgmma_rs_bt(acc[cb], p[kk], v + (cb * KV_BLOCK + kk * 16 * COLS * 2) / 16);
  wgmma_commit();
}

// Online softmax of one score tile on the two rows this thread holds: the
// running max (raw scores) is updated and s is overwritten with
// exp2((s - max) * scale * log2 e); with SUM, this thread's part of the row
// sum too. Returns whether either row's max moved, with the factors that
// rescale the output.
template <bool SUM>
__device__ __forceinline__ bool online_softmax(float (&s)[32], float& m0, float& m1, float& l0,
                                               float& l1, float& alpha0, float& alpha1,
                                               float scale_log2) {
  // four independent chains per row (registers 8 c .. 8 c + 7), then a tree
  float mx[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mx[0][c] = fmaxf(fmaxf(s[8 * c], s[8 * c + 1]), fmaxf(s[8 * c + 4], s[8 * c + 5]));
    mx[1][c] = fmaxf(fmaxf(s[8 * c + 2], s[8 * c + 3]), fmaxf(s[8 * c + 6], s[8 * c + 7]));
  }
  float mx0 = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(fmaxf(mx[0][2], mx[0][3]), m0));
  float mx1 = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(fmaxf(mx[1][2], mx[1][3]), m1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const bool moved = mx0 != m0 || mx1 != m1;
  alpha0 = ex2((m0 - mx0) * scale_log2);  // 0 on the first tile
  alpha1 = ex2((m1 - mx1) * scale_log2);
  m0 = mx0;
  m1 = mx1;
  const float b0 = -mx0 * scale_log2, b1 = -mx1 * scale_log2;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = ex2(fmaf(s[i], scale_log2, (i & 2) ? b1 : b0));
  if (SUM) {
    float sum[2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sum[0][c] = (s[8 * c] + s[8 * c + 1]) + (s[8 * c + 4] + s[8 * c + 5]);
      sum[1][c] = (s[8 * c + 2] + s[8 * c + 3]) + (s[8 * c + 6] + s[8 * c + 7]);
    }
    l0 = l0 * alpha0 + ((sum[0][0] + sum[0][1]) + (sum[0][2] + sum[0][3]));
    l1 = l1 * alpha1 + ((sum[1][0] + sum[1][1]) + (sum[1][2] + sum[1][3]));
  }
  return moved;
}

// P (unnormalised) rounded to bf16 A fragments, in place of the score
// accumulators: keys 16 kk .. 16 kk + 15 are accumulator chunks 2 kk, 2 kk + 1.
__device__ __forceinline__ void pack_p(const float (&s)[32], uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// NKS = ceil(D / 16) k16 steps of Q K^T; CB = ceil(D / 64) column blocks; NV =
// the N of O += P V in each column block. NV = 48 (D = 40) puts the row sum
// on the tensor cores: column 40 of every staged V row holds 1.0 (the TMA
// box covers columns 0-39 only), so accumulator column 40 is the f32 sum of
// the bf16 P it multiplies, rescaled with the output. Otherwise NV = 64 and
// the f32 row sum is added on the CUDA cores. Thread t of a consumer
// warpgroup holds, in each m64nN accumulator, rows r = 16 (t / 32) +
// (t % 32) / 4 (registers i with i & 2 == 0) and r + 8 (i & 2 != 0), columns
// 8 (i / 4) + 2 (t % 4) + (i & 1).
template <int NKS, int NV>
__global__ void __launch_bounds__(WG_THREADS, 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       int groups, int lq, int lk, int d, float scale_log2) {
  constexpr int CB = (NKS + 3) / 4;
  constexpr bool SUM_COL = NV == 48;  // the row sum as V's column 40
  using L = Layout<CB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::q, sk = base + L::k, sv = base + L::v;
  const uint32_t q_full = base + L::bar, q_empty = q_full + 8;
  const uint32_t full0 = q_full + 16, empty0 = full0 + 8 * STAGES;

  const int q_tiles = (lq + WG_BQ - 1) / WG_BQ;
  const int tiles = groups * q_tiles;
  const int nk = lk / WG_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // A box narrower than 64 columns leaves each row's last 128 - 2 d bytes as
  // they are: zero them once, so the padded depth of Q K^T reads zeros, and
  // with SUM_COL write V's column 40 as 1.0 (logical 16-byte chunk 5 of row
  // r sits at chunk 5 ^ (r % 8)).
  if (box_cols(d) < COLS) {
    for (uint32_t a = 16 * threadIdx.x; a < L::bar; a += 16 * blockDim.x) {
      uint32_t first = 0;
      if (SUM_COL && a >= L::v && (((a % 128) / 16) ^ ((a - L::v) / 128 % 8)) == 5)
        first = 0x3F80u;  // bf16 1.0 in the chunk's first column
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %2, %2};" ::"r"(base + a), "r"(first), "r"(0)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // seen by TMA and wgmma
  }
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // producer: Q of each work tile, then its K/V tiles through the ring
    if (lane == 0) {
      uint32_t it = 0, local = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
        const int g = tile / q_tiles, q0 = (tile % q_tiles) * WG_BQ;
        if (local > 0) mbar_wait(q_empty, (local - 1) & 1);
        mbar_expect_tx(q_full, CB * WG_BQ * box_cols(d) * 2);
        for (int cb = 0; cb < CB; ++cb)
          tma_load(sq + cb * Q_BLOCK, &tq, cb * COLS, g * lq + q0, q_full);
        for (int j = 0; j < nk; ++j, ++it) {
          const uint32_t s = it % STAGES, use = it / STAGES;
          if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
          const uint32_t full = full0 + 8 * s;
          mbar_expect_tx(full, 2 * CB * WG_BK * box_cols(d) * 2);
          const int row = g * lk + j * WG_BK;
          for (int cb = 0; cb < CB; ++cb) {
            tma_load(sk + (s * CB + cb) * KV_BLOCK, &tk, cb * COLS, row, full);
            tma_load(sv + (s * CB + cb) * KV_BLOCK, &tv, cb * COLS, row, full);
          }
        }
      }
    }
    return;
  }

  // consumers: per key tile S = Q K^T, the online softmax, O += P V
  constexpr int NA = NV / 2;                    // accumulator registers per column block
  constexpr uint32_t STAGE = CB * KV_BLOCK / 16;  // descriptor step from one stage to the next
  const int wg = warp / 4;
  const int row = (warp % 4) * 16 + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);
  const uint64_t dq = sw128_desc(sq + wg * WG_Q_ROWS), dk = sw128_desc(sk), dv = sw128_desc(sv);
  uint32_t it = 0, local = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
    const int g = tile / q_tiles, q0 = (tile % q_tiles) * WG_BQ;
    float acc[CB][NA];
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[cb][i] = 0.f;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    uint32_t p[4][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, alpha0, alpha1;

    mbar_wait(q_full, local & 1);
    for (int j = 0; j < nk; ++j, ++it) {
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
    mbar_arrive(q_empty);  // this tile's Q is no longer read

    // the row sums over the quad, one division, bf16 pairs out
    if (SUM_COL) {  // column 40 (this lane's 40 + col and 41 + col: zero unless col = 0)
      l0 = acc[0][20] + acc[0][21];
      l1 = acc[0][22] + acc[0][23];
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r0 = q0 + wg * 64 + row;  // rows past lq belong to no query of g
    __nv_bfloat16* o0 = o + ((size_t)g * lq + r0) * d;
    __nv_bfloat16* o1 = o0 + 8 * (size_t)d;
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int c8 = 0; c8 < NV / 8; ++c8) {
        const int c = cb * COLS + c8 * 8 + col;
        if (c < d) {
          if (r0 < lq)
            *reinterpret_cast<uint32_t*>(o0 + c) =
                pack_bf16(acc[cb][4 * c8] * inv0, acc[cb][4 * c8 + 1] * inv0);
          if (r0 + 8 < lq)
            *reinterpret_cast<uint32_t*>(o1 + c) =
                pack_bf16(acc[cb][4 * c8 + 2] * inv1, acc[cb][4 * c8 + 3] * inv1);
        }
      }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// [rows, d] bf16, row-major, read in boxes of box_rows x box_cols(d) columns
// with the 128 B swizzle.
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, uint64_t rows, int d,
                uint32_t box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), rows};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols(d)), box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NKS, int NV>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int g, int lq,
                         int lk, int d, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, encode, q, static_cast<uint64_t>(g) * lq, d, WG_BQ) ||
      !tensor_map(&tk, encode, k, static_cast<uint64_t>(g) * lk, d, WG_BK) ||
      !tensor_map(&tv, encode, v, static_cast<uint64_t>(g) * lk, d, WG_BK))
    return cudaErrorInvalidValue;
  const auto kernel = attention_wgmma_kernel<NKS, NV>;
  const int bytes = static_cast<int>(Layout<(NKS + 3) / 4>::dynamic);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = g * ((lq + WG_BQ - 1) / WG_BQ);
  kernel<<<blocks, WG_THREADS, bytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), g, lq,
                                                lk, d, scale * LOG2E);
  return cudaGetLastError();
}

template <int N>
using Int = std::integral_constant<int, N>;

// Calls f(NKS, NV) with the instantiation for head_dim d (8 <= d <= 128,
// d % 8 == 0): NKS = ceil(d / 16), NV = 48 for d = 40 (the row sum as V's
// column 40), else 64.
template <typename F>
auto dispatch_wgmma(int d, F f) {
  switch ((d + 15) / 16) {
    case 1: return f(Int<1>(), Int<64>());
    case 2: return f(Int<2>(), Int<64>());
    case 3: return d == 40 ? f(Int<3>(), Int<48>()) : f(Int<3>(), Int<64>());
    case 4: return f(Int<4>(), Int<64>());
    case 5: return f(Int<5>(), Int<64>());
    case 6: return f(Int<6>(), Int<64>());
    case 7: return f(Int<7>(), Int<64>());
    default: return f(Int<8>(), Int<64>());
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, o: [g, lq, d]; k, v: [g, lk, d], all
// contiguous on CUDA device `device`; `stream` belongs to that device.
// Returns the cudaError_t of the launch.
extern "C" int mf_self_attention(int device, int dtype, const void* q, const void* k,
                                 const void* v, void* o, int g, int lq, int lk, int d,
                                 float scale, void* stream) {
  if (g <= 0 || lq <= 0 || lk <= 0 || lq % BQ || lk % BK || d <= 0 || d > MAX_D)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, o, g, lq, lk, d, scale, s);
  if (dtype != 1 || d % 8) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  return (int)dispatch_wgmma(d, [&](auto nks, auto nv) {
    return launch_wgmma<decltype(nks)::value, decltype(nv)::value>(q, k, v, o, g, lq, lk, d, scale,
                                                                   s);
  });
}
