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
// float32 (attention_3xtf32_kernel): the products on the tensor cores at
// f32 accuracy, by a three-term TF32 split. Single TF32 products (10-bit
// mantissas) fail the f32 model check; so every f32 operand a becomes
// a_hi = tf32(a) and a_lo = tf32(a - a_hi), and each product is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi in f32 (the dropped a_lo b_lo is ~2^-22
// relative). Bound at the serving shape: 3 x 21.5 GFLOP at 495 TFLOP/s TF32,
// 0.130 ms, under the 0.32 ms of true f32 FMAs on the CUDA cores.
//   - One block of 8 warps per 128 queries of one (b, h); each warp owns 16
//     query rows for the whole key loop (FlashAttention-2's split), so the
//     online softmax needs only the four lanes of a quad, never the block.
//   - Q, K and V reach shared memory by cp.async (16-byte copies, 4-byte
//     ones where a row is not 16-byte aligned): Q once, 64-key K/V tiles
//     through a two-stage ring, so the next tile's copy runs under this
//     tile's products. Rows keep a stride of D' + 4 floats (D' = D rounded
//     up to 8; zeros past D), which makes every fragment read below free of
//     bank conflicts.
//   - S = Q K^T and O += P V are mma.sync.m16n8k8 TF32, fragments in
//     registers, three per product. The S accumulator of a key tile is P's
//     A fragment as it stands: an accumulator holds keys 2t, 2t + 1 of each
//     8-key block where A wants positions t, t + 4, so each thread reads V's
//     rows 2t and 2t + 1 for those positions (a permutation of the keys of
//     the contraction, not a shuffle). No score passes through shared
//     memory.
//   - Online softmax in f32 registers: the running row max over the quad
//     (two shuffles), exp2 with the scale folded in as scale * log2(e), the
//     row sum of the f32 P per thread, one division at the end. Each key
//     tile's P V starts from a zeroed accumulator and is added to the
//     rescaled O in f32: the tensor cores' own accumulation rounds coarser
//     than f32 adds, and over all key tiles in one accumulator the output
//     strays further from the plain version (scripts/prof_k1.py).
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

constexpr int BQ = 64;  // q and k lengths must be multiples of this
constexpr int BK = 64;
constexpr int MAX_D = 128;

// ---------------------------------------------------------------------------
// float32: 3xTF32 mma.sync tiles fed by a cp.async K/V ring

constexpr int TF_BQ = 128;     // queries per block: 8 warps of 16 rows
constexpr int TF_BK = 64;      // keys per ring stage
constexpr int TF_THREADS = 256;

// Shared memory of a block, in floats, for NT = D' / 8 column blocks: Q
// [128][D' + 4], then two stages of K [64][D' + 4] and V [64][D' + 4].
__host__ __device__ constexpr int tf_stride(int nt) { return 8 * nt + 4; }
__host__ __device__ constexpr int tf_floats(int nt) {
  return (TF_BQ + 2 * 2 * TF_BK) * tf_stride(nt);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// a = hi + lo, both TF32 (lo rounds x - hi, which f32 holds exactly)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += A B for one m16n8k8 step: A 16 x 8 row-major fragments (a0: row g,
// col t; a1: row g + 8, col t; a2, a3: cols t + 4), B 8 x 8 (b0: row t, b1:
// row t + 4, col g), d rows g / g + 8, cols 2t, 2t + 1 (g = lane / 4, t =
// lane % 4).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B at f32 accuracy: the small terms first, then hi x hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [0, rows) of a row-major [*, d] f32 matrix at src into shared rows of
// `stride` floats at dst (columns 0 .. d - 1), 16 bytes a copy where vec
__device__ __forceinline__ void copy_rows(uint32_t dst, const float* __restrict__ src, int rows,
                                          int d, int stride, bool vec) {
  if (vec) {
    const int chunks = d / 4;
    for (int e = threadIdx.x; e < rows * chunks; e += TF_THREADS) {
      const int r = e / chunks, c = 4 * (e - r * chunks);
      cp_async16(dst + 4 * (r * stride + c), src + (size_t)r * d + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * d; e += TF_THREADS) {
      const int r = e / d, c = e - r * d;
      cp_async4(dst + 4 * (r * stride + c), src + (size_t)r * d + c);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// NT = ceil(D / 8): k8 steps of Q K^T and n8 column blocks of O. Two
// blocks an SM up to D' = 64 (at most 128 registers a thread), one above.
template <int NT>
__global__ void __launch_bounds__(TF_THREADS, NT <= 8 ? 2 : 1)
attention_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o, int lq, int lk,
                        int d, float scale_log2, int vec) {
  constexpr int S = tf_stride(NT);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const float* sq = sm;                      // [128][S]
  const float* skv = sm + TF_BQ * S;         // stages of K [64][S], V [64][S]
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  const uint32_t q_dst = base, kv_dst = base + 4 * TF_BQ * S;
  constexpr uint32_t STAGE = 2 * TF_BK * S;  // floats of one stage

  const int q_tiles = (lq + TF_BQ - 1) / TF_BQ;
  const int g = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * TF_BQ;
  const int nk = lk / TF_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const float* kg = k + (size_t)g * lk * d;
  const float* vg = v + (size_t)g * lk * d;

  // zeros past column d (the padded depth of Q K^T reads them) and in the
  // rows of a last, partial query tile
  for (int e = threadIdx.x; e < tf_floats(NT) / 4; e += TF_THREADS)
    smem4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  copy_rows(q_dst, q + ((size_t)g * lq + q0) * d, min(TF_BQ, lq - q0), d, S, vec);
  copy_rows(kv_dst, kg, TF_BK, d, S, vec);
  copy_rows(kv_dst + 4 * TF_BK * S, vg, TF_BK, d, S, vec);
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float* qw = sq + (16 * warp) * S;

  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {  // the next tile into the other stage, under this one's products
      const uint32_t dst = kv_dst + 4 * ((j + 1) % 2) * STAGE;
      copy_rows(dst, kg + (size_t)(j + 1) * TF_BK * d, TF_BK, d, S, vec);
      copy_rows(dst + 4 * TF_BK * S, vg + (size_t)(j + 1) * TF_BK * d, TF_BK, d, S, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile j have landed ...
    __syncthreads();     // ... and everyone's
    const float* sk = skv + (j % 2) * STAGE;
    const float* sv = sk + TF_BK * S;

    // S = Q K^T: 16 rows x 64 keys, 8 n8 blocks of keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      uint32_t ah[4], al[4];
      const float* qa = qw + gr * S + 8 * ks + t;
      split_tf32(qa[0], ah[0], al[0]);
      split_tf32(qa[8 * S], ah[1], al[1]);
      split_tf32(qa[4], ah[2], al[2]);
      split_tf32(qa[8 * S + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float* kb = sk + (8 * n + gr) * S + 8 * ks + t;
        mma_3xtf32(s[n], ah, al, kb[0], kb[4]);
      }
    }

    // online softmax on rows gr (registers 0, 1) and gr + 8 (2, 3)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = ex2((m0 - mx0) * scale_log2);  // 0 on the first tile
    const float alpha1 = ex2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float b0 = -mx0 * scale_log2, b1 = -mx1 * scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = ex2(fmaf(s[n][0], scale_log2, b0));
      s[n][1] = ex2(fmaf(s[n][1], scale_log2, b0));
      s[n][2] = ex2(fmaf(s[n][2], scale_log2, b1));
      s[n][3] = ex2(fmaf(s[n][3], scale_log2, b1));
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + sum0;
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
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + 16 * warp + gr;  // rows past lq belong to no query of g
  float* o0 = o + ((size_t)g * lq + r0) * d;
  float* o1 = o0 + 8 * (size_t)d;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < lq) {
      if (c < d) o0[c] = acc[n][0] * inv0;
      if (c + 1 < d) o0[c + 1] = acc[n][1] * inv0;
    }
    if (r0 + 8 < lq) {
      if (c < d) o1[c] = acc[n][2] * inv1;
      if (c + 1 < d) o1[c + 1] = acc[n][3] * inv1;
    }
  }
}

template <int NT>
cudaError_t launch_3xtf32(const void* q, const void* k, const void* v, void* o, int g, int lq,
                          int lk, int d, float scale, cudaStream_t stream) {
  const auto kernel = attention_3xtf32_kernel<NT>;
  const int bytes = static_cast<int>(sizeof(float)) * tf_floats(NT);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const bool vec = d % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const int blocks = g * ((lq + TF_BQ - 1) / TF_BQ);
  kernel<<<blocks, TF_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lq, lk, d, scale * 1.4426950408889634f, vec ? 1 : 0);
  return cudaGetLastError();
}

template <int N>
using Int = std::integral_constant<int, N>;

// Calls f(NT) with NT = ceil(d / 8) for 1 <= d <= 128.
template <typename F>
auto dispatch_3xtf32(int d, F f) {
  switch ((d + 7) / 8) {
    case 1: return f(Int<1>());
    case 2: return f(Int<2>());
    case 3: return f(Int<3>());
    case 4: return f(Int<4>());
    case 5: return f(Int<5>());
    case 6: return f(Int<6>());
    case 7: return f(Int<7>());
    case 8: return f(Int<8>());
    case 9: return f(Int<9>());
    case 10: return f(Int<10>());
    case 11: return f(Int<11>());
    case 12: return f(Int<12>());
    case 13: return f(Int<13>());
    case 14: return f(Int<14>());
    case 15: return f(Int<15>());
    default: return f(Int<16>());
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
  if (dtype == 0)
    return (int)dispatch_3xtf32(
        d, [&](auto nt) { return launch_3xtf32<decltype(nt)::value>(q, k, v, o, g, lq, lk, d, scale, s); });
  if (dtype != 1 || d % 8) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorMisalignedAddress;
  return (int)dispatch_wgmma(d, [&](auto nks, auto nv) {
    return launch_wgmma<decltype(nks)::value, decltype(nv)::value>(q, k, v, o, g, lq, lk, d, scale,
                                                                   s);
  });
}
