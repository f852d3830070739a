// S1 and S2 on sm_90a: K2's stages alone, for profiling where K2's time goes.
//
// Replaces the two Pallas TPU kernels of scripts/prof_r5m.py, replicas of
// K2 (mere_fusion_tpu/ops/pallas_sampler.py _shade_comp_kernel :421) cut
// down to a stage:
//   S1 m1_only  :40 (call :137): for each tile, sample s of a depth group's
//      sg, plane q and group g, the bf16 u tent of s over the job's window
//      rows (u' = clip(u - ou, 0, wu - 1.001), tents max(0, 1 - |r - u'|)
//      rounded to bf16) times the window's first 128 lanes (v columns ov ..
//      ov + 7 x 16 channels, no v interpolation), in f32:
//        blockdiag 0: out [T, sg, 128], summed over q then g;
//        blockdiag 1: out [T, kg sg, 128], row g sg + s summed over q, the
//          tent made as the reference's block-diagonal one,
//          1 - |col - (u' + g wu)| over absolute columns col = g wu + r.
//   S2 sections :153 (call :197), K2 stopped after a stage on K2's operands:
//      win   [T, rpt, 16]: out[r][c] = sum over row blocks b < kg sg / rpt
//            and planes q of x[b rpt + r][q 16 + c], x the samples' 48
//            features in (group, ray, sample) row order (step 1 only);
//      shade [T, rpt, 16]: rows r < rpt of sig_p + rgb_p, all 16 lanes, with
//            sig_p = h2 w_sigcol and rgb_p = relu(ch) w_rgb (steps 1-2);
//      full  [T, rpt, 16]: K2's output (steps 1-3), which is K2's own
//            launch (csrc/sampler.cu): nothing of it is here.
// The windows and the tents' zero rows are the TPU's means of a gather; the
// function is the two rows each tent leaves non-zero, which is what S1
// gathers (each product of two bf16 values is exact in f32, so the sums
// are those of the TPU's f32 matmul accumulation).
//
// Bounds at the profiling operands (scripts/prof_r5k.py: R = 1024, 512^2
// rays in 2048 tiles of 16 x 8, k = 16, kg = 4, wu = 64, wv = 32), each
// input counted as far as the stage reads it (chip_smoke.py stage_bound_ms,
// figures in PERF.md): every job of these operands is on plane 0 inside
// its first 1024 rows, so a stage reads only the texels its samples weigh:
// at most 1024 rows x 1024 texels x 32 B = 34 MB of the 195 MB stack.
//   S1: bytes, dominated by its output (537 MB; blockdiag 2.15 GB) beside
//   the u half of uv (50 MB) and the texels; its 4 f32 operations per
//   output lane and (q, g) take 0.1 ms at the card's f32 rate.
//   S2 win: bytes, uv (101 MB), the texels and 17 MB of output.
//   S2 shade: operations, K2's head and sample over all 48 lanes (these
//   inputs fill the padding): 47,568 per sample, 0.20 ms at 989 TFLOP/s.
//
// Design (simple and right first):
//   - S1: one warp per output row; each lane owns 4 of the 128 lanes, so a
//     warp reads each tent row as 256 contiguous bytes and writes its row
//     as 512; the tent weights are K2's u_tent.
//   - S2: win and shade are K2's kernel stopped after step 1 or 2
//     (stage_kernel below), made of the same device functions with K2's
//     prologue, shared memory and sample-to-thread map, so they run at K2's
//     one block per SM and differ from K2 only in what they leave out. A
//     sample whose result is not stored would be dead code:
//     win sums every feature of every sample into the output, shade stores
//     every sample's logits to shared memory with a store the compiler must
//     keep. shade's 128 rows a tile multiply by the other 15 columns of
//     w_sigcol and 13 of w_rgb, staged in shared memory as f32.

#include "sampler_core.cuh"

namespace {

// S1: blockdiag selects the block-diagonal tent and its [kg sg] rows.
template <bool BLOCKDIAG>
__global__ void __launch_bounds__(THREADS)
m1_only_kernel(const __nv_bfloat16* __restrict__ planes, const int* __restrict__ jobs,
               const float* __restrict__ uv, float* __restrict__ out, int tiles, int sg, int kg,
               int wu, int rows, int rv) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int nrows = BLOCKDIAG ? kg * sg : sg;
  const size_t wid = (size_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (wid >= (size_t)tiles * nrows) return;
  const int t = (int)(wid / nrows);
  const int row = (int)(wid - (size_t)t * nrows);
  const int g0 = BLOCKDIAG ? row / sg : 0;
  const int g1 = BLOCKDIAG ? g0 + 1 : kg;
  const int s = row - g0 * sg;
  const int stride = 1 + 2 * kg;
  const float umax = (float)((double)wu - 1.001);
  const size_t plane_elems = (size_t)rows * rv * CP;
  const size_t row_elems = (size_t)rv * CP;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int q = 0; q < 3; ++q) {
    const int* job = jobs + ((size_t)t * 3 + q) * stride;
    const int p = min(max(job[0], 0), 2);
    for (int g = g0; g < g1; ++g) {
      const int ou = job[1 + 2 * g], ov = job[2 + 2 * g];
      const float u = uv[(((size_t)t * 3 + q) * kg + g) * 2 * sg + s];
      float uc = fminf(fmaxf(u - (float)ou, 0.f), umax);
      if (BLOCKDIAG) uc = __fadd_rn(uc, (float)(g * wu));
      const float fi = floorf(uc);
      const float w0 = u_tent(fi, uc), w1 = u_tent(fi + 1.f, uc);
      // in-range jobs never reach these clamps; they keep others in the planes
      const int r0 = min(max(ou + (int)fi - (BLOCKDIAG ? g * wu : 0), 0), rows - 2);
      const int c0 = min(max(ov, 0), rv - 128 / CP);
      const uint2* a = reinterpret_cast<const uint2*>(
          planes + p * plane_elems + r0 * row_elems + (size_t)c0 * CP + lane * 4);
      const uint2 v0 = __ldg(a), v1 = __ldg(a + row_elems / 4);   // 4 bf16 per uint2
      const uint32_t h0[2] = {v0.x, v0.y}, h1[2] = {v1.x, v1.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t b0 = h0[i >> 1], b1 = h1[i >> 1];
        const float a0 = __uint_as_float((i & 1) ? (b0 & 0xffff0000u) : (b0 << 16));
        const float a1 = __uint_as_float((i & 1) ? (b1 & 0xffff0000u) : (b1 << 16));
        acc[i] = __fadd_rn(acc[i], __fadd_rn(__fmul_rn(w0, a0), __fmul_rn(w1, a1)));
      }
    }
  }
  reinterpret_cast<float4*>(out + wid * 128)[lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// A shared-memory store that the compiler may not remove: the "shade" stage
// keeps every sample's result although nothing reads it back, so the head
// of every sample is timed, as K2's composite reads each one.
__device__ __forceinline__ void store_live(float4* p, float4 v) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(a), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w));
}

enum Stage { STAGE_WIN, STAGE_SHADE };

// float4s of a stage block's per-sample area: K2's kg sg results; for win at
// least a [16] partial sum per thread, for shade one live slot per thread
// and the full w_sigcol^T and w_rgb as f32
__host__ __device__ __forceinline__ int stage_res_rows(int stage, int ns) {
  const int need = stage == STAGE_WIN ? THREADS * CP / 4 : THREADS + 2 * HID * CP / 4;
  return ns > need ? ns : need;
}

// S2's win and shade stages: K2 (csrc/sampler.cu) stopped after
// step 1 or 2, with K2's prologue, shared memory (but the per-sample area's
// minimum above) and sample-to-thread map. win writes out[r][c] = sum over
// the row blocks b and planes q of x[b rpt + r][q CP + c] (needs THREADS %
// rpt == 0: each thread's samples then share one r); shade keeps every
// sample's (sigma, rgb) logits with a store that stays and writes rows r <
// rpt of sig_p + rgb_p, all 16 lanes.
template <typename WT, int STAGE>
__global__ void __launch_bounds__(THREADS, 1)
stage_kernel(const __nv_bfloat16* __restrict__ planes, const int* __restrict__ jobs,
             const float* __restrict__ uv, const WT* __restrict__ dproj,
             const float* __restrict__ dtv, Weights wp, float* __restrict__ out, int rpt, int kg,
             int ks, int wu, int wv, int rows, int rv) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  float* s_dp = s + W_FLOATS;                                  // [rpt][64]
  float4* s_res = reinterpret_cast<float4*>(s_dp + rpt * HID);  // per-sample area
  const int sg = rpt * ks;
  const int ns = kg * sg;
  int* s_jobs = reinterpret_cast<int*>(s_res + stage_res_rows(STAGE, ns));  // [3][1 + 2kg]
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  constexpr bool RB = sizeof(WT) == 2;
  float* s_cols = reinterpret_cast<float*>(s_res + THREADS);   // shade: w_sigcol^T, w_rgb

  stage_tile<WT>(s, s_dp, s_jobs, wp, dproj, HID, jobs, 3 * (1 + 2 * kg), t, rpt);
  if constexpr (STAGE == STAGE_SHADE) {
    for (int e = tid; e < HID * CP; e += THREADS) {
      s_cols[(e % CP) * HID + e / CP] = ld(static_cast<const WT*>(wp.p[W_SIGCOL]), e);
      s_cols[HID * CP + e] = ld(static_cast<const WT*>(wp.p[W_RGB]), e);
    }
  }
  __syncthreads();

  const float umax = (float)((double)wu - 1.001);
  const float vmax = (float)((double)wv - 1.001);
  if constexpr (STAGE == STAGE_WIN) {
    float acc[CP];
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[c] = 0.f;
    for (int n = tid; n < ns; n += THREADS) {
      const int g = n / sg;
      float x[XD];
      sample_uv(planes, s_jobs, uv, t, g, n - g * sg, kg, sg, umax, vmax, rows, rv, x);
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[c] = __fadd_rn(acc[c], x[q * CP + c]);
    }
    float* s_part = reinterpret_cast<float*>(s_res);           // [THREADS][16]
#pragma unroll
    for (int c = 0; c < CP; ++c) s_part[tid * CP + c] = acc[c];
    __syncthreads();
    for (int e = tid; e < rpt * CP; e += THREADS) {
      const int r = e / CP, c = e % CP;
      float v = 0.f;
      for (int b = 0; b < THREADS / rpt; ++b) v = __fadd_rn(v, s_part[(b * rpt + r) * CP + c]);
      out[(size_t)t * rpt * CP + e] = v;
    }
  } else {
    for (int n = tid; n < ns; n += THREADS) {
      const int g = n / sg;
      const int lane = n - g * sg;
      float x[XD];
      sample_uv(planes, s_jobs, uv, t, g, lane, kg, sg, umax, vmax, rows, rv, x);
      const FullRow row = {s_cols, s_cols + HID * CP,
                           n < rpt ? out + ((size_t)t * rpt + n) * CP : nullptr};
      store_live(s_res + tid, shade<RB>(x, s, s_dp + (lane / ks) * HID, row));
    }
  }
}

template <typename WT>
cudaError_t launch_sections(int stage, size_t bytes, int tiles, cudaStream_t s,
                            const __nv_bfloat16* p, const int* j, const float* u, const WT* d,
                            const float* dt, const Weights& wp, float* o, int rpt, int kg,
                            int ks, int wu, int wv, int rows, int rv) {
  switch (stage) {
    case STAGE_WIN:
      return launch_tiles(stage_kernel<WT, STAGE_WIN>, bytes, tiles, s, p, j, u, d, dt, wp, o,
                          rpt, kg, ks, wu, wv, rows, rv);
    case STAGE_SHADE:
      return launch_tiles(stage_kernel<WT, STAGE_SHADE>, bytes, tiles, s, p, j, u, d, dt, wp, o,
                          rpt, kg, ks, wu, wv, rows, rv);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Common arguments as csrc/sampler.cu's K2: planes [3, rows, rv * 16] bf16;
// jobs int32, per tile 3 jobs of (plane, then (ou, ov) per group); uv [3
// tiles, kg, 2, rpt * ks] f32; geometry tiles, rpt, kg, ks, wu, wv, rows, rv.
// All contiguous on CUDA device `device`; `stream` belongs to it. Each
// returns the cudaError_t of its launch.

// S1: out [tiles, sg, 128] f32 (blockdiag: [tiles, kg sg, 128]).
extern "C" int mf_m1_only(int device, int blockdiag, const void* planes, const void* jobs,
                          const void* uv, void* out, int tiles, int rpt, int kg, int ks, int wu,
                          int wv, int rows, int rv, void* stream) {
  if (bad_geometry(tiles, rpt, kg, ks, wu, wv, rows, rv, 2) || wv * CP < 128)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int sg = rpt * ks;
  const size_t warps = (size_t)tiles * sg * (blockdiag ? kg : 1);
  const size_t blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  const auto* p = static_cast<const __nv_bfloat16*>(planes);
  const auto* j = static_cast<const int*>(jobs);
  const auto* u = static_cast<const float*>(uv);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blockdiag)
    m1_only_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(p, j, u, o, tiles, sg, kg, wu,
                                                               rows, rv);
  else
    m1_only_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(p, j, u, o, tiles, sg, kg, wu,
                                                                rows, rv);
  return (int)cudaGetLastError();
}

// S2: stage 0 win, 1 shade; dproj [tiles, rpt, 64] and the 13 shade
// weights in SHADE_WEIGHTS order, all f32 or all bf16 (bf16 != 0); dtv
// [tiles, rpt, 8] f32; out [tiles, rpt, 16] f32. win needs 256 % rpt == 0.
extern "C" int mf_sections(
    int device, int stage, int bf16, const void* planes, const void* jobs, const void* uv,
    const void* dproj, const void* dtv, const void* wx_aud, const void* w_aud1,
    const void* wx_sig, const void* w_aud_sig, const void* wx_eye, const void* w_eye1,
    const void* w_sig_e, const void* w_sig1, const void* w_sigcol, const void* w_geo,
    const void* w_col_g, const void* w_rgb, const void* col_bias, void* out, int tiles,
    int rpt, int kg, int ks, int wu, int wv, int rows, int rv, void* stream) {
  if (bad_geometry(tiles, rpt, kg, ks, wu, wv, rows, rv, 2) || stage < STAGE_WIN ||
      stage > STAGE_SHADE || (stage == STAGE_WIN && THREADS % rpt != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Weights wp = {{wx_aud, w_aud1, wx_sig, w_aud_sig, wx_eye, w_eye1, w_sig_e, w_sig1,
                       w_sigcol, w_geo, w_col_g, w_rgb, col_bias}};
  const size_t bytes = shade_smem(rpt, HID, stage_res_rows(stage, kg * rpt * ks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const __nv_bfloat16*>(planes);
  const auto* j = static_cast<const int*>(jobs);
  const auto* u = static_cast<const float*>(uv);
  const auto* d = static_cast<const float*>(dtv);
  auto* o = static_cast<float*>(out);
  if (bf16)
    return (int)launch_sections(stage, bytes, tiles, s, p, j, u,
                                static_cast<const __nv_bfloat16*>(dproj), d, wp, o, rpt, kg, ks,
                                wu, wv, rows, rv);
  return (int)launch_sections(stage, bytes, tiles, s, p, j, u, static_cast<const float*>(dproj),
                              d, wp, o, rpt, kg, ks, wu, wv, rows, rv);
}
