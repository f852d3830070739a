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
//   inputs fill the padding), 47,568 per sample: 0.20 ms at 989 TFLOP/s
//   with bf16 weights; with f32 weights the lesser of three TF32 products
//   at 495 TFLOP/s and f32 FMAs at 67 TFLOP/s (chip_smoke.py head_ops_ms).
//
// Design (simple and right first):
//   - S1: one warp per output row; each lane owns 4 of the 128 lanes, so a
//     warp reads each tent row as 256 contiguous bytes and writes its row
//     as 512; the tent weights are K2's u_tent.
//   - S2: win and shade are K2's own tensor-core kernels (bf16 weights:
//     sample_shade_comp_wgmma_kernel; f32: sample_shade_comp_tf32_kernel, in
//     csrc/sampler_core.cuh) instantiated to stop after step 1 or 2: the
//     same resident-grid loop, block shape, weight staging and fetch, and
//     for shade the same head, so they differ from K2 only in what they
//     leave out. A sample whose result is not stored would be dead code:
//     win sums every feature of every sample into the output as the fetch
//     makes them (before the head's bf16 rounding), each warpgroup (bf16
//     kernel) or thread (f32 kernel) into its own sums; shade takes the
//     head's last two products over all 16 columns on the tensor cores
//     (m64n16 wgmma, or two m16n8 tiles of three TF32 products), writes rows
//     r < rpt of their sum and keeps every sample's logits with stores the
//     compiler must keep.

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
// weights in SHADE_WEIGHTS order, all f32 or all bf16 (bf16 != 0): K2's
// kernel of that weight dtype stopped after the stage; dtv [tiles, rpt, 8]
// f32 (unread); out [tiles, rpt, 16] f32. win needs 256 % rpt == 0.
extern "C" int mf_sections(
    int device, int stage, int bf16, const void* planes, const void* jobs, const void* uv,
    const void* dproj, const void* dtv, const void* wx_aud, const void* w_aud1,
    const void* wx_sig, const void* w_aud_sig, const void* wx_eye, const void* w_eye1,
    const void* w_sig_e, const void* w_sig1, const void* w_sigcol, const void* w_geo,
    const void* w_col_g, const void* w_rgb, const void* col_bias, void* out, int tiles,
    int rpt, int kg, int ks, int wu, int wv, int rows, int rv, void* stream) {
  if ((stage != STAGE_WIN && stage != STAGE_SHADE) ||
      (stage == STAGE_WIN && (rpt <= 0 || THREADS % rpt != 0)))   // launch_k2 checks the rest
    return (int)cudaErrorInvalidValue;
  const Weights wp = {{wx_aud, w_aud1, wx_sig, w_aud_sig, wx_eye, w_eye1, w_sig_e, w_sig1,
                       w_sigcol, w_geo, w_col_g, w_rgb, col_bias}};
  return stage == STAGE_WIN
             ? launch_k2<STAGE_WIN>(device, bf16, planes, jobs, uv, dproj, dtv, wp, out, tiles,
                                    rpt, kg, ks, wu, wv, rows, rv, 0.f, 0.f, stream)
             : launch_k2<STAGE_SHADE>(device, bf16, planes, jobs, uv, dproj, dtv, wp, out, tiles,
                                      rpt, kg, ks, wu, wv, rows, rv, 0.f, 0.f, stream);
}
