// Device code of the triplane sampler family, shared by csrc/sampler.cu (K2,
// K2b, K2c, K2d) and csrc/sampler_stages.cu (S1, S2: K2 stopped after a
// stage). Everything here has internal linkage: each translation unit that
// includes it compiles its own copy.
//
// What is here, in the order K2 runs it:
//   - u_tent, sample_plane, sample_uv: step 1, the window-clamped bilinear
//     fetch of one sample's three plane texels (u weights rounded to bf16);
//   - stage_weights, stage_tile: a shading block's prologue (the head's
//     weights, the tile's direction projections and job table into shared
//     memory);
//   - shade: step 2, the ER-NeRF head on one sample (optionally with every
//     column of its last two products, for S2's "shade" stage);
//   - composite_ray: step 3, one ray's composite in depth order;
//   - launch_tiles, shade_smem, bad_geometry: host-side launch helpers.
// See csrc/sampler.cu for the functions, the bounds and the design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CP = 16;               // channels per texel (12 real + 4 zero)
constexpr int XD = 3 * CP;           // features per sample
constexpr int HID = 64, AUD = 32, EYE = 16;
constexpr int THREADS = 256;
constexpr int MAX_JOB_INTS = 64;
constexpr int N_WEIGHTS = 13;

// shared-memory layout, in floats
constexpr int O_WX = 0;                            // [144][48] (wx_aud|wx_sig|wx_eye)^T
constexpr int O_AUD1 = O_WX + (2 * HID + EYE) * XD;  // [64][32] w_aud1
constexpr int O_AUDSIG = O_AUD1 + HID * AUD;       // [64][32] w_aud_sig^T
constexpr int O_EYE1 = O_AUDSIG + HID * AUD;       // [16] w_eye1[:, 0]
constexpr int O_SIGE = O_EYE1 + EYE;               // [64] w_sig_e[0]
constexpr int O_SIG1 = O_SIGE + HID;               // [64][64] w_sig1^T
constexpr int O_SIGCOL = O_SIG1 + HID * HID;       // [64] w_sigcol[:, 0]
constexpr int O_GEO = O_SIGCOL + HID;              // [64][64] w_geo^T
constexpr int O_COLG = O_GEO + HID * HID;          // [64][64] w_col_g^T
constexpr int O_RGB = O_COLG + HID * HID;          // [64][4] w_rgb[:, 1:4], 0
constexpr int O_CB = O_RGB + 4 * HID;              // [64] col_bias[0]
constexpr int W_FLOATS = O_CB + HID;
static_assert(O_AUD1 % 4 == 0 && O_AUDSIG % 4 == 0 && O_SIG1 % 4 == 0 &&
              O_GEO % 4 == 0 && O_COLG % 4 == 0 && O_RGB % 4 == 0 && W_FLOATS % 4 == 0,
              "float4 rows must stay 16-byte aligned");

struct Weights {
  const void* p[N_WEIGHTS];  // SHADE_WEIGHTS order
};
enum { WX_AUD, W_AUD1, WX_SIG, W_AUD_SIG, WX_EYE, W_EYE1, W_SIG_E, W_SIG1, W_SIGCOL,
       W_GEO, W_COL_G, W_RGB, COL_BIAS };

__device__ __forceinline__ float ld(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <bool RB>
__device__ __forceinline__ float act(float x) { return RB ? bf16r(x) : x; }

// channel c of a texel held as two uint4 of 8 bf16 each, as f32 (c is a
// compile-time constant after unrolling, so this folds to one shift or mask)
__device__ __forceinline__ float channel(const uint4 (&t)[2], int c) {
  const uint4 v = t[c >> 3];
  const int i = (c >> 1) & 3;
  const uint32_t w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  return __uint_as_float((c & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <int K>
__device__ __forceinline__ float dot(const float (&x)[K], const float* __restrict__ w) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    const float4 w4 = *reinterpret_cast<const float4*>(w + k);
    acc = fmaf(x[k], w4.x, acc);
    acc = fmaf(x[k + 1], w4.y, acc);
    acc = fmaf(x[k + 2], w4.z, acc);
    acc = fmaf(x[k + 3], w4.w, acc);
  }
  return acc;
}

template <typename WT>
__device__ void stage_weights(float* s, const Weights& wp) {
  const int tid = threadIdx.x;
  auto W = [&](int i) { return static_cast<const WT*>(wp.p[i]); };
  for (int e = tid; e < XD * HID; e += THREADS) {  // [48][64] sources
    const int k = e / HID, j = e % HID;
    s[O_WX + j * XD + k] = ld(W(WX_AUD), e);
    s[O_WX + (HID + j) * XD + k] = ld(W(WX_SIG), e);
  }
  for (int e = tid; e < XD * EYE; e += THREADS) {
    const int k = e / EYE, j = e % EYE;
    s[O_WX + (2 * HID + j) * XD + k] = ld(W(WX_EYE), e);
  }
  for (int e = tid; e < HID * AUD; e += THREADS) {
    s[O_AUD1 + e] = ld(W(W_AUD1), e);
    const int i = e / HID, j = e % HID;  // w_aud_sig is [32][64]
    s[O_AUDSIG + j * AUD + i] = ld(W(W_AUD_SIG), e);
  }
  for (int e = tid; e < HID * HID; e += THREADS) {
    const int k = e / HID, j = e % HID;
    s[O_SIG1 + j * HID + k] = ld(W(W_SIG1), e);
    s[O_GEO + j * HID + k] = ld(W(W_GEO), e);
    s[O_COLG + j * HID + k] = ld(W(W_COL_G), e);
  }
  for (int e = tid; e < HID; e += THREADS) {
    s[O_SIGE + e] = ld(W(W_SIG_E), e);
    s[O_SIGCOL + e] = ld(W(W_SIGCOL), e * 16);
    s[O_CB + e] = ld(W(COL_BIAS), e);
    s[O_RGB + 4 * e + 0] = ld(W(W_RGB), e * 16 + 1);
    s[O_RGB + 4 * e + 1] = ld(W(W_RGB), e * 16 + 2);
    s[O_RGB + 4 * e + 2] = ld(W(W_RGB), e * 16 + 3);
    s[O_RGB + 4 * e + 3] = 0.f;
  }
  for (int e = tid; e < EYE; e += THREADS) s[O_EYE1 + e] = ld(W(W_EYE1), e * 8);
}

// What shade also computes beside its (sigma, rgb) logits: nothing (K2 and
// its siblings), or, for S2's "shade" stage, every one of the 16 columns of
// the head's last two products (sig_p = h2 w_sigcol, rgb_p = relu(ch)
// w_rgb, whose K2 reads only columns 0 and 1:4) summed into out[16] when
// out is not null, from the full weights staged in shared memory as f32.
struct NoRow {
  static constexpr bool active = false;
};
struct FullRow {
  static constexpr bool active = true;
  const float* sigcol;   // w_sigcol^T [16][64]
  const float* rgb;      // w_rgb [64][16]
  float* out;            // the sample's output row, or null
};

// The head chain of _shade_core on one sample's features x; dp is the ray's
// direction projection row. Returns (sigma logit, r, g, b logits).
template <bool RB, typename Row = NoRow>
__device__ __forceinline__ float4 shade(float (&x)[XD], const float* __restrict__ s,
                                        const float* __restrict__ dp, const Row& row = Row()) {
#pragma unroll
  for (int k = 0; k < XD; ++k) x[k] = act<RB>(x[k]);
  // audio channel attention: aud_ch = relu(x Wa0) Wa1, streamed over units
  float ach[AUD];
#pragma unroll
  for (int i = 0; i < AUD; ++i) ach[i] = 0.f;
#pragma unroll 1
  for (int j = 0; j < HID; ++j) {
    const float a = act<RB>(fmaxf(dot<XD>(x, s + O_WX + j * XD), 0.f));
    const float* w = s + O_AUD1 + j * AUD;
#pragma unroll
    for (int i = 0; i < AUD; i += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + i);
      ach[i] = fmaf(a, w4.x, ach[i]);
      ach[i + 1] = fmaf(a, w4.y, ach[i + 1]);
      ach[i + 2] = fmaf(a, w4.z, ach[i + 2]);
      ach[i + 3] = fmaf(a, w4.w, ach[i + 3]);
    }
  }
#pragma unroll
  for (int i = 0; i < AUD; ++i) ach[i] = act<RB>(ach[i]);
  // eye attention scalar
  float e = 0.f;
#pragma unroll 1
  for (int j = 0; j < EYE; ++j)
    e = fmaf(act<RB>(fmaxf(dot<XD>(x, s + O_WX + (2 * HID + j) * XD), 0.f)),
             s[O_EYE1 + j], e);
  const float eye = 1.f / (1.f + expf(-e));
  // sigma net layer 0: x Ws0 + aud_ch (diag(enc_a) Ws0a) + eye w_e, relu
  float h[HID];
#pragma unroll
  for (int j = 0; j < HID; ++j) {
    const float hv = __fadd_rn(dot<XD>(x, s + O_WX + (HID + j) * XD),
                               dot<AUD>(ach, s + O_AUDSIG + j * AUD));
    h[j] = act<RB>(fmaxf(__fadd_rn(hv, __fmul_rn(eye, s[O_SIGE + j])), 0.f));
  }
  float h2[HID];
#pragma unroll
  for (int j = 0; j < HID; ++j) h2[j] = act<RB>(fmaxf(dot<HID>(h, s + O_SIG1 + j * HID), 0.f));
  const float sig = dot<HID>(h2, s + O_SIGCOL);
  if constexpr (Row::active) {
    if (row.out != nullptr) {   // sig_p, all columns, each summed in dot's order
#pragma unroll
      for (int c = 0; c < CP; ++c) row.out[c] = dot<HID>(h2, row.sigcol + c * HID);
    }
  }
  float geo[HID];
#pragma unroll
  for (int j = 0; j < HID; ++j) geo[j] = act<RB>(dot<HID>(h2, s + O_GEO + j * HID));
  // colour net: relu(geo Wc0g + dproj + bias) Wc1, streamed over units
  float r0 = 0.f, r1 = 0.f, r2 = 0.f;
  float racc[Row::active ? CP : 1];   // rgb_p, all columns (S2's shade stage)
#pragma unroll
  for (int c = 0; c < (Row::active ? CP : 1); ++c) racc[c] = 0.f;
#pragma unroll 1
  for (int j = 0; j < HID; ++j) {
    const float c = __fadd_rn(__fadd_rn(dot<HID>(geo, s + O_COLG + j * HID), dp[j]),
                              s[O_CB + j]);
    const float cr = act<RB>(fmaxf(c, 0.f));
    const float4 w4 = *reinterpret_cast<const float4*>(s + O_RGB + 4 * j);
    r0 = fmaf(cr, w4.x, r0);
    r1 = fmaf(cr, w4.y, r1);
    r2 = fmaf(cr, w4.z, r2);
    if constexpr (Row::active) {
      if (row.out != nullptr) {
#pragma unroll
        for (int q = 0; q < CP; q += 4) {
          const float4 w = *reinterpret_cast<const float4*>(row.rgb + j * CP + q);
          racc[q] = fmaf(cr, w.x, racc[q]);
          racc[q + 1] = fmaf(cr, w.y, racc[q + 1]);
          racc[q + 2] = fmaf(cr, w.z, racc[q + 2]);
          racc[q + 3] = fmaf(cr, w.w, racc[q + 3]);
        }
      }
    }
  }
  if constexpr (Row::active) {
    if (row.out != nullptr) {
#pragma unroll
      for (int c = 0; c < CP; ++c) row.out[c] = __fadd_rn(row.out[c], racc[c]);
    }
  }
  return make_float4(sig, r0, r1, r2);
}

// The tent weight max(0, 1 - |r - c|) of a window-clamped coordinate c at
// row r, rounded to bf16 as the TPU kernel's u tents are.
__device__ __forceinline__ float u_tent(float r, float c) {
  return bf16r(fmaxf(1.f - fabsf(r - c), 0.f));
}

// Step 1 for one plane: its CP channels at (u, v) (u absolute in the mip
// stack, v mip-local), clamped into the window at (ou, ov), into x[q CP ..].
__device__ __forceinline__ void sample_plane(const __nv_bfloat16* __restrict__ planes, int p,
                                             int ou, int ov, float u, float v, float umax,
                                             float vmax, int rows, int rv, float (&x)[XD],
                                             int q) {
  const size_t plane_elems = (size_t)rows * rv * CP;
  const size_t row_elems = (size_t)rv * CP;
  const float uc = fminf(fmaxf(u - (float)ou, 0.f), umax);
  const float vc = fminf(fmaxf(v - (float)ov, 0.f), vmax);
  const float fi = floorf(uc), fj = floorf(vc);
  const float wu0 = u_tent(fi, uc), wu1 = u_tent(fi + 1.f, uc);
  const float tv0 = fmaxf(1.f - fabsf(fj - vc), 0.f);
  const float tv1 = fmaxf(1.f - fabsf(fj + 1.f - vc), 0.f);
  // in-range jobs (all the planners make) never reach these clamps; they
  // keep any other job table inside the planes
  const int row = min(max(ou + (int)fi, 0), rows - 2);
  const int col = min(max(ov + (int)fj, 0), rv - 2);
  const uint4* a = reinterpret_cast<const uint4*>(
      planes + min(max(p, 0), 2) * plane_elems + row * row_elems + (size_t)col * CP);
  const uint4* b = a + row_elems * 2 / sizeof(uint4);   // next row
  const uint4 t00[2] = {__ldg(a), __ldg(a + 1)}, t01[2] = {__ldg(a + 2), __ldg(a + 3)};
  const uint4 t10[2] = {__ldg(b), __ldg(b + 1)}, t11[2] = {__ldg(b + 2), __ldg(b + 3)};
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const float a00 = channel(t00, c), a01 = channel(t01, c);
    const float a10 = channel(t10, c), a11 = channel(t11, c);
    const float m0 = __fadd_rn(__fmul_rn(wu0, a00), __fmul_rn(wu1, a10));
    const float m1 = __fadd_rn(__fmul_rn(wu0, a01), __fmul_rn(wu1, a11));
    x[q * CP + c] = __fadd_rn(__fmul_rn(m0, tv0), __fmul_rn(m1, tv1));
  }
}

// Step 1 for the three planes of sample `lane` of group g from the explicit
// coordinates uv [3 tiles, kg, 2, sg] of tile t and its job table jobs
// [3][1 + 2 kg].
__device__ __forceinline__ void sample_uv(const __nv_bfloat16* __restrict__ planes,
                                          const int* jobs, const float* __restrict__ uv,
                                          int t, int g, int lane, int kg, int sg, float umax,
                                          float vmax, int rows, int rv, float (&x)[XD]) {
  const int stride = 1 + 2 * kg;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int* job = jobs + q * stride;
    const float* uvq = uv + ((size_t)(t * 3 + q) * kg + g) * 2 * sg;
    sample_plane(planes, job[0], job[1 + 2 * g], job[2 + 2 * g], uvq[lane], uvq[sg + lane],
                 umax, vmax, rows, rv, x, q);
  }
}

__device__ __forceinline__ float rgb_act(float logit) {
  return __fsub_rn(__fmul_rn(1.f / (1.f + expf(-logit)), 1.002f), 0.001f);
}

// Step 3 for ray r of a tile: its k (sigma, rgb) logits in res [kg][rpt][ks],
// its dt; writes the ray's [16] output row.
__device__ __forceinline__ void composite_ray(const float4* __restrict__ res, int r, int kg,
                                              int ks, int sg, float dt, float* __restrict__ out) {
  float acc_sd = 0.f, ws = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  for (int g = 0; g < kg; ++g) {
    for (int j = 0; j < ks; ++j) {
      const float4 v = res[g * sg + r * ks + j];
      const float sd = __fmul_rn(expf(v.x), dt);
      const float alpha = 1.f - expf(-sd);
      const float trans = expf(-acc_sd);
      const float w = trans > 1e-4f ? __fmul_rn(alpha, trans) : 0.f;
      acc_sd = __fadd_rn(acc_sd, sd);
      ws = __fadd_rn(ws, w);
      c0 = __fadd_rn(c0, __fmul_rn(w, rgb_act(v.y)));
      c1 = __fadd_rn(c1, __fmul_rn(w, rgb_act(v.z)));
      c2 = __fadd_rn(c2, __fmul_rn(w, rgb_act(v.w)));
    }
  }
  float4* o = reinterpret_cast<float4*>(out);
  o[0] = make_float4(ws, c0, c1, c2);
  o[1] = o[2] = o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// A shading block's prologue: the head's weights, the tile's direction
// projections (the first 64 lanes of each dp_stride-wide row of dproj) and
// its job table (n_jobs ints) into shared memory.
template <typename WT>
__device__ __forceinline__ void stage_tile(float* s, float* s_dp, int* s_jobs, const Weights& wp,
                                           const WT* __restrict__ dproj, int dp_stride,
                                           const int* __restrict__ jobs, int n_jobs, int t,
                                           int rpt) {
  const int tid = threadIdx.x;
  stage_weights<WT>(s, wp);
  const WT* dp = dproj + (size_t)t * rpt * dp_stride;
  for (int e = tid; e < rpt * HID; e += THREADS) s_dp[e] = ld(dp, (e / HID) * dp_stride + e % HID);
  for (int e = tid; e < n_jobs; e += THREADS) s_jobs[e] = jobs[(size_t)t * n_jobs + e];
}

// Set a kernel's dynamic shared memory, launch one block per tile, and
// return the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch_tiles(Kernel kernel, size_t bytes, int tiles, cudaStream_t stream,
                         Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<tiles, THREADS, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// shared memory of a shading block: the weights, rows floats per ray, the
// samples' float4 results (if any) and the job table
size_t shade_smem(int rpt, int rows, size_t samples) {
  return sizeof(float) * ((size_t)W_FLOATS + (size_t)rpt * rows + 4 * samples)
         + sizeof(int) * MAX_JOB_INTS;
}

bool bad_geometry(int tiles, int rpt, int kg, int ks, int wu, int wv, int rows, int rv,
                  int job_fields) {
  return tiles <= 0 || rpt <= 0 || kg <= 0 || ks <= 0 || kg * ks < 2 ||
         3 * (1 + job_fields * kg) > MAX_JOB_INTS || wu < 2 || wv < 2 || rows < wu || rv < wv;
}

}  // namespace
