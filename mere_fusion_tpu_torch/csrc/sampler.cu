// K2: fused triplane sample + NeRF head + volume composite per pixel tile
// (sm_90a).
//
// Replaces the Pallas TPU kernel mere_fusion_tpu/ops/pallas_sampler.py:670
// (sample_shade_comp_tiles -> _shade_comp_kernel :421 on _window_machinery
// :149, _shade_core :313, _composite_rows :460). For every pixel tile of rpt
// rays with k samples each (kg depth groups of ks = k/kg), it
//   1. samples the three bf16 triplanes bilinearly inside each (tile, plane,
//      group) job's window: u' = clip(u - ou, 0, wu - 1.001) and likewise v,
//      the two u tent weights rounded to bf16 and the two v weights kept in
//      f32, as the TPU kernel's two-hot products round them;
//   2. runs the ER-NeRF head (audio channel attention, sigma net with the
//      eye attention, colour net) on the 48 features, rounding the left
//      operand of every product to bf16 when the weights are bf16, with f32
//      accumulation, as _shade_core's mm does;
//   3. composites each ray's samples in depth order: sigma = exp(logit),
//      alpha = 1 - exp(-sigma dt), T = exp(-sum of earlier sigma dt),
//      weight = alpha T where T > 1e-4, rgb = sigmoid(logit) 1.002 - 0.001,
//      and writes [T, rpt, 16]: lane 0 sum of weights, lanes 1:4 sum of
//      weight rgb, the rest 0.
//
// Bound at serving size (512^2 frame, 16 x 8 tiles: T = 2048, rpt = 128,
// k = 16, so 4.19 M samples): the head is 21,840 multiply-adds per sample
// over the 36 real features (the 12 zero lanes of padding are not work),
// plus 9 operations per real channel of the bilinear sample: 44,004
// operations, ~0.185 TFLOP per frame, 0.187 ms at the H100's 989 TFLOP/s
// bf16 tensor rate; the operands (uv 100 MB, the 195 MB bf16 plane stack counted whole, dproj
// 34 MB, dtv and out 25 MB) take ~0.11 ms at 3.35 TB/s. So the bound is set
// by operations.
//
// Design (simple and right first; tensor cores are later work):
//   - one block of 256 threads per tile; the head's weights (~95 KB as f32,
//     transposed so each output's weights are contiguous) and the tile's
//     direction projections are staged once into shared memory;
//   - each thread takes samples n = tid, tid + 256, ... of the tile and runs
//     all of steps 1-2 for it in registers: texels are gathered straight
//     from global memory (a job's window is local, so L1/L2 serve the reuse
//     that the TPU kernel got from its DMA'd windows), features and hidden
//     layers never leave the thread, and only (sigma logit, 3 rgb logits)
//     go to shared memory;
//   - then one thread per ray folds its k samples in order, so the
//     transmittance needs no scan.
// The head's products run as f32 FMAs on the CUDA cores (exact products of
// bf16-rounded operands); the next step is mma.sync/wgmma tiles of 64-wide
// layers over a tile's samples and a cp.async window ring.

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

// The head chain of _shade_core on one sample's features x; dp is the ray's
// direction projection row. Returns (sigma logit, r, g, b logits).
template <bool RB>
__device__ __forceinline__ float4 shade(float (&x)[XD], const float* __restrict__ s,
                                        const float* __restrict__ dp) {
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
  float geo[HID];
#pragma unroll
  for (int j = 0; j < HID; ++j) geo[j] = act<RB>(dot<HID>(h2, s + O_GEO + j * HID));
  // colour net: relu(geo Wc0g + dproj + bias) Wc1, streamed over units
  float r0 = 0.f, r1 = 0.f, r2 = 0.f;
#pragma unroll 1
  for (int j = 0; j < HID; ++j) {
    const float c = __fadd_rn(__fadd_rn(dot<HID>(geo, s + O_COLG + j * HID), dp[j]),
                              s[O_CB + j]);
    const float cr = act<RB>(fmaxf(c, 0.f));
    const float4 w4 = *reinterpret_cast<const float4*>(s + O_RGB + 4 * j);
    r0 = fmaf(cr, w4.x, r0);
    r1 = fmaf(cr, w4.y, r1);
    r2 = fmaf(cr, w4.z, r2);
  }
  return make_float4(sig, r0, r1, r2);
}

// WT: the dtype of the shade weights and of dproj (float or bf16).
template <typename WT>
__global__ void __launch_bounds__(THREADS, 1)
sample_shade_comp_kernel(const __nv_bfloat16* __restrict__ planes, const int* __restrict__ jobs,
                         const float* __restrict__ uv, const WT* __restrict__ dproj,
                         const float* __restrict__ dtv, Weights wp, float* __restrict__ out,
                         int rpt, int kg, int ks, int wu, int wv, int rows, int rv) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  float* s_dp = s + W_FLOATS;                                  // [rpt][64]
  float4* s_res = reinterpret_cast<float4*>(s_dp + rpt * HID);  // [kg * sg]
  const int sg = rpt * ks;
  const int ns = kg * sg;
  int* s_jobs = reinterpret_cast<int*>(s_res + ns);            // [3][1 + 2kg]
  const int stride = 1 + 2 * kg;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  constexpr bool RB = sizeof(WT) == 2;

  stage_weights<WT>(s, wp);
  for (int e = tid; e < rpt * HID; e += THREADS)
    s_dp[e] = ld(dproj + (size_t)t * rpt * HID, e);
  for (int e = tid; e < 3 * stride; e += THREADS) s_jobs[e] = jobs[(size_t)t * 3 * stride + e];
  __syncthreads();

  const float umax = (float)((double)wu - 1.001);
  const float vmax = (float)((double)wv - 1.001);
  const size_t plane_elems = (size_t)rows * rv * CP;
  const size_t row_elems = (size_t)rv * CP;

  for (int n = tid; n < ns; n += THREADS) {
    const int g = n / sg;
    const int lane = n - g * sg;
    float x[XD];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int* job = s_jobs + q * stride;
      const int p = min(max(job[0], 0), 2);
      const int ou = job[1 + 2 * g], ov = job[2 + 2 * g];
      const float* uvq = uv + ((size_t)(t * 3 + q) * kg + g) * 2 * sg;
      const float uc = fminf(fmaxf(uvq[lane] - (float)ou, 0.f), umax);
      const float vc = fminf(fmaxf(uvq[sg + lane] - (float)ov, 0.f), vmax);
      const float fi = floorf(uc), fj = floorf(vc);
      const float wu0 = bf16r(fmaxf(1.f - fabsf(fi - uc), 0.f));
      const float wu1 = bf16r(fmaxf(1.f - fabsf(fi + 1.f - uc), 0.f));
      const float tv0 = fmaxf(1.f - fabsf(fj - vc), 0.f);
      const float tv1 = fmaxf(1.f - fabsf(fj + 1.f - vc), 0.f);
      // in-range jobs (all the planner makes) never reach these clamps; they
      // keep any other job table inside the planes
      const int row = min(max(ou + (int)fi, 0), rows - 2);
      const int col = min(max(ov + (int)fj, 0), rv - 2);
      const uint4* a = reinterpret_cast<const uint4*>(
          planes + p * plane_elems + row * row_elems + (size_t)col * CP);
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
    const int r = lane / ks;
    s_res[n] = shade<RB>(x, s, s_dp + r * HID);
  }
  __syncthreads();

  for (int r = tid; r < rpt; r += THREADS) {
    const float dt = dtv[((size_t)t * rpt + r) * 8];
    float acc_sd = 0.f, ws = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int g = 0; g < kg; ++g) {
      for (int j = 0; j < ks; ++j) {
        const float4 v = s_res[g * sg + r * ks + j];
        const float sd = __fmul_rn(expf(v.x), dt);
        const float alpha = 1.f - expf(-sd);
        const float trans = expf(-acc_sd);
        const float w = trans > 1e-4f ? __fmul_rn(alpha, trans) : 0.f;
        acc_sd = __fadd_rn(acc_sd, sd);
        ws = __fadd_rn(ws, w);
        const float k0 = __fsub_rn(__fmul_rn(1.f / (1.f + expf(-v.y)), 1.002f), 0.001f);
        const float k1 = __fsub_rn(__fmul_rn(1.f / (1.f + expf(-v.z)), 1.002f), 0.001f);
        const float k2 = __fsub_rn(__fmul_rn(1.f / (1.f + expf(-v.w)), 1.002f), 0.001f);
        c0 = __fadd_rn(c0, __fmul_rn(w, k0));
        c1 = __fadd_rn(c1, __fmul_rn(w, k1));
        c2 = __fadd_rn(c2, __fmul_rn(w, k2));
      }
    }
    float4* o = reinterpret_cast<float4*>(out + ((size_t)t * rpt + r) * 16);
    o[0] = make_float4(ws, c0, c1, c2);
    o[1] = o[2] = o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename WT>
cudaError_t launch(const void* planes, const void* jobs, const void* uv, const void* dproj,
                   const void* dtv, const Weights& wp, void* out, int tiles, int rpt,
                   int kg, int ks, int wu, int wv, int rows, int rv, cudaStream_t stream) {
  const size_t ns = (size_t)kg * rpt * ks;
  const size_t bytes = sizeof(float) * ((size_t)W_FLOATS + (size_t)rpt * HID + 4 * ns)
                       + sizeof(int) * MAX_JOB_INTS;
  auto kernel = sample_shade_comp_kernel<WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<tiles, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(planes), static_cast<const int*>(jobs),
      static_cast<const float*>(uv), static_cast<const WT*>(dproj),
      static_cast<const float*>(dtv), wp, static_cast<float*>(out), rpt, kg, ks, wu, wv,
      rows, rv);
  return cudaGetLastError();
}

}  // namespace

// planes [3, rows, rv * 16] bf16; jobs [tiles * 3 * (1 + 2 kg)] int32; uv
// [3 tiles, kg, 2, rpt * ks] f32; dproj [tiles, rpt, 64] and the 13 shade
// weights in SHADE_WEIGHTS order, all f32 or all bf16 (bf16 != 0); dtv
// [tiles, rpt, 8] f32; out [tiles, rpt, 16] f32. All contiguous on CUDA
// device `device`; `stream` belongs to it. Returns the cudaError_t of the
// launch.
extern "C" int mf_sample_shade_comp(
    int device, int bf16, const void* planes, const void* jobs, const void* uv,
    const void* dproj, const void* dtv, const void* wx_aud, const void* w_aud1,
    const void* wx_sig, const void* w_aud_sig, const void* wx_eye, const void* w_eye1,
    const void* w_sig_e, const void* w_sig1, const void* w_sigcol, const void* w_geo,
    const void* w_col_g, const void* w_rgb, const void* col_bias, void* out, int tiles,
    int rpt, int kg, int ks, int wu, int wv, int rows, int rv, void* stream) {
  if (tiles <= 0 || rpt <= 0 || kg <= 0 || ks <= 0 || 3 * (1 + 2 * kg) > MAX_JOB_INTS ||
      wu < 2 || wv < 2 || rows < wu || rv < wv)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Weights wp = {{wx_aud, w_aud1, wx_sig, w_aud_sig, wx_eye, w_eye1, w_sig_e, w_sig1,
                       w_sigcol, w_geo, w_col_g, w_rgb, col_bias}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch<__nv_bfloat16>(planes, jobs, uv, dproj, dtv, wp, out, tiles, rpt, kg,
                                      ks, wu, wv, rows, rv, s);
  return (int)launch<float>(planes, jobs, uv, dproj, dtv, wp, out, tiles, rpt, kg, ks, wu,
                            wv, rows, rv, s);
}
