// Device code of the triplane sampler family, shared by csrc/sampler.cu (K2,
// K2b, K2c, K2d) and csrc/sampler_stages.cu (S1, S2: K2 stopped after a
// stage). Everything here has internal linkage: each translation unit that
// includes it compiles its own copy.
//
// What is here, in the order K2 runs it:
//   - u_tent, sample_plane, sample_uv, sample_ray: step 1, the
//     window-clamped bilinear fetch of one sample's three plane texels (u
//     weights rounded to bf16), at explicit coordinates or (K2c) at
//     coordinates made from the sample's ray;
//   - rgb_act, composite_ray, write_rows: step 3, one ray's composite in
//     depth order, or K2b's activated rows per sample;
//   - bad_geometry: the launchers' check of a geometry;
//   - stage_head_weights, write_x_half, head_rows, head_smem: step 2 with
//     bf16 weights on the tensor cores, 64 samples at a time (K2's head);
//   - stage_tf32_weights, head_tf32, tf32_smem: step 2 with f32 weights on
//     the tensor cores as three TF32 products a term, 32 samples a warp;
//   - sample_shade_comp_wgmma_kernel, sample_shade_comp_tf32_kernel: K2
//     with bf16 and with f32 weights, templates on what they run (Stage:
//     the whole of K2, S2's win and shade stages, K2b, K2c), and
//     launch_resident, launch_k2;
//   - staged_stride, stage_runs, launch_fetch: the cp.async staging and the
//     launch of the fetch-only kernels, S1 (csrc/sampler_stages.cu) and K2d
//     (csrc/sampler.cu).
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
constexpr size_t MAX_SMEM = 232448;   // dynamic shared memory a block may use (sm_90)
constexpr int N_WEIGHTS = 13;

// What an instance of K2's kernels runs: all of K2 (full); K2 stopped after
// the fetch (win) or the head (shade), S2's stages (csrc/sampler_stages.cu);
// K2b, whose tile writes each sample's activated sigma and rgb in place of
// the composite (rows); K2c, which makes each sample's coordinates from its
// ray (rays). The value is the template argument in the instance's mangled
// name (ops/sampler.py STAGES).
enum Stage { STAGE_WIN, STAGE_SHADE, STAGE_FULL, STAGE_ROWS, STAGE_RAYS };

// dproj's row stride in values: K2b takes rows of 128 (lanes 64 and up unread)
__host__ __device__ constexpr int dp_stride(int stage) {
  return stage == STAGE_ROWS ? 2 * HID : HID;
}

struct Weights {
  const void* p[N_WEIGHTS];  // SHADE_WEIGHTS order
};
enum { WX_AUD, W_AUD1, WX_SIG, W_AUD_SIG, WX_EYE, W_EYE1, W_SIG_E, W_SIG1, W_SIGCOL,
       W_GEO, W_COL_G, W_RGB, COL_BIAS };

__device__ __forceinline__ float ld(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// channel c of a texel held as uint4s of 8 bf16 each, as f32 (c is a
// compile-time constant after unrolling, so this folds to one shift or mask)
template <int H>
__device__ __forceinline__ float channel(const uint4 (&t)[H], int c) {
  const uint4 v = t[c >> 3];
  const int i = (c >> 1) & 3;
  const uint32_t w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  return __uint_as_float((c & 1) ? (w & 0xffff0000u) : (w << 16));
}

// The tent weight max(0, 1 - |r - c|) of a window-clamped coordinate c at
// row r, rounded to bf16 as the TPU kernel's u tents are.
__device__ __forceinline__ float u_tent(float r, float c) {
  return bf16r(fmaxf(1.f - fabsf(r - c), 0.f));
}

// Step 1 for one plane: its channels at (u, v) (u absolute in the mip
// stack, v mip-local), clamped into the window at (ou, ov), into x: all CP
// (HALVES = 2) into x[q CP ..], or the 8 of half h0 (HALVES = 1) into
// x[8 q ..].
template <int HALVES = 2>
__device__ __forceinline__ void sample_plane(const __nv_bfloat16* __restrict__ planes, int p,
                                             int ou, int ov, float u, float v, float umax,
                                             float vmax, int rows, int rv,
                                             float (&x)[3 * 8 * HALVES], int q, int h0 = 0) {
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
      planes + min(max(p, 0), 2) * plane_elems + row * row_elems + (size_t)col * CP) + h0;
  const uint4* b = a + row_elems * 2 / sizeof(uint4);   // next row
  uint4 t00[HALVES], t01[HALVES], t10[HALVES], t11[HALVES];
#pragma unroll
  for (int k = 0; k < HALVES; ++k) {
    t00[k] = __ldg(a + k);
    t01[k] = __ldg(a + 2 + k);
    t10[k] = __ldg(b + k);
    t11[k] = __ldg(b + 2 + k);
  }
#pragma unroll
  for (int c = 0; c < 8 * HALVES; ++c) {
    const float a00 = channel(t00, c), a01 = channel(t01, c);
    const float a10 = channel(t10, c), a11 = channel(t11, c);
    const float m0 = __fadd_rn(__fmul_rn(wu0, a00), __fmul_rn(wu1, a10));
    const float m1 = __fadd_rn(__fmul_rn(wu0, a01), __fmul_rn(wu1, a11));
    x[q * 8 * HALVES + c] = __fadd_rn(__fmul_rn(m0, tv0), __fmul_rn(m1, tv1));
  }
}

// Step 1 for the three planes of sample `lane` of group g from the explicit
// coordinates uv [3 tiles, kg, 2, sg] of tile t and its job table jobs
// [3][1 + 2 kg]: all channels, or (HALVES = 1) half h0 of each plane's.
template <int HALVES = 2>
__device__ __forceinline__ void sample_uv(const __nv_bfloat16* __restrict__ planes,
                                          const int* jobs, const float* __restrict__ uv,
                                          int t, int g, int lane, int kg, int sg, float umax,
                                          float vmax, int rows, int rv,
                                          float (&x)[3 * 8 * HALVES], int h0 = 0) {
  const int stride = 1 + 2 * kg;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int* job = jobs + q * stride;
    const float* uvq = uv + ((size_t)(t * 3 + q) * kg + g) * 2 * sg;
    sample_plane<HALVES>(planes, job[0], job[1 + 2 * g], job[2 + 2 * g], uvq[lane],
                         uvq[sg + lane], umax, vmax, rows, rv, x, q, h0);
  }
}

// Step 1 for the three planes of sample j of group g of one ray (its row
// of rays [8]: o, d, zmin, zmax, read through L1) with K2c's job table
// [3][1 + 4 kg] (plane, then (ou, ov, lvl, mip_base) per group). The
// sample's coordinates are made as _render_rays_kernel makes them, each
// operation rounded on its own as ops/sampler.py rays_uv rounds it: kf =
// (g ks + j) / (k - 1), a true division; z = zmin + span kf; xyz = clip(o +
// d z); texel (xyz + bound) scale - 0.5; at the job's mip level tex 2^-lvl +
// 0.5 2^-lvl - 0.5, + mip_base for u. All channels, or (HALVES = 1) half h0
// of each plane's.
template <int HALVES = 2>
__device__ __forceinline__ void sample_ray(const __nv_bfloat16* __restrict__ planes,
                                           const int* jobs, const float* __restrict__ ray,
                                           int g, int j, int kg, int ks, float bound,
                                           float scale, float umax, float vmax, int rows,
                                           int rv, float (&x)[3 * 8 * HALVES], int h0 = 0) {
  const int stride = 1 + 4 * kg;
  const float kf = __fdiv_rn((float)(g * ks + j), (float)(kg * ks - 1));
  const float zmin = __ldg(ray + 6);
  const float z = __fadd_rn(zmin, __fmul_rn(__fsub_rn(__ldg(ray + 7), zmin), kf));
  float tex[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float xyz =
        fminf(fmaxf(__fadd_rn(__ldg(ray + c), __fmul_rn(__ldg(ray + 3 + c), z)), -bound), bound);
    tex[c] = __fsub_rn(__fmul_rn(__fadd_rn(xyz, bound), scale), 0.5f);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {   // planes xy (x, y), yz (z, y), xz (z, x)
    const int* job = jobs + q * stride + 4 * g;
    const float inv = ldexpf(1.f, -job[3]);                  // 2^-lvl
    const float cv = __fsub_rn(__fmul_rn(0.5f, inv), 0.5f);
    const float cu = __fadd_rn(cv, (float)job[4]);
    const float u = __fadd_rn(__fmul_rn(tex[q == 0 ? 0 : 2], inv), cu);
    const float v = __fadd_rn(__fmul_rn(tex[q == 2 ? 0 : 1], inv), cv);
    sample_plane<HALVES>(planes, jobs[q * stride], job[1], job[2], u, v, umax, vmax, rows, rv, x,
                         q, h0);
  }
}

// Step 1 for sample n of tile t in an instance of K2's kernels: from uv [3
// tiles, kg, 2, sg] (coords; every stage but rays) or from the sample's ray
// in rays [tiles, rpt, 8] (coords; rays), with the tile's job table jobs.
template <int STAGE, int HALVES>
__device__ __forceinline__ void fetch(const __nv_bfloat16* __restrict__ planes, const int* jobs,
                                      const float* __restrict__ coords, int t, int n, int rpt,
                                      int kg, int ks, float bound, float scale, float umax,
                                      float vmax, int rows, int rv, float (&x)[24 * HALVES],
                                      int h) {
  const int sg = rpt * ks, g = n / sg, lane = n - g * sg;
  if constexpr (STAGE == STAGE_RAYS) {
    const int r = lane / ks;
    sample_ray<HALVES>(planes, jobs, coords + ((size_t)t * rpt + r) * 8, g, lane - r * ks, kg, ks,
                       bound, scale, umax, vmax, rows, rv, x, h);
  } else {
    sample_uv<HALVES>(planes, jobs, coords, t, g, lane, kg, sg, umax, vmax, rows, rv, x, h);
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

// Ray `row` (tile t's ray r at t rpt + r)'s dt for the composite: lane 0 of
// its dtv row (K2), or span / k of its ray (K2c, STAGE_RAYS; a true division)
template <int STAGE>
__device__ __forceinline__ float ray_dt(const float* __restrict__ dtv,
                                        const float* __restrict__ rays, size_t row, int k) {
  if constexpr (STAGE == STAGE_RAYS)
    return __fdiv_rn(__fsub_rn(__ldg(rays + row * 8 + 7), __ldg(rays + row * 8 + 6)), (float)k);
  else
    return dtv[row * 8];
}

// K2b's tile: each sample n's activated sigma = exp(logit) and rgb_act of
// its rgb logits (res[n]), then 12 zero lanes, as rows [ns][16] f32 at out;
// the block's NTHREADS threads store neighbouring 16-byte chunks.
template <int NTHREADS>
__device__ __forceinline__ void write_rows(const float4* __restrict__ res, int ns,
                                           float* __restrict__ out) {
  float4* o = reinterpret_cast<float4*>(out);
  for (int e = threadIdx.x; e < 4 * ns; e += NTHREADS) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e % 4 == 0) {
      const float4 l = res[e / 4];
      v = make_float4(expf(l.x), rgb_act(l.y), rgb_act(l.z), rgb_act(l.w));
    }
    o[e] = v;
  }
}

bool bad_geometry(int tiles, int rpt, int kg, int ks, int wu, int wv, int rows, int rv,
                  int job_fields) {
  return tiles <= 0 || rpt <= 0 || kg <= 0 || ks <= 0 || kg * ks < 2 ||
         3 * (1 + job_fields * kg) > MAX_JOB_INTS || wu < 2 || wv < 2 || rows < wu || rv < wv;
}

// ---------------------------------------------------------------------------
// Step 2 with bf16 weights on the tensor cores: a warpgroup (128 threads)
// runs the head on a row block of 64 samples as a chain of wgmma products,
// M = 64 samples, K = 48 features or 64 (32) hidden units, N = a layer's
// width. Every left operand is already rounded to bf16 and the weights are
// bf16, so the products are exact and only the order of the f32 sums
// differs from the plain version's sequential f32 FMAs.
//   - The weights are staged once per block as W^T tiles [N][K] of 128-byte
//     rows with the 128 B swizzle wgmma reads (K-major B operands); the
//     fetch writes each sample's 48 features as bf16 into a swizzled row of
//     an x tile, the A operand of the first products.
//   - A layer's f32 accumulator goes through its relu, f32 adds and bf16
//     rounding in registers and becomes the next product's A fragment: the
//     m64nN accumulator's n8 chunks 2kk, 2kk + 1 are the k16 block kk of A
//     (thread t of the warpgroup holds rows r = 16 (t / 32) + (t % 32) / 4 and
//     r + 8, columns 8 (i / 4) + 2 (t % 4) + (i & 1) of register i).
//   - The narrow products (sigma's 64 -> 1, rgb's 64 -> 3) are dots on the
//     accumulator lanes: each thread's 16 columns, then the quad's four lanes
//     by shuffles; the eye's 16 -> 1, whose sigmoid feeds a rounded layer,
//     is summed in the plain version's order from its row's 16 values.
//   - Values near a bf16 rounding tie are summed again in the plain
//     version's order (settle, below).

constexpr int WG_SIZE = 128;                  // threads of a warpgroup
constexpr int HEAD_WGS = 3;                   // warpgroups of a K2 block
constexpr int HEAD_THREADS = WG_SIZE * HEAD_WGS;
constexpr int HEAD_ROWS = 64;                 // samples of a row block (wgmma's M)
constexpr uint32_t ROW_BYTES = 128;           // one swizzled row: 64 bf16

// shared memory of the head, bytes from a 1024-aligned base: W^T tiles
constexpr uint32_t H_WXA = 0;                          // [64][48] wx_aud^T
constexpr uint32_t H_WXS = H_WXA + HID * ROW_BYTES;    // [64][48] wx_sig^T
constexpr uint32_t H_SIG1 = H_WXS + HID * ROW_BYTES;   // [64][64] w_sig1^T
constexpr uint32_t H_GEO = H_SIG1 + HID * ROW_BYTES;   // [64][64] w_geo^T
constexpr uint32_t H_COLG = H_GEO + HID * ROW_BYTES;   // [64][64] w_col_g^T
constexpr uint32_t H_AUDSIG = H_COLG + HID * ROW_BYTES;  // [64][32] w_aud_sig^T
constexpr uint32_t H_AUD1 = H_AUDSIG + HID * ROW_BYTES;  // [32][64] w_aud1^T
constexpr uint32_t H_WXE = H_AUD1 + AUD * ROW_BYTES;   // [16][48] wx_eye^T
constexpr uint32_t H_VEC = H_WXE + EYE * ROW_BYTES;    // f32 vectors below
constexpr int V_EYE1 = 0, V_SIGE = V_EYE1 + EYE, V_SIGCOL = V_SIGE + HID,
              V_RGB = V_SIGCOL + HID, V_CB = V_RGB + 4 * HID, V_FLOATS = V_CB + HID;
constexpr uint32_t H_X = H_VEC + ((4 * V_FLOATS + 1023) / 1024) * 1024;  // x tiles
constexpr uint32_t X_TILE = HEAD_ROWS * ROW_BYTES;     // one row block's x
constexpr uint32_t H_SCRATCH = H_X + HEAD_WGS * X_TILE;  // 16 rows a warp (settle)
constexpr uint32_t SCRATCH_WARP = 16 * ROW_BYTES;
constexpr uint32_t H_FIXED = H_SCRATCH + HEAD_WGS * 4 * SCRATCH_WARP;  // then dp, results, jobs
// S2's shade stage only: w_sigcol^T and w_rgb^T [16][64] (every column of
// the head's last two products), between the fixed part and dp
constexpr uint32_t H_WIDE = H_FIXED;
constexpr uint32_t H_WIDE_BYTES = 2 * CP * ROW_BYTES;
static_assert(H_WXE % 1024 == 0 && H_X % 1024 == 0 && H_FIXED % 1024 == 0,
              "swizzled tiles start on 1024-byte boundaries");

// shared memory of a K2 block with the tensor-core head: the fixed part,
// the tile's dproj rows as bf16, the samples' float4 results, the job table,
// and slack to align the base
size_t head_smem(int rpt, size_t samples) {
  return (size_t)H_FIXED + (size_t)rpt * HID * 2 + 16 * samples + sizeof(int) * MAX_JOB_INTS +
         1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a 128 B swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The bf16 weights into the head's layout (sm: the 1024-aligned base; for
// the shade stage also the wide tiles), then a proxy fence so that wgmma
// (the async proxy) sees them after a barrier.
template <int STAGE>
__device__ void stage_head_weights(uint8_t* sm, const Weights& wp) {
  auto W = [&](int i) { return static_cast<const uint16_t*>(wp.p[i]); };
  // w [K][N] row-major -> the tile W^T [N][K], one 16-byte chunk (8 k of one n) a step
  auto tile = [&](uint32_t off, const uint16_t* w, int k_dim, int n_dim) {
    const int chunks = k_dim / 8;
    for (int e = threadIdx.x; e < n_dim * chunks; e += HEAD_THREADS) {
      const int n = e / chunks, c = e - n * chunks;
      uint32_t v[4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        v[h] = (uint32_t)w[(8 * c + 2 * h) * n_dim + n] |
               ((uint32_t)w[(8 * c + 2 * h + 1) * n_dim + n] << 16);
      *reinterpret_cast<uint4*>(sm + off + swz(n, c)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  tile(H_WXA, W(WX_AUD), XD, HID);
  tile(H_WXS, W(WX_SIG), XD, HID);
  tile(H_WXE, W(WX_EYE), XD, EYE);
  tile(H_AUD1, W(W_AUD1), HID, AUD);
  tile(H_AUDSIG, W(W_AUD_SIG), AUD, HID);
  tile(H_SIG1, W(W_SIG1), HID, HID);
  tile(H_GEO, W(W_GEO), HID, HID);
  tile(H_COLG, W(W_COL_G), HID, HID);
  if constexpr (STAGE == STAGE_SHADE) {
    tile(H_WIDE, W(W_SIGCOL), HID, CP);
    tile(H_WIDE + CP * ROW_BYTES, W(W_RGB), HID, CP);
  }
  float* vec = reinterpret_cast<float*>(sm + H_VEC);
  auto bf = [&](int i) { return static_cast<const __nv_bfloat16*>(wp.p[i]); };
  for (int e = threadIdx.x; e < HID; e += HEAD_THREADS) {
    vec[V_SIGE + e] = ld(bf(W_SIG_E), e);
    vec[V_SIGCOL + e] = ld(bf(W_SIGCOL), e * 16);
    vec[V_CB + e] = ld(bf(COL_BIAS), e);
    vec[V_RGB + 4 * e + 0] = ld(bf(W_RGB), e * 16 + 1);
    vec[V_RGB + 4 * e + 1] = ld(bf(W_RGB), e * 16 + 2);
    vec[V_RGB + 4 * e + 2] = ld(bf(W_RGB), e * 16 + 3);
    vec[V_RGB + 4 * e + 3] = 0.f;
  }
  for (int e = threadIdx.x; e < EYE; e += HEAD_THREADS) vec[V_EYE1 + e] = ld(bf(W_EYE1), e * 8);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Half h of one sample's features (channels 8h .. 8h + 7 of each plane,
// x[8 q + c]), rounded to bf16, into row r of a swizzled x tile.
__device__ __forceinline__ void write_x_half(uint8_t* x_tile, int r, int h, const float (&x)[24]) {
#pragma unroll
  for (int q = 0; q < 3; ++q)
    *reinterpret_cast<uint4*>(x_tile + swz(r, 2 * q + h)) =
        make_uint4(pack_bf16(x[8 * q], x[8 * q + 1]), pack_bf16(x[8 * q + 2], x[8 * q + 3]),
                   pack_bf16(x[8 * q + 4], x[8 * q + 5]), pack_bf16(x[8 * q + 6], x[8 * q + 7]));
}

// wgmma descriptor of a K-major tile of 128 B swizzled rows (8-row groups
// 1024 bytes apart); +2 steps 32 bytes (16 bf16 of K) along the rows.
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

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma writes (accumulators) or reads (A fragments) across
// the window between its start and the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < 4 * N; ++i) asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}

#define MF_R8(b) "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), \
                 "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define MF_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define MF_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define MF_D32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B, m64nNk16 bf16 -> f32, B K-major in shared memory; A in shared
// memory (ss, K-major) or registers (rs); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MF_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MF_R8(0), MF_R8(8), MF_R8(16), MF_R8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " MF_D8
      ", %8, %9, p, 1, 1, 0, 0;\n}\n"
      : MF_R8(0)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MF_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : MF_R8(0), MF_R8(8), MF_R8(16), MF_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " MF_D8
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : MF_R8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " MF_D16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : MF_R8(0), MF_R8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// a compile-time bool a generic lambda can take as an argument
template <bool V>
struct BoolC {
  static constexpr bool value = V;
};

// a k16 step's index as a compile-time constant that device code can convert
template <int V>
struct Step {
  static constexpr int value = V;
  __host__ __device__ constexpr operator int() const { return V; }
};

// acc = the sum over STEPS k16 steps of their products in one tensor-core
// accumulator: start(acc, s, accumulate) starts step s, a compile-time Step
// so that A fragments stay in registers.
template <int S, int STEPS, int N, typename Start>
__device__ __forceinline__ void start_steps(float (&acc)[N], Start& start) {
  start(acc, Step<S>(), S > 0);
  if constexpr (S + 1 < STEPS) start_steps<S + 1, STEPS>(acc, start);
}

template <int STEPS, int N, typename Start>
__device__ __forceinline__ void chain(float (&acc)[N], Start start) {
  wgmma_fence();
  start_steps<0, STEPS>(acc, start);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// the accumulator rounded to bf16 A fragments: register i of d feeds k16
// block i / 8
template <int N>
__device__ __forceinline__ void to_a(const float (&d)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int h = 0; h < 4; ++h) a[kk][h] = pack_bf16(d[8 * kk + 2 * h], d[8 * kk + 2 * h + 1]);
}

// the sum (the largest value) over the four lanes of a quad: one row's columns
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Rounding ties. The tensor cores sum a layer's products in another order
// than the plain version's sequential f32 FMAs; the two f32 sums differ by
// an ulp or so, which rounds a hidden value to the other bf16 neighbour where
// it lies that close to a tie (the midpoint of two bf16 values), and such a
// flip moves K2's output by up to ~2e-5. So every value within TIE of its
// row's largest magnitude from a tie is summed again on the CUDA cores in
// the sequential order (k = 0, 1, ..., fmaf from 0), and rounds as the plain
// version rounds it. TIE is 2^-21: twice the largest relative difference
// read between the two orders (scripts/prof_k2.py, "dump").
constexpr float TIE = 4.76837158203125e-07f;   // 2^-21

__device__ __forceinline__ bool near_tie(float v, float thr) {
  const float mid = __uint_as_float((__float_as_uint(v) & 0xFFFF0000u) | 0x8000u);
  return fabsf(v) > thr && fabsf(v - mid) <= thr;
}

// bit i set: register i of v lies near a tie (row thresholds from the quad)
template <int N>
__device__ __forceinline__ uint32_t ties(const float (&v)[N]) {
  float m0 = 0.f, m1 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i & 2) m1 = fmaxf(m1, fabsf(v[i]));
    else m0 = fmaxf(m0, fabsf(v[i]));
  }
  const float thr0 = quad_max(m0) * TIE, thr1 = quad_max(m1) * TIE;
  uint32_t need = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (near_tie(v[i], (i & 2) ? thr1 : thr0)) need |= 1u << i;
  return need;
}

// v + a w over the two bf16 of each of a and w, in order (low half first)
__device__ __forceinline__ float fma_pair(uint32_t a, uint32_t w, float v) {
  v = fmaf(__uint_as_float(a << 16), __uint_as_float(w << 16), v);
  return fmaf(__uint_as_float(a & 0xFFFF0000u), __uint_as_float(w & 0xFFFF0000u), v);
}

// the sequential f32 dot (k = 0, 1, ..., fmaf from 0) of the K inputs in row
// `row` of a swizzled tile with column j of a W^T tile (its row j)
template <int K>
__device__ __forceinline__ float dot_seq(const uint8_t* in, int row, const uint8_t* wt, int j) {
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < K / 8; ++c) {
    const uint4 a = *reinterpret_cast<const uint4*>(in + swz(row, c));
    const uint4 w = *reinterpret_cast<const uint4*>(wt + swz(j, c));
    v = fma_pair(a.x, w.x, v);
    v = fma_pair(a.y, w.y, v);
    v = fma_pair(a.z, w.z, v);
    v = fma_pair(a.w, w.w, v);
  }
  return v;
}

// A fragments into this warp's 16 rows of a swizzled scratch tile, the
// inputs dot_seq reads for the next layer's ties
template <int KB>
__device__ __forceinline__ void stash(uint8_t* sc, const uint32_t (&a)[KB][4], int lane) {
  const int rl = lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    *reinterpret_cast<uint32_t*>(sc + swz(rl, 2 * kb) + 2 * c) = a[kb][0];
    *reinterpret_cast<uint32_t*>(sc + swz(rl + 8, 2 * kb) + 2 * c) = a[kb][1];
    *reinterpret_cast<uint32_t*>(sc + swz(rl, 2 * kb + 1) + 2 * c) = a[kb][2];
    *reinterpret_cast<uint32_t*>(sc + swz(rl + 8, 2 * kb + 1) + 2 * c) = a[kb][3];
  }
}

// v[i] = redo(i) for every register i near a tie, the warp's inputs stashed
// first (stash_inputs) when any lane of the warp has one. The lanes redo
// their first such register together, then their second, ...: a warp pays
// for its lane with the most, not for every register any lane has.
template <int N, typename Stash, typename Redo>
__device__ __forceinline__ void settle(float (&v)[N], Stash stash_inputs, Redo redo) {
  uint32_t rest = ties(v);
  const int most = (int)__reduce_max_sync(0xffffffffu, (unsigned)__popc(rest));
  if (most == 0) return;
  stash_inputs();
  __syncwarp();
  for (int m = 0; m < most; ++m) {
    const int idx = rest ? __ffs(rest) - 1 : -1;
    rest &= rest - 1;
    const float got = idx >= 0 ? redo(idx) : 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i == idx) v[i] = got;
  }
  __syncwarp();
}

// A shared-memory store that the compiler may not remove: S2's shade stage
// keeps every sample's logits although nothing reads them back, so the head
// of every sample is timed, as K2's composite reads each one.
__device__ __forceinline__ void store_live(float* p, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(smem_addr(p)), "f"(v) : "memory");
}

// S2's shade stage: the accumulator d of one of the head's last products
// over all 16 columns (m64n16 or a row tile's two m16n8 tiles: register i
// holds row (i & 2 ? r + 8 : r), column 8 (i / 4) + 2 t + (i & 1)) summed
// into rows n < rpt of the tile's output (the first product writes, the
// second adds), and the logits among its columns 0-3 (sigma: column 0 of
// the first; rgb: columns 1-3 of the second) kept in res with stores that
// stay.
template <bool SECOND>
__device__ __forceinline__ void wide_out(const float (&d)[8], int na, int nb, int t, int ns,
                                         int rpt, float* __restrict__ rows, float4* res) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = (i & 2) ? nb : na, c = 8 * (i / 4) + 2 * t + (i & 1);
    if (n < rpt) rows[n * CP + c] = SECOND ? __fadd_rn(rows[n * CP + c], d[i]) : d[i];
    if (n < ns && c < 4 && (SECOND ? c > 0 : c == 0))
      store_live(reinterpret_cast<float*>(res + n) + c, d[i]);
  }
}

// The head on the row block of samples n0 .. n0 + 63 of a tile whose x tile
// is at xg: the (sigma, r, g, b) logits of each sample n < ns into res[n].
// base: the head's shared memory; s_dp: the tile's dproj rows (bf16 [rpt]
// [64]); samples are group-major, sample n of ray (n % sg) / ks. Every
// thread of the warpgroup calls it. The shade stage takes the last two
// products over all 16 columns (the wide tiles) and writes rows n < rpt of
// their sum into rows ([rpt][16], the tile's output); the others ignore
// rows and rpt.
template <int STAGE>
__device__ __forceinline__ void head_rows(uint8_t* base, const uint8_t* xg,
                                          const __nv_bfloat16* __restrict__ s_dp,
                                          float4* __restrict__ res, int n0, int ns, int sg,
                                          int ks, float* __restrict__ rows, int rpt) {
  const int wt = threadIdx.x % WG_SIZE, lane = wt % 32;
  const int r = 16 * (wt / 32) + lane / 4, t = lane % 4;
  const uint32_t b = smem_addr(base);
  const float* vec = reinterpret_cast<const float*>(base + H_VEC);
  uint8_t* sc = base + H_SCRATCH + (threadIdx.x / 32) * SCRATCH_WARP;   // this warp's rows
  const uint64_t dx = sw128_desc(smem_addr(xg));
  auto desc = [&](uint32_t off) { return sw128_desc(b + off); };
  auto col = [&](int i) { return 8 * (i / 4) + 2 * t + (i & 1); };
  auto row = [&](int i) { return (i & 2) ? r + 8 : r; };       // in the row block
  auto lrow = [&](int i) { return (i & 2) ? lane / 4 + 8 : lane / 4; };  // in the scratch
  auto x_steps = [&](uint32_t w) {   // A = the x tile, K = 48 in three k16 steps
    return [&, w](auto& d, auto s, int accumulate) {
      wgmma_ss(d, dx + 2 * s, desc(w) + 2 * s, accumulate);
    };
  };
  auto nothing = [] {};

  // relu(x Wx_aud), rounded: the A fragments of aud_ch
  float acc[32], acc2[32], acce[8], accc[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = acc2[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) accc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acce[i] = 0.f;
  chain<XD / 16>(acc, x_steps(H_WXA));
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = fmaxf(acc[i], 0.f);
  settle(acc, nothing,
         [&](int i) { return fmaxf(dot_seq<XD>(xg, row(i), base + H_WXA, col(i)), 0.f); });
  uint32_t a[4][4];
  to_a(acc, a);

  // the eye scalar: relu(x Wx_eye), rounded, . w_eye1[:, 0] in the sequential
  // order (each row's 16 values gathered from its quad), sigmoid
  chain<XD / 16>(acce, x_steps(H_WXE));
#pragma unroll
  for (int i = 0; i < 8; ++i) acce[i] = fmaxf(acce[i], 0.f);
  settle(acce, nothing,
         [&](int i) { return fmaxf(dot_seq<XD>(xg, row(i), base + H_WXE, col(i)), 0.f); });
  float e0 = 0.f, e1 = 0.f;
#pragma unroll
  for (int j = 0; j < EYE; ++j) {   // column j of a row: lane (j % 8) / 2, register 4 (j / 8) + (j & 1)
    const int src = (lane & ~3) | ((j % 8) / 2);
    const float w = vec[V_EYE1 + j];
    e0 = fmaf(bf16r(__shfl_sync(0xffffffffu, acce[4 * (j / 8) + (j & 1)], src)), w, e0);
    e1 = fmaf(bf16r(__shfl_sync(0xffffffffu, acce[4 * (j / 8) + (j & 1) + 2], src)), w, e1);
  }
  const float eye0 = 1.f / (1.f + expf(-e0));
  const float eye1 = 1.f / (1.f + expf(-e1));

  // audio channel attention aud_ch = relu(x Wa0) Wa1 (K = 64, N = 32)
  chain<4>(accc, [&](auto& d, auto s, int accumulate) {
    wgmma_rs(d, a[s], desc(H_AUD1) + 2 * s, accumulate);
  });
  fence_regs(a);
  settle(accc, [&] { stash(sc, a, lane); },
         [&](int i) { return dot_seq<HID>(sc, lrow(i), base + H_AUD1, col(i)); });
  uint32_t ach[2][4];
  to_a(accc, ach);

  // sigma layer 0: x Wx_sig (acc) + aud_ch W_aud_sig (acc2), each summed in f32
  chain<XD / 16>(acc, x_steps(H_WXS));
  chain<2>(acc2, [&](auto& d, auto s, int accumulate) {
    wgmma_rs(d, ach[s], desc(H_AUDSIG) + 2 * s, accumulate);
  });
  fence_regs(ach);
  auto sigma0 = [&](float hx, float ha, int i) {
    return fmaxf(__fadd_rn(__fadd_rn(hx, ha),
                           __fmul_rn((i & 2) ? eye1 : eye0, vec[V_SIGE + col(i)])), 0.f);
  };
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sigma0(acc[i], acc2[i], i);
  settle(acc, [&] { stash(sc, ach, lane); }, [&](int i) {
    return sigma0(dot_seq<XD>(xg, row(i), base + H_WXS, col(i)),
                  dot_seq<AUD>(sc, lrow(i), base + H_AUDSIG, col(i)), i);
  });
  to_a(acc, a);

  // sigma layer 1: h2 = relu(h W_sig1); sigma = h2 . w_sigcol[:, 0]
  chain<4>(acc, [&](auto& d, auto s, int accumulate) {
    wgmma_rs(d, a[s], desc(H_SIG1) + 2 * s, accumulate);
  });
  fence_regs(a);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = fmaxf(acc[i], 0.f);
  settle(acc, [&] { stash(sc, a, lane); },
         [&](int i) { return fmaxf(dot_seq<HID>(sc, lrow(i), base + H_SIG1, col(i)), 0.f); });
  const int na = n0 + r, nb = na + 8;
  float wide[8];   // the shade stage's sig_p, then rgb_p
  auto wide_product = [&](uint32_t off) {
    chain<4>(wide, [&](auto& d, auto s, int accumulate) {
      wgmma_rs(d, a[s], desc(off) + 2 * s, accumulate);
    });
    fence_regs(a);
  };
  float s0 = 0.f, s1 = 0.f;
  if constexpr (STAGE != STAGE_SHADE) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) s1 = fmaf(bf16r(acc[i]), vec[V_SIGCOL + col(i)], s1);
      else s0 = fmaf(bf16r(acc[i]), vec[V_SIGCOL + col(i)], s0);
    }
  }
  to_a(acc, a);
  if constexpr (STAGE == STAGE_SHADE) {
    wide_product(H_WIDE);
    wide_out<false>(wide, na, nb, t, ns, rpt, rows, res);
  }

  // geo = h2 W_geo
  chain<4>(acc, [&](auto& d, auto s, int accumulate) {
    wgmma_rs(d, a[s], desc(H_GEO) + 2 * s, accumulate);
  });
  fence_regs(a);
  settle(acc, [&] { stash(sc, a, lane); },
         [&](int i) { return dot_seq<HID>(sc, lrow(i), base + H_GEO, col(i)); });
  to_a(acc, a);

  // colour: relu(geo W_col_g + dproj + bias) . w_rgb[:, 1:4]
  chain<4>(acc, [&](auto& d, auto s, int accumulate) {
    wgmma_rs(d, a[s], desc(H_COLG) + 2 * s, accumulate);
  });
  fence_regs(a);
  const int ray_a = (na - (na / sg) * sg) / ks, ray_b = (nb - (nb / sg) * sg) / ks;
  auto colour = [&](float v, int i) {
    const int j = col(i);
    const float dp = __bfloat162float(s_dp[((i & 2) ? ray_b : ray_a) * HID + j]);
    return fmaxf(__fadd_rn(__fadd_rn(v, dp), vec[V_CB + j]), 0.f);
  };
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = colour(acc[i], i);
  settle(acc, [&] { stash(sc, a, lane); },
         [&](int i) { return colour(dot_seq<HID>(sc, lrow(i), base + H_COLG, col(i)), i); });
  if constexpr (STAGE == STAGE_SHADE) {
    to_a(acc, a);
    wide_product(H_WIDE + CP * ROW_BYTES);
    wide_out<true>(wide, na, nb, t, ns, rpt, rows, res);
    return;
  }
  float c0[2] = {0.f, 0.f}, c1[2] = {0.f, 0.f}, c2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int j = col(i), h = (i & 2) ? 1 : 0;
    const float cr = bf16r(acc[i]);
    c0[h] = fmaf(cr, vec[V_RGB + 4 * j], c0[h]);
    c1[h] = fmaf(cr, vec[V_RGB + 4 * j + 1], c1[h]);
    c2[h] = fmaf(cr, vec[V_RGB + 4 * j + 2], c2[h]);
  }
  const float4 ra = make_float4(quad_sum(s0), quad_sum(c0[0]), quad_sum(c1[0]), quad_sum(c2[0]));
  const float4 rb = make_float4(quad_sum(s1), quad_sum(c0[1]), quad_sum(c1[1]), quad_sum(c2[1]));
  if (t == 0) {
    if (na < ns) res[na] = ra;
    if (nb < ns) res[nb] = rb;
  }
}

// ---------------------------------------------------------------------------
// Step 2 with f32 weights on the tensor cores: each warp runs the head on
// TF_ROWS samples (TF_MT m16 row tiles) as mma.sync m16n8k8 TF32 products,
// each f32 product taken as three TF32 products (a_lo b_hi + a_hi b_lo +
// a_hi b_hi, operands split as a = a_hi + a_lo with a_hi rounded as
// cvt.rna.tf32 rounds: split_tf32; the dropped a_lo b_lo is ~2^-21
// relative), summed in the f32 accumulators. f32 weights round no
// activation, so no value needs settling.
//   - The f32 weights are staged once per block as W^T rows [N][K + 8]
//     (TS48, TS64, TS32 floats: a stride of 8 mod 32 makes every fragment
//     read below free of bank conflicts). B fragments are read as float2 and
//     split into hi/lo as they are loaded; each split fragment serves the
//     warp's TF_MT row tiles.
//   - Fragment map: an m16n8 accumulator holds columns 2t, 2t + 1 of rows
//     g, g + 8 where the next product's A fragment wants k positions t,
//     t + 4. So position t of k8 step s stands for input 8s + 2t and t + 4
//     for 8s + 2t + 1 (a permutation of the contraction, no shuffle): B is
//     read at W^T columns 8s + 2t, 8s + 2t + 1, and an accumulator n-tile s
//     is A's k8 step s as it stands (registers 0, 2, 1, 3).
//   - The fetch writes each sample's 48 f32 features into the warp's x rows
//     in shared memory ([TF_ROWS][TS48]), which the three products of x
//     read as float2 A fragments in the same order; the hidden layers stay
//     in registers.
//   - The narrow products (eye 16 -> 1, sigma 64 -> 1, rgb 64 -> 3) are f32
//     dots on the accumulator lanes, then the quad's four lanes by shuffles.

constexpr int TF_WARPS = 8;                   // warps of a K2 f32 block
constexpr int TF_THREADS = 32 * TF_WARPS;
constexpr int TF_MT = 2;                      // m16 row tiles of a warp
constexpr int TF_ROWS = 16 * TF_MT;           // samples of a warp's row block
constexpr int TS48 = XD + 8, TS64 = HID + 8, TS32 = AUD + 8;   // row strides in floats

// shared memory of the f32 head, in floats: W^T rows, the f32 vectors, then
// each warp's x rows
constexpr int F_WXA = 0;                       // [64][TS48] wx_aud^T
constexpr int F_WXS = F_WXA + HID * TS48;      // [64][TS48] wx_sig^T
constexpr int F_WXE = F_WXS + HID * TS48;      // [16][TS48] wx_eye^T
constexpr int F_AUD1 = F_WXE + EYE * TS48;     // [32][TS64] w_aud1^T
constexpr int F_AUDSIG = F_AUD1 + AUD * TS64;  // [64][TS32] w_aud_sig^T
constexpr int F_SIG1 = F_AUDSIG + HID * TS32;  // [64][TS64] w_sig1^T
constexpr int F_GEO = F_SIG1 + HID * TS64;     // [64][TS64] w_geo^T
constexpr int F_COLG = F_GEO + HID * TS64;     // [64][TS64] w_col_g^T
constexpr int F_VEC = F_COLG + HID * TS64;     // V_* vectors as in the bf16 head
constexpr int F_X = F_VEC + V_FLOATS;          // [TF_WARPS][TF_ROWS][TS48] x rows
constexpr int F_FIXED = F_X + TF_WARPS * TF_ROWS * TS48;   // then the results, the jobs
constexpr int F_WIDE = F_FIXED;               // S2's shade: [2][16][TS64] w_sigcol^T, w_rgb^T
constexpr int F_WIDE_FLOATS = 2 * CP * TS64;
static_assert(F_X % 4 == 0 && F_FIXED % 4 == 0 && F_WIDE_FLOATS % 4 == 0,
              "rows must stay 16-byte aligned");

// shared memory of a K2 block with the f32 tensor-core head: the fixed part,
// the samples' float4 results and the job table
size_t tf32_smem(size_t samples) {
  return sizeof(float) * (size_t)F_FIXED + 16 * samples + sizeof(int) * MAX_JOB_INTS;
}

// x = hi + lo as tensor-core operands. hi is x rounded to TF32 as
// cvt.rna.tf32.f32 rounds it (to nearest, halves away from zero: half an ulp
// of the 10-bit mantissa added, the 13 low bits cleared), in two integer
// operations: ptxas expands cvt.rna into a longer sequence that also guards
// infinities and NaN, and with it for both halves K2 took ~1.8x as long
// (scripts/prof_k2.py, f32_cvt_rna). lo = x - hi is exact in f32; a TF32
// product reads only its top 19 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += A B for one m16n8k8 TF32 step (A: a0 row g col t, a1 row g + 8,
// a2 / a3 col t + 4; B: b0 row t, b1 row t + 4, col g; d rows g / g + 8,
// cols 2t, 2t + 1; g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m] += A_m W for each of the warp's MT row tiles at f32 accuracy, K =
// 8 KS, N = 8 NT: a_at(m, s) gives row tile m's A fragment of k8 step s
// (a0, a1, a2, a3 as mma_tf32 takes them) in f32; W^T rows at wt, `stride`
// floats apart.
template <int MT, int KS, int NT, typename At>
__device__ __forceinline__ void mma3_layer(float (&acc)[MT][NT][4], At a_at,
                                           const float* __restrict__ wt, int stride) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float4 a = a_at(m, s);
      split_tf32(a.x, ah[m][0], al[m][0]);
      split_tf32(a.y, ah[m][1], al[m][1]);
      split_tf32(a.z, ah[m][2], al[m][2]);
      split_tf32(a.w, ah[m][3], al[m][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(wt + (8 * j + g) * stride + 8 * s + 2 * t);
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b.x, bh0, bl0);
      split_tf32(b.y, bh1, bl1);
#pragma unroll
      for (int m = 0; m < MT; ++m) {   // the small terms first, then hi x hi
        mma_tf32(acc[m][j], al[m], bh0, bh1);
        mma_tf32(acc[m][j], ah[m], bl0, bl1);
        mma_tf32(acc[m][j], ah[m], bh0, bh1);
      }
    }
  }
}

// A fragments from an accumulator (n-tile s is k8 step s, registers 0, 2, 1, 3)
template <int MT, int NT>
struct FromAcc {
  const float (&v)[MT][NT][4];
  __device__ __forceinline__ float4 operator()(int m, int s) const {
    return make_float4(v[m][s][0], v[m][s][2], v[m][s][1], v[m][s][3]);
  }
};
template <int MT, int NT>
__device__ __forceinline__ FromAcc<MT, NT> from_acc(const float (&v)[MT][NT][4]) {
  return {v};
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
}

// The f32 weights into the f32 head's layout (s: the block's shared memory;
// for the shade stage also the wide rows).
template <int STAGE>
__device__ void stage_tf32_weights(float* s, const Weights& wp) {
  auto W = [&](int i) { return static_cast<const float*>(wp.p[i]); };
  // w [K][N] row-major -> W^T [N][stride]
  auto tile = [&](int off, const float* w, int k_dim, int n_dim, int stride) {
    for (int e = threadIdx.x; e < n_dim * k_dim; e += TF_THREADS) {
      const int k = e / n_dim, n = e - k * n_dim;
      s[off + n * stride + k] = w[e];
    }
  };
  tile(F_WXA, W(WX_AUD), XD, HID, TS48);
  tile(F_WXS, W(WX_SIG), XD, HID, TS48);
  tile(F_WXE, W(WX_EYE), XD, EYE, TS48);
  tile(F_AUD1, W(W_AUD1), HID, AUD, TS64);
  tile(F_AUDSIG, W(W_AUD_SIG), AUD, HID, TS32);
  tile(F_SIG1, W(W_SIG1), HID, HID, TS64);
  tile(F_GEO, W(W_GEO), HID, HID, TS64);
  tile(F_COLG, W(W_COL_G), HID, HID, TS64);
  if constexpr (STAGE == STAGE_SHADE) {
    tile(F_WIDE, W(W_SIGCOL), HID, CP, TS64);
    tile(F_WIDE + CP * TS64, W(W_RGB), HID, CP, TS64);
  }
  float* vec = s + F_VEC;
  for (int e = threadIdx.x; e < HID; e += TF_THREADS) {
    vec[V_SIGE + e] = W(W_SIG_E)[e];
    vec[V_SIGCOL + e] = W(W_SIGCOL)[e * 16];
    vec[V_CB + e] = W(COL_BIAS)[e];
    vec[V_RGB + 4 * e + 0] = W(W_RGB)[e * 16 + 1];
    vec[V_RGB + 4 * e + 1] = W(W_RGB)[e * 16 + 2];
    vec[V_RGB + 4 * e + 2] = W(W_RGB)[e * 16 + 3];
    vec[V_RGB + 4 * e + 3] = 0.f;
  }
  for (int e = threadIdx.x; e < EYE; e += TF_THREADS) vec[V_EYE1 + e] = W(W_EYE1)[e * 8];
}

// The head on the warp's row tiles, whose features are the warp's x rows xs
// ([TF_ROWS][TS48], rows n0 + r of the tile's samples); the (sigma, r, g, b)
// logits of each sample n < ns into res[n]. sm: the block's shared memory;
// dp: the tile's dproj rows (f32 [rpt][dp_stride(STAGE)], the first 64 of
// each read through L1 where the colour layer adds them). Samples are
// group-major, sample n of ray (n % sg) / ks.
// The shade stage takes the last two products over all 16 columns (the wide
// rows at F_WIDE) and writes rows n < rpt of their sum into rows ([rpt]
// [16], the tile's output), as head_rows does; the others ignore rows and rpt.
template <int MT, int STAGE>
__device__ __forceinline__ void head_tf32(const float* __restrict__ sm, const float* xs,
                                          const float* __restrict__ dp, float4* __restrict__ res,
                                          int n0, int ns, int sg, int ks,
                                          float* __restrict__ rows, int rpt) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  constexpr int DP = dp_stride(STAGE);
  const float* vec = sm + F_VEC;
  auto col = [&](int j, int i) { return 8 * j + 2 * t + (i & 1); };   // register i of n-tile j
  auto x_at = [&](int m, int s) {   // rows g, g + 8 of row tile m, features 8s + 2t, + 1
    const float2 a = *reinterpret_cast<const float2*>(xs + (16 * m + g) * TS48 + 8 * s + 2 * t);
    const float2 b = *reinterpret_cast<const float2*>(xs + (16 * m + g + 8) * TS48 + 8 * s + 2 * t);
    return make_float4(a.x, b.x, a.y, b.y);
  };

  // audio channel attention: aud_ch = relu(x Wx_aud) W_aud1
  float ach[MT][4][4];
  {
    float ah[MT][8][4];
    zero(ah);
    mma3_layer<MT, XD / 8>(ah, x_at, sm + F_WXA, TS48);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) ah[m][j][i] = fmaxf(ah[m][j][i], 0.f);
    zero(ach);
    mma3_layer<MT, 8>(ach, from_acc(ah), sm + F_AUD1, TS64);
  }
  // the eye scalar: sigmoid(relu(x Wx_eye) . w_eye1[:, 0]) of rows g (eye[m][0]), g + 8
  float eye[MT][2];
  {
    float e[MT][2][4];
    zero(e);
    mma3_layer<MT, XD / 8>(e, x_at, sm + F_WXE, TS48);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float e0 = 0.f, e1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = fmaxf(e[m][j][i], 0.f) * vec[V_EYE1 + col(j, i)];
          if (i & 2) e1 += v;
          else e0 += v;
        }
      eye[m][0] = 1.f / (1.f + expf(-quad_sum(e0)));
      eye[m][1] = 1.f / (1.f + expf(-quad_sum(e1)));
    }
  }
  // sigma layer 0: h = relu(x Wx_sig + aud_ch W_aud_sig + eye w_sig_e)
  float h[MT][8][4];
  zero(h);
  mma3_layer<MT, XD / 8>(h, x_at, sm + F_WXS, TS48);
  mma3_layer<MT, 4>(h, from_acc(ach), sm + F_AUDSIG, TS32);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h[m][j][i] = fmaxf(__fadd_rn(h[m][j][i], __fmul_rn(eye[m][i / 2], vec[V_SIGE + col(j, i)])),
                           0.f);
  // sigma layer 1: h2 = relu(h W_sig1); sigma = h2 . w_sigcol[:, 0]
  float h2[MT][8][4];
  zero(h2);
  mma3_layer<MT, 8>(h2, from_acc(h), sm + F_SIG1, TS64);
  float wide[MT][2][4];   // the shade stage's sig_p, then rgb_p
  auto wide_out_tiles = [&](auto second) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float d[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = wide[m][i / 4][i % 4];
      const int na = n0 + 16 * m + g;
      wide_out<decltype(second)::value>(d, na, na + 8, t, ns, rpt, rows, res);
    }
  };
  if constexpr (STAGE == STAGE_SHADE) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) h2[m][j][i] = fmaxf(h2[m][j][i], 0.f);
    zero(wide);
    mma3_layer<MT, 8>(wide, from_acc(h2), sm + F_WIDE, TS64);
    wide_out_tiles(BoolC<false>());
  }
  // sigma into the samples' results now (lane 0 of each quad), rgb below
  float* out = reinterpret_cast<float*>(res);
  if constexpr (STAGE != STAGE_SHADE) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float sa = 0.f, sb = 0.f;   // rows g, g + 8
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          h2[m][j][i] = fmaxf(h2[m][j][i], 0.f);
          if (i & 2) sb = fmaf(h2[m][j][i], vec[V_SIGCOL + col(j, i)], sb);
          else sa = fmaf(h2[m][j][i], vec[V_SIGCOL + col(j, i)], sa);
        }
      sa = quad_sum(sa);
      sb = quad_sum(sb);
      const int n = n0 + 16 * m + g;
      if (t == 0 && n < ns) out[4 * n] = sa;
      if (t == 0 && n + 8 < ns) out[4 * (n + 8)] = sb;
    }
  }
  // geo = h2 W_geo (into h)
  zero(h);
  mma3_layer<MT, 8>(h, from_acc(h2), sm + F_GEO, TS64);
  // colour: relu(geo W_col_g + dproj + bias) . w_rgb[:, 1:4] (into h2)
  zero(h2);
  mma3_layer<MT, 8>(h2, from_acc(h), sm + F_COLG, TS64);
  if constexpr (STAGE == STAGE_SHADE) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + 16 * m + g + 8 * (i / 2), k = col(j, i);
          const int ray = (n - (n / sg) * sg) / ks;
          h2[m][j][i] = fmaxf(__fadd_rn(__fadd_rn(h2[m][j][i], __ldg(dp + ray * DP + k)),
                                        vec[V_CB + k]), 0.f);
        }
    zero(wide);
    mma3_layer<MT, 8>(wide, from_acc(h2), sm + F_WIDE + CP * TS64, TS64);
    wide_out_tiles(BoolC<true>());
    return;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float c[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    int ray[2];   // padding rows (n >= ns) read some ray's row too: n % sg < sg
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = n0 + 16 * m + g + 8 * hf;
      ray[hf] = (n - (n / sg) * sg) / ks;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = col(j, i), hf = i / 2;
        const float cr = fmaxf(__fadd_rn(__fadd_rn(h2[m][j][i], __ldg(dp + ray[hf] * DP + k)),
                                         vec[V_CB + k]), 0.f);
        c[hf][0] = fmaf(cr, vec[V_RGB + 4 * k], c[hf][0]);
        c[hf][1] = fmaf(cr, vec[V_RGB + 4 * k + 1], c[hf][1]);
        c[hf][2] = fmaf(cr, vec[V_RGB + 4 * k + 2], c[hf][2]);
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float r = quad_sum(c[hf][0]), gr = quad_sum(c[hf][1]), b = quad_sum(c[hf][2]);
      const int n = n0 + 16 * m + g + 8 * hf;
      if (t == 0 && n < ns) {
        out[4 * n + 1] = r;
        out[4 * n + 2] = gr;
        out[4 * n + 3] = b;
      }
    }
  }
}


// ---------------------------------------------------------------------------
// K2's tensor-core kernels, one body per weight dtype and a template on what
// it runs (Stage): csrc/sampler.cu launches K2 (full), K2b (rows) and K2c
// (rays); csrc/sampler_stages.cu K2 stopped after the fetch or the head,
// S2's win and shade. The variants share the resident grid, the block, the
// weight staging, the fetch and the head, and differ only in where a
// sample's coordinates come from (uv, or K2c's rays) and what a tile writes
// (the composite, K2b's rows, or a stage's sums). The per-sample area after
// dp holds the tile's kg sg results, or, in the win stage, at least its
// sums: [HEAD_WGS][rpt][WIN_STRIDE] f32 (bf16 kernel, one per warpgroup;
// rows padded so that a warp's 32 rows fall in 32 banks) or
// [TF_THREADS][16] (f32 kernel, one per thread).
constexpr int WIN_STRIDE = CP + 1;
__host__ __device__ inline int stage_rows(int stage, bool bf16, int ns, int rpt) {
  const int need = stage != STAGE_WIN ? 0
                   : bf16       ? (HEAD_WGS * rpt * WIN_STRIDE + 3) / 4
                                : TF_THREADS * CP / 4;
  return ns > need ? ns : need;
}

// shared memory of a block of either kernel at a stage: K2's (head_smem,
// tf32_smem; K2b's and K2c's alike) with the stage's per-sample area and,
// for shade, the wide tiles
size_t stage_smem(int stage, bool bf16, int rpt, int ns) {
  const int rows = stage_rows(stage, bf16, ns, rpt);
  if (bf16) return head_smem(rpt, rows) + (stage == STAGE_SHADE ? H_WIDE_BYTES : 0);
  return tf32_smem(rows) + (stage == STAGE_SHADE ? sizeof(float) * F_WIDE_FLOATS : 0);
}

// K2 with bf16 weights and dproj: the head on the tensor cores. A grid of
// resident blocks of three warpgroups, each block looping over tiles. The
// win stage sums each sample's features into its warpgroup's [rpt][16]
// as the fetch makes them (plane by plane, before the head's bf16
// rounding) and writes the three warpgroups' sums; the shade stage writes
// rows r < rpt of sig_p + rgb_p (head_rows).
template <int STAGE>
__global__ void __launch_bounds__(HEAD_THREADS, 1)
sample_shade_comp_wgmma_kernel(const __nv_bfloat16* __restrict__ planes,
                               const int* __restrict__ jobs, const float* __restrict__ coords,
                               const __nv_bfloat16* __restrict__ dproj,
                               const float* __restrict__ dtv, Weights wp, float* __restrict__ out,
                               int tiles, int rpt, int kg, int ks, int wu, int wv, int rows,
                               int rv, float bound, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int sg = rpt * ks;
  const int ns = kg * sg;
  constexpr int DP = dp_stride(STAGE);
  auto* s_dp = reinterpret_cast<__nv_bfloat16*>(
      base + H_FIXED + (STAGE == STAGE_SHADE ? H_WIDE_BYTES : 0));   // [rpt][64]
  auto* s_res = reinterpret_cast<float4*>(s_dp + rpt * HID);        // [kg * sg]
  // [3][1 + 2kg], K2c's [3][1 + 4kg]
  int* s_jobs = reinterpret_cast<int*>(s_res + stage_rows(STAGE, true, ns, rpt));
  float* s_win = reinterpret_cast<float*>(s_res);   // win: [HEAD_WGS][rpt][WIN_STRIDE]
  const int n_jobs = 3 * (1 + (STAGE == STAGE_RAYS ? 4 : 2) * kg);
  const int tid = threadIdx.x, wg = tid / WG_SIZE, wt = tid % WG_SIZE;
  uint8_t* x_wg = base + H_X + wg * X_TILE;   // this warpgroup's x tile
  const float umax = (float)((double)wu - 1.001);
  const float vmax = (float)((double)wv - 1.001);

  stage_head_weights<STAGE>(base, wp);
  if constexpr (STAGE == STAGE_WIN)
    for (int e = tid; e < HEAD_WGS * rpt * WIN_STRIDE; e += HEAD_THREADS) s_win[e] = 0.f;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const uint4* dp = reinterpret_cast<const uint4*>(dproj + (size_t)t * rpt * DP);
    for (int e = tid; e < rpt * HID / 8; e += HEAD_THREADS)   // the first 64 of each row
      reinterpret_cast<uint4*>(s_dp)[e] = dp[(e / (HID / 8)) * (DP / 8) + e % (HID / 8)];
    for (int e = tid; e < n_jobs; e += HEAD_THREADS) s_jobs[e] = jobs[(size_t)t * n_jobs + e];
    __syncthreads();   // the weights (first tile), dp and jobs are staged; the last
                       // tile's composite or rows are done with s_res

    // row blocks of 64 samples in turn; two threads a sample fetch half its
    // channels each
    for (int n0 = HEAD_ROWS * wg; n0 < ns; n0 += HEAD_ROWS * HEAD_WGS) {
      const int n = n0 + wt % HEAD_ROWS, h = wt / HEAD_ROWS;
      float x[24];
      if (n < ns) {
        fetch<STAGE, 1>(planes, s_jobs, coords, t, n, rpt, kg, ks, bound, scale, umax, vmax, rows,
                        rv, x, h);
      } else {
#pragma unroll
        for (int k = 0; k < 24; ++k) x[k] = 0.f;
      }
      if constexpr (STAGE == STAGE_WIN) {
        // channels 8h .. 8h + 7 into the sums of ray row n % rpt; the row
        // block's samples that share a row (rpt < 64) add in turns
        for (int j0 = 0; j0 < HEAD_ROWS; j0 += rpt) {
          const int j = wt % HEAD_ROWS;
          if (n < ns && j >= j0 && j < j0 + rpt) {
            float* a = s_win + (wg * rpt + n % rpt) * WIN_STRIDE + 8 * h;
#pragma unroll
            for (int c = 0; c < 8; ++c)
              a[c] = __fadd_rn(__fadd_rn(__fadd_rn(a[c], x[c]), x[8 + c]), x[16 + c]);
          }
          asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG_SIZE) : "memory");
        }
      } else {
        write_x_half(x_wg, wt % HEAD_ROWS, h, x);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // seen by wgmma
        asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG_SIZE) : "memory");
        head_rows<STAGE>(base, x_wg, s_dp, s_res, n0, ns, sg, ks, out + (size_t)t * rpt * CP, rpt);
        asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG_SIZE) : "memory");  // x tile read
      }
    }
    __syncthreads();

    if constexpr (STAGE == STAGE_FULL || STAGE == STAGE_RAYS) {
      for (int r = tid; r < rpt; r += HEAD_THREADS)
        composite_ray(s_res, r, kg, ks, sg,
                      ray_dt<STAGE>(dtv, coords, (size_t)t * rpt + r, kg * ks),
                      out + ((size_t)t * rpt + r) * 16);
    } else if constexpr (STAGE == STAGE_ROWS) {
      write_rows<HEAD_THREADS>(s_res, ns, out + (size_t)t * ns * CP);
    } else if constexpr (STAGE == STAGE_WIN) {
      for (int e = tid; e < rpt * CP; e += HEAD_THREADS) {   // the warpgroups' sums, in order
        const int i = (e / CP) * WIN_STRIDE + e % CP;
        float v = s_win[i];
        s_win[i] = 0.f;
#pragma unroll
        for (int w = 1; w < HEAD_WGS; ++w) {
          v = __fadd_rn(v, s_win[w * rpt * WIN_STRIDE + i]);
          s_win[w * rpt * WIN_STRIDE + i] = 0.f;
        }
        out[(size_t)t * rpt * CP + e] = v;
      }
    }
  }
}

// K2 with f32 weights and dproj: the head on the tensor cores as three TF32
// products a term (head_tf32). A grid of resident blocks of TF_WARPS warps,
// each block looping over tiles; each warp takes TF_ROWS samples at a time.
// The win stage sums each thread's samples' features in registers as the
// fetch makes them (plane by plane; a thread's samples n = tid + 256 i share
// the ray row n % rpt when 256 % rpt == 0), then the threads' sums of each
// row in order; the shade stage writes rows r < rpt of sig_p + rgb_p.
template <int STAGE>
__global__ void __launch_bounds__(TF_THREADS, 1)
sample_shade_comp_tf32_kernel(const __nv_bfloat16* __restrict__ planes,
                              const int* __restrict__ jobs, const float* __restrict__ coords,
                              const float* __restrict__ dproj, const float* __restrict__ dtv,
                              Weights wp, float* __restrict__ out, int tiles, int rpt, int kg,
                              int ks, int wu, int wv, int rows, int rv, float bound,
                              float scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int sg = rpt * ks;
  const int ns = kg * sg;
  float4* s_res = reinterpret_cast<float4*>(
      sm + F_FIXED + (STAGE == STAGE_SHADE ? F_WIDE_FLOATS : 0));           // [kg * sg]
  // [3][1 + 2kg], K2c's [3][1 + 4kg]
  int* s_jobs = reinterpret_cast<int*>(s_res + stage_rows(STAGE, false, ns, rpt));
  const int n_jobs = 3 * (1 + (STAGE == STAGE_RAYS ? 4 : 2) * kg);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float umax = (float)((double)wu - 1.001);
  const float vmax = (float)((double)wv - 1.001);

  stage_tf32_weights<STAGE>(sm, wp);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int e = tid; e < n_jobs; e += TF_THREADS) s_jobs[e] = jobs[(size_t)t * n_jobs + e];
    __syncthreads();   // the weights (first tile) and jobs are staged; the last
                       // tile's composite or rows are done with s_res

    // row blocks of TF_ROWS samples a warp; 32 / TF_ROWS threads a sample
    // fetch its features (all, or half of each plane's) into the x rows
    constexpr int HALVES = TF_ROWS == 32 ? 2 : 1;
    static_assert(STAGE != STAGE_WIN || HALVES == 2, "win sums whole samples a thread");
    float acc[STAGE == STAGE_WIN ? CP : 1];   // win: this thread's sums
#pragma unroll
    for (int c = 0; c < (STAGE == STAGE_WIN ? CP : 1); ++c) acc[c] = 0.f;
    float* xs = sm + F_X + warp * TF_ROWS * TS48;
    for (int n0 = TF_ROWS * warp; n0 < ns; n0 += TF_ROWS * TF_WARPS) {
      const int r = lane % TF_ROWS, h = lane / TF_ROWS, n = n0 + r;
      float x[24 * HALVES];
      if (n < ns) {
        fetch<STAGE, HALVES>(planes, s_jobs, coords, t, n, rpt, kg, ks, bound, scale, umax, vmax,
                             rows, rv, x, h);
      } else {   // a last partial row block: zero rows, not stored
#pragma unroll
        for (int k = 0; k < 24 * HALVES; ++k) x[k] = 0.f;
      }
      if constexpr (STAGE == STAGE_WIN) {
#pragma unroll
        for (int c = 0; c < CP; ++c)
          acc[c] = __fadd_rn(__fadd_rn(__fadd_rn(acc[c], x[c]), x[CP + c]), x[2 * CP + c]);
      } else {
        __syncwarp();   // the last row block's products have read the x rows
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int c = 0; c < 8 * HALVES; c += 4)
            *reinterpret_cast<float4*>(xs + r * TS48 + CP * q + 8 * h + c) =
                make_float4(x[8 * HALVES * q + c], x[8 * HALVES * q + c + 1],
                            x[8 * HALVES * q + c + 2], x[8 * HALVES * q + c + 3]);
        __syncwarp();
        head_tf32<TF_MT, STAGE>(sm, xs, dproj + (size_t)t * rpt * dp_stride(STAGE), s_res, n0, ns,
                                sg, ks, out + (size_t)t * rpt * CP, rpt);
      }
    }
    if constexpr (STAGE == STAGE_WIN) {
      float* s_part = reinterpret_cast<float*>(s_res);   // [TF_THREADS][16]
#pragma unroll
      for (int c = 0; c < CP; ++c) s_part[tid * CP + c] = acc[c];
    }
    __syncthreads();

    if constexpr (STAGE == STAGE_FULL || STAGE == STAGE_RAYS) {
      for (int r = tid; r < rpt; r += TF_THREADS)
        composite_ray(s_res, r, kg, ks, sg,
                      ray_dt<STAGE>(dtv, coords, (size_t)t * rpt + r, kg * ks),
                      out + ((size_t)t * rpt + r) * 16);
    } else if constexpr (STAGE == STAGE_ROWS) {
      write_rows<TF_THREADS>(s_res, ns, out + (size_t)t * ns * CP);
    } else if constexpr (STAGE == STAGE_WIN) {
      const float* s_part = reinterpret_cast<const float*>(s_res);
      for (int e = tid; e < rpt * CP; e += TF_THREADS) {   // row r's threads b rpt + r, in order
        const int r = e / CP, c = e % CP;
        float v = 0.f;
        for (int b = 0; b < TF_THREADS / rpt; ++b) v = __fadd_rn(v, s_part[(b * rpt + r) * CP + c]);
        out[(size_t)t * rpt * CP + e] = v;
      }
    }
  }
}

// Launch a tile-looping kernel on a grid of its resident blocks (at most
// one per tile) with `bytes` of dynamic shared memory; returns the launch's
// error.
template <typename Kernel, typename... Args>
cudaError_t launch_resident(Kernel kernel, int threads, size_t bytes, int tiles, int device,
                            cudaStream_t stream, Args... args) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  if (err != cudaSuccess) return err;
  const int resident = sms * per_sm > 0 ? sms * per_sm : 1;
  kernel<<<tiles < resident ? tiles : resident, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// Launch instance STAGE of K2's kernel for the weight dtype (bf16 != 0: the
// wgmma kernel, else the 3xTF32 one) on `stream` of CUDA device `device`:
// coords is uv (rays for STAGE_RAYS), dtv is read by STAGE_FULL only, bound
// and scale by STAGE_RAYS only. Returns the cudaError_t of the launch.
template <int STAGE>
int launch_k2(int device, int bf16, const void* planes, const void* jobs, const void* coords,
              const void* dproj, const void* dtv, const Weights& wp, void* out, int tiles,
              int rpt, int kg, int ks, int wu, int wv, int rows, int rv, float bound, float scale,
              void* stream) {
  if (bad_geometry(tiles, rpt, kg, ks, wu, wv, rows, rv, STAGE == STAGE_RAYS ? 4 : 2))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = stage_smem(STAGE, bf16 != 0, rpt, kg * rpt * ks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const __nv_bfloat16*>(planes);
  const auto* j = static_cast<const int*>(jobs);
  const auto* c = static_cast<const float*>(coords);
  const auto* d = static_cast<const float*>(dtv);
  auto* o = static_cast<float*>(out);
  if (bf16)
    return (int)launch_resident(sample_shade_comp_wgmma_kernel<STAGE>, HEAD_THREADS, bytes, tiles,
                                device, s, p, j, c, static_cast<const __nv_bfloat16*>(dproj), d,
                                wp, o, tiles, rpt, kg, ks, wu, wv, rows, rv, bound, scale);
  return (int)launch_resident(sample_shade_comp_tf32_kernel<STAGE>, TF_THREADS, bytes, tiles,
                              device, s, p, j, c, static_cast<const float*>(dproj), d, wp, o,
                              tiles, rpt, kg, ks, wu, wv, rows, rv, bound, scale);
}

// ---------------------------------------------------------------------------
// The fetch-only kernels, S1 (csrc/sampler_stages.cu) and K2d
// (csrc/sampler.cu): a grid of resident blocks loops over work units (S1 a
// tile, K2d a tile's depth group); each block copies the next unit's job
// table and coordinates into one of two shared buffers with cp.async while
// it works on the other, and gathers texels from global memory through L1.

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait for every group but the last committed (the next unit's copies)
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// the row stride, in floats, of staged rows of n coordinates: a multiple of
// 4 (16-byte copies), padded by 4 so that the rows of a power-of-two n do
// not all start in one bank
__host__ __device__ constexpr int staged_stride(int n) { return (n + 3) / 4 * 4 + 4; }

// Copy `runs` runs of n 4-byte words, run i from src(i) to dst + i stride
// (dst 16-byte aligned, stride a multiple of 4), with the block's NT
// threads: 16-byte copies when every run starts on a 16-byte boundary and n
// is a multiple of 4 (vec), else 4-byte copies. Commits nothing.
template <int NT, typename Src>
__device__ __forceinline__ void stage_runs(float* dst, int stride, Src src, int runs, int n,
                                           bool vec) {
  if (vec) {
    const int n4 = n >> 2;
    for (int e = threadIdx.x; e < runs * n4; e += NT) {
      const int i = e / n4, c = e - i * n4;
      cp_async16(dst + i * stride + 4 * c, src(i) + 4 * c);
    }
  } else {
    for (int e = threadIdx.x; e < runs * n; e += NT) {
      const int i = e / n, c = e - i * n;
      cp_async4(dst + i * stride + c, src(i) + c);
    }
  }
}

// Launch a fetch-only kernel on a grid of its resident blocks of `threads`
// (at most one per unit) with `bytes` of dynamic shared memory, asking for
// no more of the SM's shared memory than `per_sm` such blocks take (each
// also holds 1 KB the system reserves): the rest stays L1, through which the
// kernel's texel gathers go. Returns the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch_fetch(Kernel kernel, int threads, size_t bytes, int per_sm, int units,
                         int device, cudaStream_t stream, Args... args) {
  const size_t sm_bytes = (size_t)per_sm * (bytes + 1024), sm_max = MAX_SMEM + 1024;
  const int carveout = (int)((100 * sm_bytes + sm_max - 1) / sm_max);   // percent
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         carveout < 100 ? carveout : 100);
  if (err != cudaSuccess) return err;
  return launch_resident(kernel, threads, bytes, units, device, stream, args...);   // checks bytes
}

}  // namespace
