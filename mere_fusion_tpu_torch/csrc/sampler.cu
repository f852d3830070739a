// The triplane sampler family on sm_90a: K2 and its siblings K2b, K2c, K2d.
//
// Replaces the Pallas TPU kernels of mere_fusion_tpu/ops/pallas_sampler.py
// (all on _window_machinery :149 and, but K2d, _shade_core :313):
//   K2  sample_shade_comp_tiles :670 (_shade_comp_kernel :421, call :691)
//   K2b sample_shade_tiles      :628 (_shade_kernel :354, call :643)
//   K2c render_rays_tiles       :717 (_render_rays_kernel :540, call :733)
//   K2d sample_tiles            :760 (_sampler_kernel :274, call :781)
// For every pixel tile of rpt rays with k samples each (kg depth groups of
// ks = k/kg) they share one device path per sample:
//   1. sample the three bf16 triplanes bilinearly inside each (tile, plane,
//      group) job's window: u' = clip(u - ou, 0, wu - 1.001) and likewise v,
//      the two u tent weights rounded to bf16 and the two v weights kept in
//      f32, as the TPU kernel's two-hot products round them (sample_plane);
//   2. (K2, K2b, K2c) run the ER-NeRF head (audio channel attention, sigma
//      net with the eye attention, colour net) on the 48 features, rounding
//      the left operand of every product to bf16 when the weights are bf16,
//      with f32 accumulation, as _shade_core's mm does (shade);
//   3. (K2, K2c) composite each ray's samples in depth order: sigma =
//      exp(logit), alpha = 1 - exp(-sigma dt), T = exp(-sum of earlier
//      sigma dt), weight = alpha T where T > 1e-4, rgb = sigmoid(logit)
//      1.002 - 0.001, and write [T, rpt, 16]: lane 0 sum of weights, lanes
//      1:4 sum of weight rgb, the rest 0 (composite_ray).
// What differs: K2b writes each sample's activated sigma and rgb ([T, kg
// sg, 16]) instead of step 3; K2c makes each sample's texel coordinate from
// its ray's (o, d, zmin, zmax) and the job's mip level (as
// _render_rays_kernel: kf = (g ks + j) / (k - 1), a true division; xyz =
// clip(o + d z); texel (xyz + bound) scale - 0.5; tex 2^-lvl + 0.5 2^-lvl -
// 0.5 (+ mip_base for u)) and takes dt = span / k; K2d writes the 48
// features as bf16 ([T, kg, sg, 48]) and stops after step 1.
//
// Bounds at the dense 512^2 job set (T = 2048 tiles of 16 x 8 rays, k = 16,
// so 4.19 M samples, planes [3, 1984, 16384] bf16 = 195 MB, uv 101 MB):
//   K2, K2b, K2c: the head is 21,840 multiply-adds per sample over the 36
//   real features (the 12 zero lanes of padding are not work), plus 9
//   operations per real channel of the bilinear sample: 44,004 operations,
//   0.187 ms at the H100's 989 TFLOP/s bf16 tensor rate, above their bytes
//   (K2 0.11 ms; K2b 0.18 ms with its 268 MB of per-sample output and the
//   64 real lanes of its dproj; K2c 0.07 ms: 8 MB of rays instead of the
//   uv). Bound by operations. With f32 weights the same operations as three
//   TF32 products a term take 1.12 ms at 495 TFLOP/s (2.76 ms as f32 FMAs
//   at 67 TFLOP/s on the CUDA cores): K2's f32 bound.
//   K2d: no head, 9 operations per real channel; uv, planes and its 403 MB
//   bf16 output take 0.21 ms at 3.35 TB/s. Bound by bytes.
//
// Design:
//   - K2 with bf16 weights (sample_shade_comp_wgmma_kernel): the head on the
//     tensor cores (head_rows in csrc/sampler_core.cuh). A grid of the
//     resident blocks loops over the tiles; each block stages the bf16
//     weights once (~54 KB of swizzled W^T tiles), then per tile the tile's
//     direction projections and job table. Each of its three warpgroups
//     takes a 64-sample row block of the tile at a time: two threads a
//     sample fetch its 48 features (step 1, as below; 8 channels of each
//     plane a thread) into a swizzled bf16 x tile, then the warpgroup runs
//     the head on it as wgmma products (a last partial block padded with
//     zero rows, not stored). A hidden value that lies near a bf16 rounding
//     tie is summed again on the CUDA cores in the plain version's
//     sequential order, so that it rounds as the plain version rounds it
//     (settle). The (sigma, rgb) logits go to shared memory and one thread
//     per ray folds them (step 3).
//   - K2 with f32 weights (sample_shade_comp_tf32_kernel): the head on the
//     tensor cores as mma.sync m16n8k8 TF32 products, each f32 product
//     taken as three (a_lo b_hi + a_hi b_lo + a_hi b_hi; a_hi rounded as
//     cvt.rna.tf32 rounds, by two integer operations; f32 weights round
//     nothing, so nothing needs settling) (head_tf32 in csrc/sampler_core.cuh). A grid of the resident blocks of eight warps
//     loops over the tiles; each block stages the f32 weights once as W^T
//     rows padded to a conflict-free stride (~106 KB); each warp takes 32
//     samples of the tile at a time: one thread a sample fetches its 48
//     features (step 1) into the warp's x rows in shared memory, then the
//     warp runs the head as two m16 row tiles, each B fragment read and
//     split once for both; a layer's accumulator is the next layer's A
//     fragment in registers (the contraction permuted within each k8 step,
//     no shuffle). The logits go to shared memory for step 3, as above.
//   - K2b, K2c: one block of 256 threads per tile; the
//     head's weights (~95 KB as f32, transposed so each output's weights are
//     contiguous) and the tile's direction projections are staged into
//     shared memory (stage_tile); each thread takes samples n = tid, tid +
//     256, ... of the tile and runs steps 1-2 for it in registers (the head
//     as f32 FMAs on the CUDA cores: exact products of bf16-rounded operands
//     with bf16 weights); K2b writes its sample's row, the others put
//     (sigma logit, 3 rgb logits) in shared memory for step 3.
//   - Step 1 gathers texels straight from global memory (a job's window is
//     local, so L1/L2 serve the reuse that the TPU kernel got from its DMA'd
//     windows); one thread per ray folds its k samples in order, so the
//     transmittance needs no scan.
//   - K2d: one thread per sample, no shared memory: 12 texel pairs in,
//     96 bytes out, neighbouring threads on neighbouring rows.
// Next: K2b, K2c and S2's stage kernel on the tensor-core heads; K2's bf16
// settle; the f32 head's B fragments split once per block rather than per
// use; a cp.async window ring for the fetch.
//
// The device code the four kernels share, which S1 and S2 are also made of,
// is in csrc/sampler_core.cuh.

#include "sampler_core.cuh"

namespace {

// K2 with bf16 weights and dproj: the head on the tensor cores. A grid of
// resident blocks of two warpgroups, each block looping over tiles.
__global__ void __launch_bounds__(HEAD_THREADS, 1)
sample_shade_comp_wgmma_kernel(const __nv_bfloat16* __restrict__ planes,
                               const int* __restrict__ jobs, const float* __restrict__ uv,
                               const __nv_bfloat16* __restrict__ dproj,
                               const float* __restrict__ dtv, Weights wp, float* __restrict__ out,
                               int tiles, int rpt, int kg, int ks, int wu, int wv, int rows,
                               int rv) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int sg = rpt * ks;
  const int ns = kg * sg;
  auto* s_dp = reinterpret_cast<__nv_bfloat16*>(base + H_FIXED);   // [rpt][64]
  auto* s_res = reinterpret_cast<float4*>(s_dp + rpt * HID);        // [kg * sg]
  int* s_jobs = reinterpret_cast<int*>(s_res + ns);                 // [3][1 + 2kg]
  const int n_jobs = 3 * (1 + 2 * kg);
  const int tid = threadIdx.x, wg = tid / WG_SIZE, wt = tid % WG_SIZE;
  uint8_t* x_wg = base + H_X + wg * X_TILE;   // this warpgroup's x tile
  const float umax = (float)((double)wu - 1.001);
  const float vmax = (float)((double)wv - 1.001);

  stage_head_weights(base, wp);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const uint4* dp = reinterpret_cast<const uint4*>(dproj + (size_t)t * rpt * HID);
    for (int e = tid; e < rpt * HID / 8; e += HEAD_THREADS) reinterpret_cast<uint4*>(s_dp)[e] = dp[e];
    for (int e = tid; e < n_jobs; e += HEAD_THREADS) s_jobs[e] = jobs[(size_t)t * n_jobs + e];
    __syncthreads();   // the weights (first tile), dp and jobs are staged; the last
                       // tile's composite is done with s_res

    // row blocks of 64 samples in turn; two threads a sample fetch half its
    // channels each
    for (int n0 = HEAD_ROWS * wg; n0 < ns; n0 += HEAD_ROWS * HEAD_WGS) {
      const int n = n0 + wt % HEAD_ROWS, h = wt / HEAD_ROWS;
      float x[24];
      if (n < ns) {
        const int g = n / sg;
        sample_uv<1>(planes, s_jobs, uv, t, g, n - g * sg, kg, sg, umax, vmax, rows, rv, x, h);
      } else {
#pragma unroll
        for (int k = 0; k < 24; ++k) x[k] = 0.f;
      }
      write_x_half(x_wg, wt % HEAD_ROWS, h, x);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // seen by wgmma
      asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG_SIZE) : "memory");
      head_rows(base, x_wg, s_dp, s_res, n0, ns, sg, ks);
      asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG_SIZE) : "memory");  // x tile read
    }
    __syncthreads();

    for (int r = tid; r < rpt; r += HEAD_THREADS)
      composite_ray(s_res, r, kg, ks, sg, dtv[((size_t)t * rpt + r) * 8],
                    out + ((size_t)t * rpt + r) * 16);
  }
}

// K2 with f32 weights and dproj: the head on the tensor cores as three TF32
// products a term (head_tf32). A grid of resident blocks of TF_WARPS warps,
// each block looping over tiles; each warp takes TF_ROWS samples at a time.
__global__ void __launch_bounds__(TF_THREADS, 1)
sample_shade_comp_tf32_kernel(const __nv_bfloat16* __restrict__ planes,
                              const int* __restrict__ jobs, const float* __restrict__ uv,
                              const float* __restrict__ dproj, const float* __restrict__ dtv,
                              Weights wp, float* __restrict__ out, int tiles, int rpt, int kg,
                              int ks, int wu, int wv, int rows, int rv) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int sg = rpt * ks;
  const int ns = kg * sg;
  float4* s_res = reinterpret_cast<float4*>(sm + F_FIXED);   // [kg * sg]
  int* s_jobs = reinterpret_cast<int*>(s_res + ns);          // [3][1 + 2kg]
  const int n_jobs = 3 * (1 + 2 * kg);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float umax = (float)((double)wu - 1.001);
  const float vmax = (float)((double)wv - 1.001);

  stage_tf32_weights(sm, wp);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int e = tid; e < n_jobs; e += TF_THREADS) s_jobs[e] = jobs[(size_t)t * n_jobs + e];
    __syncthreads();   // the weights (first tile) and jobs are staged; the last
                       // tile's composite is done with s_res

    // row blocks of TF_ROWS samples a warp; 32 / TF_ROWS threads a sample
    // fetch its features (all, or half of each plane's) into the x rows
    constexpr int HALVES = TF_ROWS == 32 ? 2 : 1;
    float* xs = sm + F_X + warp * TF_ROWS * TS48;
    for (int n0 = TF_ROWS * warp; n0 < ns; n0 += TF_ROWS * TF_WARPS) {
      const int r = lane % TF_ROWS, h = lane / TF_ROWS, n = n0 + r;
      float x[24 * HALVES];
      if (n < ns) {
        const int gr = n / sg;
        sample_uv<HALVES>(planes, s_jobs, uv, t, gr, n - gr * sg, kg, sg, umax, vmax, rows, rv, x,
                          h);
      } else {   // a last partial row block: zero rows, not stored
#pragma unroll
        for (int k = 0; k < 24 * HALVES; ++k) x[k] = 0.f;
      }
      __syncwarp();   // the last row block's products have read the x rows
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int c = 0; c < 8 * HALVES; c += 4)
          *reinterpret_cast<float4*>(xs + r * TS48 + CP * q + 8 * h + c) =
              make_float4(x[8 * HALVES * q + c], x[8 * HALVES * q + c + 1],
                          x[8 * HALVES * q + c + 2], x[8 * HALVES * q + c + 3]);
      __syncwarp();
      head_tf32<TF_MT>(sm, xs, dproj + (size_t)t * rpt * HID, s_res, n0, ns, sg, ks);
    }
    __syncthreads();

    for (int r = tid; r < rpt; r += TF_THREADS)
      composite_ray(s_res, r, kg, ks, sg, dtv[((size_t)t * rpt + r) * 8],
                    out + ((size_t)t * rpt + r) * 16);
  }
}

// K2b: K2 without the composite; each sample's activated sigma and rgb.
template <typename WT>
__global__ void __launch_bounds__(THREADS, 1)
sample_shade_kernel(const __nv_bfloat16* __restrict__ planes, const int* __restrict__ jobs,
                    const float* __restrict__ uv, const WT* __restrict__ dproj, Weights wp,
                    float* __restrict__ out, int rpt, int kg, int ks, int wu, int wv, int rows,
                    int rv) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  float* s_dp = s + W_FLOATS;                                  // [rpt][64]
  int* s_jobs = reinterpret_cast<int*>(s_dp + rpt * HID);      // [3][1 + 2kg]
  const int sg = rpt * ks;
  const int ns = kg * sg;
  const int t = blockIdx.x;
  constexpr bool RB = sizeof(WT) == 2;

  stage_tile<WT>(s, s_dp, s_jobs, wp, dproj, 2 * HID, jobs, 3 * (1 + 2 * kg), t, rpt);
  __syncthreads();

  const float umax = (float)((double)wu - 1.001);
  const float vmax = (float)((double)wv - 1.001);
  for (int n = threadIdx.x; n < ns; n += THREADS) {
    const int g = n / sg;
    const int lane = n - g * sg;
    float x[XD];
    sample_uv(planes, s_jobs, uv, t, g, lane, kg, sg, umax, vmax, rows, rv, x);
    const float4 v = shade<RB>(x, s, s_dp + (lane / ks) * HID);
    float4* o = reinterpret_cast<float4*>(out + ((size_t)t * ns + n) * 16);
    o[0] = make_float4(expf(v.x), rgb_act(v.y), rgb_act(v.z), rgb_act(v.w));
    o[1] = o[2] = o[3] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// K2c: K2 with each sample's coordinates made from its ray (rays [T, rpt,
// 8]: o, d, zmin, zmax) and the jobs' (ou, ov, lvl, mip_base) per group.
template <typename WT>
__global__ void __launch_bounds__(THREADS, 1)
render_rays_kernel(const __nv_bfloat16* __restrict__ planes, const int* __restrict__ jobs,
                   const float* __restrict__ rays, const WT* __restrict__ dproj, Weights wp,
                   float* __restrict__ out, int rpt, int kg, int ks, int wu, int wv, int rows,
                   int rv, float bound, float scale) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  float* s_dp = s + W_FLOATS;                                  // [rpt][64]
  float* s_rays = s_dp + rpt * HID;                            // [rpt][8]
  float4* s_res = reinterpret_cast<float4*>(s_rays + rpt * 8);  // [kg * sg]
  const int sg = rpt * ks;
  const int ns = kg * sg;
  int* s_jobs = reinterpret_cast<int*>(s_res + ns);            // [3][1 + 4kg]
  const int stride = 1 + 4 * kg;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  constexpr bool RB = sizeof(WT) == 2;

  stage_tile<WT>(s, s_dp, s_jobs, wp, dproj, HID, jobs, 3 * stride, t, rpt);
  for (int e = tid; e < rpt * 8; e += THREADS) s_rays[e] = rays[(size_t)t * rpt * 8 + e];
  __syncthreads();

  const float umax = (float)((double)wu - 1.001);
  const float vmax = (float)((double)wv - 1.001);
  const float km1 = (float)(kg * ks - 1);
  for (int n = tid; n < ns; n += THREADS) {
    const int g = n / sg;
    const int lane = n - g * sg;
    const int r = lane / ks;
    const float* ray = s_rays + r * 8;
    const float kf = __fdiv_rn((float)(g * ks + lane - r * ks), km1);
    const float z = __fadd_rn(ray[6], __fmul_rn(__fsub_rn(ray[7], ray[6]), kf));
    float tex[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float xyz = fminf(fmaxf(__fadd_rn(ray[c], __fmul_rn(ray[3 + c], z)), -bound), bound);
      tex[c] = __fsub_rn(__fmul_rn(__fadd_rn(xyz, bound), scale), 0.5f);
    }
    float x[XD];
#pragma unroll
    for (int q = 0; q < 3; ++q) {   // planes xy (x, y), yz (z, y), xz (z, x)
      const int* job = s_jobs + q * stride + 4 * g;
      const float inv = ldexpf(1.f, -job[3]);                  // 2^-lvl
      const float cv = __fsub_rn(__fmul_rn(0.5f, inv), 0.5f);
      const float cu = __fadd_rn(cv, (float)job[4]);
      const float u = __fadd_rn(__fmul_rn(tex[q == 0 ? 0 : 2], inv), cu);
      const float v = __fadd_rn(__fmul_rn(tex[q == 2 ? 0 : 1], inv), cv);
      sample_plane(planes, s_jobs[q * stride], job[1], job[2], u, v, umax, vmax, rows, rv, x, q);
    }
    s_res[n] = shade<RB>(x, s, s_dp + r * HID);
  }
  __syncthreads();

  for (int r = tid; r < rpt; r += THREADS) {
    const float* ray = s_rays + r * 8;
    composite_ray(s_res, r, kg, ks, sg, __fdiv_rn(__fsub_rn(ray[7], ray[6]), (float)(kg * ks)),
                  out + ((size_t)t * rpt + r) * 16);
  }
}

// K2d: one thread per sample; its 48 features as bf16.
__global__ void __launch_bounds__(THREADS)
sample_tiles_kernel(const __nv_bfloat16* __restrict__ planes, const int* __restrict__ jobs,
                    const float* __restrict__ uv, __nv_bfloat16* __restrict__ out, int tiles,
                    int rpt, int kg, int ks, int wu, int wv, int rows, int rv) {
  const int sg = rpt * ks;
  const int ns = kg * sg;
  const size_t id = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (id >= (size_t)tiles * ns) return;
  const int t = (int)(id / ns);
  const int n = (int)(id - (size_t)t * ns);
  const int g = n / sg;
  const float umax = (float)((double)wu - 1.001);
  const float vmax = (float)((double)wv - 1.001);
  float x[XD];
  sample_uv(planes, jobs + (size_t)t * 3 * (1 + 2 * kg), uv, t, g, n - g * sg, kg, sg, umax,
            vmax, rows, rv, x);
  uint4* o = reinterpret_cast<uint4*>(out + id * XD);
#pragma unroll
  for (int i = 0; i < XD / 8; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(x[8 * i + 2 * h], x[8 * i + 2 * h + 1]);
      w[h] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    o[i] = make_uint4(w[0], w[1], w[2], w[3]);
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

}  // namespace

// Common arguments: planes [3, rows, rv * 16] bf16; jobs int32, per tile 3
// jobs of (plane, then 2 (K2, K2b, K2d) or 4 (K2c) ints per group); the 13
// shade weights in SHADE_WEIGHTS order and dproj, all f32 or all bf16 (bf16
// != 0); geometry tiles, rpt, kg, ks, wu, wv, rows, rv. All contiguous on
// CUDA device `device`; `stream` belongs to it. Each returns the
// cudaError_t of its launch.

// K2: uv [3 tiles, kg, 2, rpt * ks] f32; dproj [tiles, rpt, 64]; dtv [tiles,
// rpt, 8] f32; out [tiles, rpt, 16] f32. bf16 weights take the wgmma kernel,
// f32 weights the 3xTF32 one; the block's shared memory (head_smem,
// tf32_smem) must fit its 227 KB.
extern "C" int mf_sample_shade_comp(
    int device, int bf16, const void* planes, const void* jobs, const void* uv,
    const void* dproj, const void* dtv, const void* wx_aud, const void* w_aud1,
    const void* wx_sig, const void* w_aud_sig, const void* wx_eye, const void* w_eye1,
    const void* w_sig_e, const void* w_sig1, const void* w_sigcol, const void* w_geo,
    const void* w_col_g, const void* w_rgb, const void* col_bias, void* out, int tiles,
    int rpt, int kg, int ks, int wu, int wv, int rows, int rv, void* stream) {
  if (bad_geometry(tiles, rpt, kg, ks, wu, wv, rows, rv, 2)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Weights wp = {{wx_aud, w_aud1, wx_sig, w_aud_sig, wx_eye, w_eye1, w_sig_e, w_sig1,
                       w_sigcol, w_geo, w_col_g, w_rgb, col_bias}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const __nv_bfloat16*>(planes);
  const auto* j = static_cast<const int*>(jobs);
  const auto* u = static_cast<const float*>(uv);
  const auto* d = static_cast<const float*>(dtv);
  auto* o = static_cast<float*>(out);
  if (bf16)
    return (int)launch_resident(sample_shade_comp_wgmma_kernel, HEAD_THREADS,
                                head_smem(rpt, (size_t)kg * rpt * ks), tiles, device, s, p, j, u,
                                static_cast<const __nv_bfloat16*>(dproj), d, wp, o, tiles, rpt,
                                kg, ks, wu, wv, rows, rv);
  return (int)launch_resident(sample_shade_comp_tf32_kernel, TF_THREADS,
                              tf32_smem((size_t)kg * rpt * ks), tiles, device, s, p, j, u,
                              static_cast<const float*>(dproj), d, wp, o, tiles, rpt, kg, ks,
                              wu, wv, rows, rv);
}

// K2b: uv as K2's; dproj [tiles, rpt, 128] (lanes 64: unused); out [tiles,
// kg * rpt * ks, 16] f32.
extern "C" int mf_sample_shade(
    int device, int bf16, const void* planes, const void* jobs, const void* uv,
    const void* dproj, const void* wx_aud, const void* w_aud1, const void* wx_sig,
    const void* w_aud_sig, const void* wx_eye, const void* w_eye1, const void* w_sig_e,
    const void* w_sig1, const void* w_sigcol, const void* w_geo, const void* w_col_g,
    const void* w_rgb, const void* col_bias, void* out, int tiles, int rpt, int kg, int ks,
    int wu, int wv, int rows, int rv, void* stream) {
  if (bad_geometry(tiles, rpt, kg, ks, wu, wv, rows, rv, 2)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Weights wp = {{wx_aud, w_aud1, wx_sig, w_aud_sig, wx_eye, w_eye1, w_sig_e, w_sig1,
                       w_sigcol, w_geo, w_col_g, w_rgb, col_bias}};
  const size_t bytes = shade_smem(rpt, HID, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const __nv_bfloat16*>(planes);
  const auto* j = static_cast<const int*>(jobs);
  const auto* u = static_cast<const float*>(uv);
  auto* o = static_cast<float*>(out);
  if (bf16)
    return (int)launch_tiles(sample_shade_kernel<__nv_bfloat16>, bytes, tiles, s, p, j, u,
                             static_cast<const __nv_bfloat16*>(dproj), wp, o, rpt, kg, ks, wu,
                             wv, rows, rv);
  return (int)launch_tiles(sample_shade_kernel<float>, bytes, tiles, s, p, j, u,
                           static_cast<const float*>(dproj), wp, o, rpt, kg, ks, wu, wv, rows,
                           rv);
}

// K2c: rays [tiles, rpt, 8] f32 (o, d, zmin, zmax); dproj [tiles, rpt, 64];
// bound and scale = R / (2 bound) as f32; out [tiles, rpt, 16] f32.
extern "C" int mf_render_rays(
    int device, int bf16, const void* planes, const void* jobs, const void* rays,
    const void* dproj, const void* wx_aud, const void* w_aud1, const void* wx_sig,
    const void* w_aud_sig, const void* wx_eye, const void* w_eye1, const void* w_sig_e,
    const void* w_sig1, const void* w_sigcol, const void* w_geo, const void* w_col_g,
    const void* w_rgb, const void* col_bias, void* out, int tiles, int rpt, int kg, int ks,
    int wu, int wv, int rows, int rv, float bound, float scale, void* stream) {
  if (bad_geometry(tiles, rpt, kg, ks, wu, wv, rows, rv, 4)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Weights wp = {{wx_aud, w_aud1, wx_sig, w_aud_sig, wx_eye, w_eye1, w_sig_e, w_sig1,
                       w_sigcol, w_geo, w_col_g, w_rgb, col_bias}};
  const size_t bytes = shade_smem(rpt, HID + 8, (size_t)kg * rpt * ks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const __nv_bfloat16*>(planes);
  const auto* j = static_cast<const int*>(jobs);
  const auto* r = static_cast<const float*>(rays);
  auto* o = static_cast<float*>(out);
  if (bf16)
    return (int)launch_tiles(render_rays_kernel<__nv_bfloat16>, bytes, tiles, s, p, j, r,
                             static_cast<const __nv_bfloat16*>(dproj), wp, o, rpt, kg, ks, wu,
                             wv, rows, rv, bound, scale);
  return (int)launch_tiles(render_rays_kernel<float>, bytes, tiles, s, p, j, r,
                           static_cast<const float*>(dproj), wp, o, rpt, kg, ks, wu, wv, rows,
                           rv, bound, scale);
}

// K2d: uv as K2's; out [tiles, kg, rpt * ks, 48] bf16.
extern "C" int mf_sample_tiles(int device, const void* planes, const void* jobs,
                               const void* uv, void* out, int tiles, int rpt, int kg, int ks,
                               int wu, int wv, int rows, int rv, void* stream) {
  if (bad_geometry(tiles, rpt, kg, ks, wu, wv, rows, rv, 2)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)tiles * kg * rpt * ks;
  const size_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  sample_tiles_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(planes), static_cast<const int*>(jobs),
      static_cast<const float*>(uv), static_cast<__nv_bfloat16*>(out), tiles, rpt, kg, ks, wu,
      wv, rows, rv);
  return (int)cudaGetLastError();
}
