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
//      with f32 accumulation, as _shade_core's mm does (head_rows,
//      head_tf32);
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
//   at 67 TFLOP/s on the CUDA cores): their f32 bound.
//   K2d: no head, 9 operations per real channel; uv (101 MB), the texels
//   its samples weigh (1.3 MB) and its 403 MB bf16 output take 0.15 ms at
//   3.35 TB/s (chip_smoke.py family_bound_ms). Bound by bytes; the card
//   also gathers 1.61 GB of texels through L1 for it.
//
// Design:
//   - K2, K2b and K2c are instances of two kernels, one per weight dtype,
//     templates on what they run (Stage in csrc/sampler_core.cuh: STAGE_FULL,
//     STAGE_ROWS, STAGE_RAYS; S2's stages are two more): one body, so the
//     three cannot drift apart. They share everything below but where a
//     sample's coordinates come from and what a tile writes.
//   - With bf16 weights (sample_shade_comp_wgmma_kernel): the head on the
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
//     (settle). The (sigma, rgb) logits go to shared memory.
//   - With f32 weights (sample_shade_comp_tf32_kernel): the head on the
//     tensor cores as mma.sync m16n8k8 TF32 products, each f32 product
//     taken as three (a_lo b_hi + a_hi b_lo + a_hi b_hi; a_hi rounded as
//     cvt.rna.tf32 rounds, by two integer operations; f32 weights round
//     nothing, so nothing needs settling) (head_tf32 in
//     csrc/sampler_core.cuh). A grid of the resident blocks of eight warps
//     loops over the tiles; each block stages the f32 weights once as W^T
//     rows padded to a conflict-free stride (~106 KB); each warp takes 32
//     samples of the tile at a time: one thread a sample fetches its 48
//     features (step 1) into the warp's x rows in shared memory, then the
//     warp runs the head as two m16 row tiles, each B fragment read and
//     split once for both; a layer's accumulator is the next layer's A
//     fragment in registers (the contraction permuted within each k8 step,
//     no shuffle). The logits go to shared memory.
//   - After a tile's row blocks, K2 and K2c fold each ray's logits, one
//     thread a ray, in depth order, so the transmittance needs no scan (step
//     3; K2c's dt from its ray); K2b's threads write the tile's activated
//     rows in 16-byte stores, neighbouring threads on neighbouring chunks.
//   - K2c's fetching threads make their sample's coordinates from its ray,
//     read through L1 (both threads of a sample in the bf16 kernel; a few
//     dozen operations), so its block needs exactly K2's shared memory;
//     K2b reads the first 64 lanes of its 128-wide dproj rows.
//   - Step 1 gathers texels straight from global memory (a job's window is
//     local, so L1/L2 serve the reuse that the TPU kernel got from its DMA'd
//     windows).
//   - K2d: a grid of resident blocks of 512 threads, two an SM, loops over
//     (tile, depth group) units; the block copies the next unit's job table
//     and uv rows into the other of two shared buffers with cp.async
//     (25 KB a block at the dense set, so most of the SM's 256 KB stays L1
//     for the gathers: each texel is read about 1,200 times). One thread
//     makes one 16-byte chunk of the unit's [sg, 48] bf16 output at a time
//     (sample, plane, half of its 16 channels: sample_plane's arithmetic in
//     its order, bit-equal to the plain version) and writes it with an
//     evict-first hint (__stcs); neighbouring threads write neighbouring
//     chunks, so a warp's store is 512 contiguous bytes.
//   - What scripts/prof_fetch.py measured (PERF.md, H100): the first design
//     (one thread a sample, six 16-byte stores 96 bytes apart across a
//     warp's threads) took 0.337 ms, 0.171 without its stores and 0.423
//     without its gathers; this design takes 0.233 ms, 0.227 without its
//     stores and 0.186 without its gathers, 0.238 with write-back stores:
//     neither stream sets its pace alone. Three blocks an SM (40 registers)
//     spill and read 0.240.
//
// The device code the four kernels share, which S1 and S2 are also made of,
// is in csrc/sampler_core.cuh, with K2's two tensor-core kernels themselves.

#include "sampler_core.cuh"

namespace {

// K2d's block: two buffers of a tile's job table (MAX_JOB_INTS ints) and one
// depth group's uv rows ([3][2][staged_stride(sg)] f32: plane, u or v).
__host__ __device__ constexpr size_t k2d_buffer_bytes(int sg) {
  return sizeof(int) * MAX_JOB_INTS + sizeof(float) * 6 * staged_stride(sg);
}
size_t k2d_smem(int sg) { return 2 * k2d_buffer_bytes(sg); }

// K2d: a resident block loops over (tile, depth group) units; one thread
// makes one 16-byte chunk of the unit's [sg, 48] bf16 output at a time:
// sample s, plane q, half h of its 16 channels.
constexpr int K2D_THREADS = 512;
constexpr int K2D_PER_SM = 2;

__global__ void __launch_bounds__(K2D_THREADS, K2D_PER_SM)
sample_tiles_kernel(const __nv_bfloat16* __restrict__ planes, const int* __restrict__ jobs,
                    const float* __restrict__ uv, __nv_bfloat16* __restrict__ out, int tiles,
                    int rpt, int kg, int ks, int wu, int wv, int rows, int rv) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int sg = rpt * ks, sgp = staged_stride(sg), stride = 1 + 2 * kg, njob = 3 * stride;
  const int units = tiles * kg, chunks = sg * XD / 8;
  const size_t buf = k2d_buffer_bytes(sg);
  const float umax = (float)((double)wu - 1.001);
  const float vmax = (float)((double)wv - 1.001);
  const bool vec = (sg & 3) == 0 && (reinterpret_cast<uintptr_t>(uv) & 15) == 0;
  auto stage = [&](int unit, int b) {   // unit (t, g)'s jobs and uv rows into buffer b
    const int t = unit / kg, g = unit - t * kg;
    int* sj = reinterpret_cast<int*>(smem + b * buf);
    for (int e = threadIdx.x; e < njob; e += K2D_THREADS)
      cp_async4(sj + e, jobs + (size_t)t * njob + e);
    stage_runs<K2D_THREADS>(  // run 2 q + h: plane q's u (h 0) or v (h 1)
        reinterpret_cast<float*>(sj + MAX_JOB_INTS), sgp,
        [&](int i) { return uv + ((((size_t)t * 3 + (i >> 1)) * kg + g) * 2 + (i & 1)) * sg; },
        6, sg, vec);
    cp_async_commit();
  };
  if ((int)blockIdx.x < units) stage(blockIdx.x, 0);
  int b = 0;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x, b ^= 1) {
    if (unit + (int)gridDim.x < units) stage(unit + gridDim.x, b ^ 1);
    else cp_async_commit();                     // an empty group: the wait below stays right
    cp_async_wait_prior();
    __syncthreads();
    const int* sj = reinterpret_cast<const int*>(smem + b * buf);
    const float* su = reinterpret_cast<const float*>(sj + MAX_JOB_INTS);
    const int g = unit % kg;
    uint4* o = reinterpret_cast<uint4*>(out) + (size_t)unit * chunks;   // out[t][g]
    for (int c = threadIdx.x; c < chunks; c += K2D_THREADS) {
      const int s = c / 6, r = c - 6 * s, q = r >> 1, h = r & 1;
      const int* job = sj + q * stride;
      const float* uvq = su + 2 * q * sgp;
      float x[24];
      sample_plane<1>(planes, job[0], job[1 + 2 * g], job[2 + 2 * g], uvq[s], uvq[sgp + s], umax,
                      vmax, rows, rv, x, 0, h);
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
        w[k] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      __stcs(o + c, make_uint4(w[0], w[1], w[2], w[3]));
    }
    __syncthreads();                            // buffer b is free for the unit after next
  }
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
// f32 weights the 3xTF32 one (launch_k2); the block's shared memory
// (head_smem, tf32_smem) must fit its 227 KB, as must K2b's and K2c's, the
// same.
extern "C" int mf_sample_shade_comp(
    int device, int bf16, const void* planes, const void* jobs, const void* uv,
    const void* dproj, const void* dtv, const void* wx_aud, const void* w_aud1,
    const void* wx_sig, const void* w_aud_sig, const void* wx_eye, const void* w_eye1,
    const void* w_sig_e, const void* w_sig1, const void* w_sigcol, const void* w_geo,
    const void* w_col_g, const void* w_rgb, const void* col_bias, void* out, int tiles,
    int rpt, int kg, int ks, int wu, int wv, int rows, int rv, void* stream) {
  const Weights wp = {{wx_aud, w_aud1, wx_sig, w_aud_sig, wx_eye, w_eye1, w_sig_e, w_sig1,
                       w_sigcol, w_geo, w_col_g, w_rgb, col_bias}};
  return launch_k2<STAGE_FULL>(device, bf16, planes, jobs, uv, dproj, dtv, wp, out, tiles, rpt,
                               kg, ks, wu, wv, rows, rv, 0.f, 0.f, stream);
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
  const Weights wp = {{wx_aud, w_aud1, wx_sig, w_aud_sig, wx_eye, w_eye1, w_sig_e, w_sig1,
                       w_sigcol, w_geo, w_col_g, w_rgb, col_bias}};
  return launch_k2<STAGE_ROWS>(device, bf16, planes, jobs, uv, dproj, nullptr, wp, out, tiles,
                               rpt, kg, ks, wu, wv, rows, rv, 0.f, 0.f, stream);
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
  const Weights wp = {{wx_aud, w_aud1, wx_sig, w_aud_sig, wx_eye, w_eye1, w_sig_e, w_sig1,
                       w_sigcol, w_geo, w_col_g, w_rgb, col_bias}};
  return launch_k2<STAGE_RAYS>(device, bf16, planes, jobs, rays, dproj, nullptr, wp, out, tiles,
                               rpt, kg, ks, wu, wv, rows, rv, bound, scale, stream);
}

// K2d: uv as K2's; out [tiles, kg, rpt * ks, 48] bf16.
extern "C" int mf_sample_tiles(int device, const void* planes, const void* jobs,
                               const void* uv, void* out, int tiles, int rpt, int kg, int ks,
                               int wu, int wv, int rows, int rv, void* stream) {
  if (bad_geometry(tiles, rpt, kg, ks, wu, wv, rows, rv, 2)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)tiles * kg > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return (int)launch_fetch(sample_tiles_kernel, K2D_THREADS, k2d_smem(rpt * ks), K2D_PER_SM,
                           tiles * kg, device, static_cast<cudaStream_t>(stream),
                           static_cast<const __nv_bfloat16*>(planes),
                           static_cast<const int*>(jobs), static_cast<const float*>(uv),
                           static_cast<__nv_bfloat16*>(out), tiles, rpt, kg, ks, wu, wv, rows,
                           rv);
}
