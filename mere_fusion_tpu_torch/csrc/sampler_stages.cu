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
//   output lane and (q, g) take 0.1 ms at the card's f32 rate. The card
//   does more than those: each output lane and (q, g) also takes two
//   integer unpackings of bf16 texels, and each row gathers its 2 x 3 kg
//   texel rows itself (6.4 GB through L1 for the tiles' 403 MB of
//   windows), so S1 is bound by its per-row work before its bytes.
//   S2 win: bytes, uv (101 MB), the texels and 17 MB of output.
//   S2 shade: operations, K2's head and sample over all 48 lanes (these
//   inputs fill the padding), 47,568 per sample: 0.20 ms at 989 TFLOP/s
//   with bf16 weights; with f32 weights the lesser of three TF32 products
//   at 495 TFLOP/s and f32 FMAs at 67 TFLOP/s (chip_smoke.py head_ops_ms).
//
// Design:
//   - S1: a grid of resident blocks, one block of 1,024 threads an SM,
//     loops over the tiles, so that the SM's L1 holds one tile's windows
//     (192 KB at the profiling operands, beside 58 KB of shared memory).
//     The block copies the next tile's job table and u rows into the other
//     of two shared buffers with cp.async while it works on this one. A
//     warp takes rows in batches of 32 / (a row's steps): lane i makes one
//     (row, step)'s two bf16 u tents (K2's u_tent) and texel offset into
//     the warp's records; then for each row, each lane owning 4 of its 128
//     lanes, it issues the texel loads of 4 steps at a time before their
//     sums, in step order (plane outer, group inner; w0 a0 + w1 a1 as one
//     fused add of the two products, which are exact, then the running sum:
//     bit-equal to the plain version), and stores the row as a float4 a
//     lane with an evict-first hint (__stcs), so that the output stream
//     does not push the windows out of L2.
//   - What scripts/prof_fetch.py measured (PERF.md, H100): the first design
//     (one warp a row, 8 rows a block, so a tile's rows spread over 64
//     blocks) took 1.45 ms, 1.05 without its texel loads and 1.46 without
//     its stores; issuing a row's 12 steps' loads before its sums
//     took it to 89 registers and 3.98 ms. This design takes 0.68 ms: 0.48
//     without texel loads, 0.57 without the unpacking and sums, 0.69 with
//     one store a warp. All 12 steps' loads at once need 128 registers,
//     so 512 threads (0.81-0.88 ms); 768 threads of 6 steps read 0.72, two
//     blocks of 512 of 4 steps 0.68-0.70. Per-row work (the records, the
//     unpacking, the sums) sets the pace and the windows' L1 misses add
//     0.2 ms; staging whole windows in shared memory instead (192 KB a tile
//     at kg 4, 384 KB at kg 8) does not fit beside the coordinates.
//     blockdiag takes 0.92 ms, 0.66 without its stores (2.15 GB).
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

// S1's block: each warp's 32 step records (uint2: the two u tents as bf16,
// the texel offset), then two buffers of a tile's job table (MAX_JOB_INTS
// ints) and u rows ([3 kg][staged_stride(sg)] f32).
constexpr int S1_THREADS = 1024;  // one block an SM, so that its L1 holds one tile's windows
constexpr int S1_PER_SM = 1;
constexpr int S1_BATCH = 4;       // (plane, group) steps whose texel loads a lane issues together
constexpr int S1_WARPS = S1_THREADS / 32;
constexpr size_t S1_RECORDS = sizeof(uint2) * 32 * S1_WARPS;

__host__ __device__ constexpr size_t s1_buffer_bytes(int kg, int sg) {
  return sizeof(int) * MAX_JOB_INTS + sizeof(float) * 3 * kg * staged_stride(sg);
}
size_t s1_smem(int kg, int sg) { return S1_RECORDS + 2 * s1_buffer_bytes(kg, sg); }

// S1: blockdiag selects the block-diagonal tent and its [kg sg] rows.
template <bool BLOCKDIAG>
__global__ void __launch_bounds__(S1_THREADS, S1_PER_SM)
m1_only_kernel(const __nv_bfloat16* __restrict__ planes, const int* __restrict__ jobs,
               const float* __restrict__ uv, float* __restrict__ out, int tiles, int sg, int kg,
               int wu, int rows, int rv) {
  constexpr int BATCH = BLOCKDIAG ? 3 : S1_BATCH;
  extern __shared__ __align__(16) uint8_t smem[];
  uint2* records = reinterpret_cast<uint2*>(smem) + (threadIdx.x >> 5) * 32;   // this warp's
  const int lane = threadIdx.x & 31;
  const int stride = 1 + 2 * kg, njob = 3 * stride, sgp = staged_stride(sg);
  const int nsteps = BLOCKDIAG ? 3 : 3 * kg;    // (plane, group) steps of a row, q outer
  const int nrows = BLOCKDIAG ? kg * sg : sg;
  const int per_batch = 32 / nsteps;            // rows whose steps the warp's lanes make at once
  // this lane's step in such a batch: row rb_l of it, step j_l (plane q_l,
  // and, but in blockdiag, group g_l)
  const int rb_l = lane / nsteps, j_l = lane - rb_l * nsteps;
  const int q_l = BLOCKDIAG ? j_l : j_l / kg, g_l = BLOCKDIAG ? 0 : j_l - q_l * kg;
  const size_t buf = s1_buffer_bytes(kg, sg);
  const float umax = (float)((double)wu - 1.001);
  const uint32_t plane2 = (uint32_t)((size_t)rows * rv * CP / 4);   // in uint2 (4 bf16)
  const uint32_t row2 = (uint32_t)rv * (CP / 4);
  const uint2* texels = reinterpret_cast<const uint2*>(planes);
  const bool vec = (sg & 3) == 0 && (reinterpret_cast<uintptr_t>(uv) & 15) == 0;
  auto stage = [&](int t, int b) {   // tile t's jobs and u rows into buffer b
    int* sj = reinterpret_cast<int*>(smem + S1_RECORDS + b * buf);
    for (int e = threadIdx.x; e < njob; e += S1_THREADS)
      cp_async4(sj + e, jobs + (size_t)t * njob + e);
    const float* u0 = uv + (size_t)t * 6 * kg * sg;   // (plane, group) j's u at u0 + 2 j sg
    stage_runs<S1_THREADS>(reinterpret_cast<float*>(sj + MAX_JOB_INTS), sgp,
                           [&](int j) { return u0 + (size_t)j * 2 * sg; }, 3 * kg, sg, vec);
    cp_async_commit();
  };
  if ((int)blockIdx.x < tiles) stage(blockIdx.x, 0);
  int b = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, b ^= 1) {
    if (t + (int)gridDim.x < tiles) stage(t + gridDim.x, b ^ 1);
    else cp_async_commit();                     // an empty group: the wait below stays right
    cp_async_wait_prior();
    __syncthreads();
    const int* sj = reinterpret_cast<const int*>(smem + S1_RECORDS + b * buf);
    const float* su = reinterpret_cast<const float*>(sj + MAX_JOB_INTS);
    float* out_t = out + (size_t)t * nrows * 128;
    for (int row0 = (threadIdx.x >> 5) * per_batch; row0 < nrows;
         row0 += S1_WARPS * per_batch) {
      // 1. lane rb_l nsteps + j_l makes step j_l of row row0 + rb_l: its two u
      // tents (bf16 values: one word holds both) and the offset of its first
      // texel row's 128 lanes, in uint2
      __syncwarp();
      if (lane < per_batch * nsteps && row0 + rb_l < nrows) {
        const int row = row0 + rb_l;
        const int g0 = BLOCKDIAG ? row / sg : 0, s = row - g0 * sg;
        const int q = q_l, g = BLOCKDIAG ? g0 : g_l;
        const int* job = sj + q * stride;
        const int p = min(max(job[0], 0), 2);
        const int ou = job[1 + 2 * g], ov = job[2 + 2 * g];
        float uc = fminf(fmaxf(su[(q * kg + g) * sgp + s] - (float)ou, 0.f), umax);
        if (BLOCKDIAG) uc = __fadd_rn(uc, (float)(g * wu));
        const float fi = floorf(uc);
        // in-range jobs never reach these clamps; they keep others in the planes
        const int r0 = min(max(ou + (int)fi - (BLOCKDIAG ? g * wu : 0), 0), rows - 2);
        const int c0 = min(max(ov, 0), rv - 128 / CP);
        records[lane] = make_uint2(
            (__float_as_uint(u_tent(fi, uc)) >> 16) | (__float_as_uint(u_tent(fi + 1.f, uc)) &
                                                       0xffff0000u),
            (uint32_t)p * plane2 + (uint32_t)r0 * row2 + (uint32_t)c0 * (CP / 4));
      }
      __syncwarp();
      // 2. each row: every texel load of a batch of its steps, then their
      // sums in step order; each lane owns 4 of the row's 128 lanes
      for (int rb = 0; rb < per_batch && row0 + rb < nrows; ++rb) {
        const uint2* rec = records + rb * nsteps;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j0 = 0; j0 < nsteps; j0 += BATCH) {
          float w0[BATCH], w1[BATCH];
          uint2 v0[BATCH], v1[BATCH];
#pragma unroll
          for (int i = 0; i < BATCH; ++i) {
            if (j0 + i < nsteps) {
              const uint2 e = rec[j0 + i];
              w0[i] = __uint_as_float(e.x << 16);
              w1[i] = __uint_as_float(e.x & 0xffff0000u);
              const uint2* a = texels + e.y + lane;
              v0[i] = __ldg(a);
              v1[i] = __ldg(a + row2);
            }
          }
#pragma unroll
          for (int i = 0; i < BATCH; ++i) {
            if (j0 + i < nsteps) {
              const uint32_t h0[2] = {v0[i].x, v0[i].y}, h1[2] = {v1[i].x, v1[i].y};
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const uint32_t b0 = h0[k >> 1], b1 = h1[k >> 1];
                const float a0 = __uint_as_float((k & 1) ? (b0 & 0xffff0000u) : (b0 << 16));
                const float a1 = __uint_as_float((k & 1) ? (b1 & 0xffff0000u) : (b1 << 16));
                // w0 a0 + w1 a1 with one rounding, as __fadd_rn of the two
                // products: each product of two bf16 values is exact in f32
                acc[k] = __fadd_rn(acc[k], fmaf(w1[i], a1, __fmul_rn(w0[i], a0)));
              }
            }
          }
        }
        __stcs(reinterpret_cast<float4*>(out_t + (size_t)(row0 + rb) * 128) + lane,
               make_float4(acc[0], acc[1], acc[2], acc[3]));
      }
    }
    __syncthreads();                            // buffer b is free for tile t + 2 grids
  }
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
  if ((size_t)3 * rows * rv * CP / 4 > 0xffffffffu)   // texel offsets of 32 bits, in uint2
    return (int)cudaErrorInvalidValue;
  const int sg = rpt * ks;
  const auto* p = static_cast<const __nv_bfloat16*>(planes);
  const auto* j = static_cast<const int*>(jobs);
  const auto* u = static_cast<const float*>(uv);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = s1_smem(kg, sg);
  return (int)(blockdiag ? launch_fetch(m1_only_kernel<true>, S1_THREADS, bytes, S1_PER_SM,
                                        tiles, device, s, p, j, u, o, tiles, sg, kg, wu, rows, rv)
                         : launch_fetch(m1_only_kernel<false>, S1_THREADS, bytes, S1_PER_SM,
                                        tiles, device, s, p, j, u, o, tiles, sg, kg, wu, rows,
                                        rv));
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
