// K5: the int8 convolution of MuseTalk's int8 serving tier, as two kernels.
//
// Replaces the XLA int8 conv of mere_fusion_tpu/ops/quant.py:51 (int8_conv:
// conv_general_dilated on int8 operands with int32 accumulation); it is not
// a Pallas site. The small per-channel vectors (the SmoothQuant factors, the
// activation scale, the weights' int8 values and the fused dequantising
// scales) are computed by the wrapper in PyTorch (ops/quant.py); the two big
// passes are here:
//
// - int8_quantize_kernel: the bf16 or f32 NCHW activation times a
//   per-input-channel multiplier, rounded half to even, clipped to ±127,
//   written as int8 NHWC with the channels padded with zeros to a multiple
//   of 16 (cp): the K-contiguous layout of the implicit GEMM.
// - int8_conv_kernel: an implicit-GEMM convolution, M = N·Ho·Wo output
//   pixels by N = cout by K = kh·kw·cp, on the int8 tensor cores
//   (mma.sync m16n8k32 s8·s8 → s32). Each block computes a 128×128 output
//   tile with 8 warps (64×32 each); 128×64-byte tiles of A (gathered from the
//   activation: each 16-byte chunk is one tap's 16 channels, zero-filled
//   outside the image, past K and past M) and of B (the weights, [cout][K])
//   arrive by cp.async in a 3-stage ring. The epilogue dequantises with two
//   separately rounded f32 operations, acc·scale[o] then + bias[o] (no FMA
//   contraction, as the plain version and the JAX package round them),
//   stages the tile channel-major in the freed ring and writes it NCHW, each
//   channel's pixels contiguous: the layout nn.Conv2d gives, so the
//   GroupNorm, SiLU and residual adds after it run as on the float route.
//
// Bound on an H100: the int8 operations (2·M·N·K at 1,979 TOPS) for every
// conv of the VAE decode; the design feeds the tensor cores from shared
// memory with the loads of the next two k-tiles in flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // output pixels a block
constexpr int BN = 128;           // output channels a block
constexpr int BK = 64;            // bytes of K a stage
constexpr int LDS = BK + 16;      // a tile row in shared memory: 80 bytes, conflict-free fragment loads
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int SLD = BM + 4;       // a staged output row (one channel's pixels), f32: conflict-free
constexpr int PIPE_BYTES = STAGES * (BM + BN) * LDS;
constexpr int STAGE_BYTES = BN * SLD * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > STAGE_BYTES ? PIPE_BYTES : STAGE_BYTES;
static_assert(THREADS % BM == 0, "the stores give each thread one pixel of the tile");
constexpr int QPIX = 256;         // pixels a block of the quantize pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int q8(float v, float mult) {
  float f = __fmul_rn(v, mult);
  f = fminf(fmaxf(f, -127.0f), 127.0f);
  return __float2int_rn(f);
}

// x: [n, c, hw]; xq: [n, hw, cp] int8.
template <typename T>
__global__ void __launch_bounds__(QPIX) int8_quantize_kernel(
    const T* __restrict__ x, const float* __restrict__ mult, int8_t* __restrict__ xq,
    int n, int c, int hw, int cp) {
  const long long p = (long long)blockIdx.x * QPIX + threadIdx.x;
  if (p >= (long long)n * hw) return;
  const int c0 = blockIdx.y * 16;
  const long long ni = p / hw, q = p - ni * hw;
  uint32_t packed[4];
#pragma unroll
  for (int j = 0; j < 16; j += 4) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int ch = c0 + j + b;
      int v = 0;
      if (ch < c) v = q8(to_f32(x[(ni * c + ch) * hw + q]), mult[ch]);
      word |= (uint32_t)(uint8_t)(int8_t)v << (8 * b);
    }
    packed[j / 4] = word;
  }
  *reinterpret_cast<uint4*>(xq + p * cp + c0) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Geom {
  int n, h, w, cp, cout, kw, stride, pad, ho, wo, m, k;
};

__device__ __forceinline__ void store1(float* out, float a) { *out = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float a) { *out = __float2bfloat16_rn(a); }

// xq: [n, h, w, cp] int8; wq: [cout, K] int8 (K = kh·kw·cp, tap-major);
// scale, bias: [cout] f32 (bias may be null); out: [n, cout, ho, wo] (NCHW).
template <typename TO>
__global__ void __launch_bounds__(THREADS, 2) int8_conv_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
    const float* __restrict__ scale, const float* __restrict__ bias, TO* __restrict__ out,
    Geom g) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;                          // [STAGES][BM][LDS]
  int8_t* Bs = smem + STAGES * BM * LDS;      // [STAGES][BN][LDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kc = (tid & 3) * 16;              // this thread's 16-byte chunk of a stage row

  // the two rows of A and of B this thread loads each stage
  int a_img[2], a_ih[2], a_iw[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + 64 * i;
    a_ok[i] = m < g.m;
    const int mm = a_ok[i] ? m : 0;
    const int img = mm / (g.ho * g.wo), rest = mm - img * g.ho * g.wo;
    const int oh = rest / g.wo, ow = rest - oh * g.wo;
    a_img[i] = img;
    a_ih[i] = oh * g.stride - g.pad;
    a_iw[i] = ow * g.stride - g.pad;
  }

  const int ktiles = (g.k + BK - 1) / BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK + kc;
    const bool k_ok = k0 < g.k;
    const int tap = k_ok ? k0 / g.cp : 0;
    const int ch = k0 - tap * g.cp;
    const int r = tap / g.kw, s = tap - r * g.kw;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + 64 * i;
      const int ih = a_ih[i] + r, iw = a_iw[i] + s;
      const bool ok = k_ok && a_ok[i] && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
      const int8_t* src =
          ok ? xq + (((long long)a_img[i] * g.h + ih) * g.w + iw) * g.cp + ch : xq;
      cp_async16(As + (stage * BM + row) * LDS + kc, src, ok);
      const int o = n0 + row;
      const bool okb = k_ok && o < g.cout;
      const int8_t* srcb = okb ? wq + (long long)o * g.k + k0 : wq;
      cp_async16(Bs + (stage * BN + row) * LDS + kc, srcb, okb);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ktiles) load_stage(st, st);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the stage every warp finished with at kt - 1
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_stage(next % STAGES, next);
    cp_async_commit();

    const int8_t* at = As + (kt % STAGES) * BM * LDS + (warp_m * 64) * LDS;
    const int8_t* bt = Bs + (kt % STAGES) * BN * LDS + (warp_n * 32) * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = at + (mi * 16 + gq) * LDS + kk + 4 * tq;
        af[mi][0] = lds32(p);
        af[mi][1] = lds32(p + 8 * LDS);
        af[mi][2] = lds32(p + 16);
        af[mi][3] = lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = bt + (ni * 8 + gq) * LDS + kk + 4 * tq;
        bf[ni][0] = lds32(p);
        bf[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the tile goes through it, channel-major

  // epilogue: y = acc·scale[o] + bias[o], each rounded on its own, staged as
  // f32 [BN][SLD] so that the stores below write each channel's pixels
  // contiguously (NCHW, the layout of nn.Conv2d's output)
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int ol = warp_n * 32 + ni * 8 + 2 * tq, o = n0 + ol;
    if (o >= g.cout) continue;
    const bool pair = o + 1 < g.cout;
    const float s0 = scale[o], s1 = pair ? scale[o + 1] : 0.0f;
    const float b0 = bias ? bias[o] : 0.0f, b1 = (bias && pair) ? bias[o + 1] : 0.0f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ml = warp_m * 64 + mi * 16 + gq + 8 * half;
        float y0 = __fmul_rn(__int2float_rn(acc[mi][ni][2 * half]), s0);
        float y1 = __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + 1]), s1);
        if (bias) {
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
        }
        stage[ol * SLD + ml] = y0;
        if (pair) stage[(ol + 1) * SLD + ml] = y1;
      }
    }
  }
  __syncthreads();
  // each thread keeps one pixel of the tile (THREADS = 2·BM) and walks the channels
  const int ml = tid % BM, m = m0 + ml;
  if (m >= g.m) return;
  const int hw = g.ho * g.wo, img = m / hw, p = m - img * hw;
  TO* dst = out + (long long)img * g.cout * hw + p;
  for (int ol = tid / BM; ol < BN; ol += THREADS / BM) {
    const int o = n0 + ol;
    if (o >= g.cout) break;
    store1(dst + (long long)o * hw, stage[ol * SLD + ml]);
  }
}

template <typename TO>
int launch_conv(const int8_t* xq, const int8_t* wq, const float* scale, const float* bias,
                void* out, Geom g, cudaStream_t stream) {
  static bool configured = false;   // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(int8_conv_kernel<TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((g.cout + BN - 1) / BN, (g.m + BM - 1) / BM);
  int8_conv_kernel<TO><<<grid, THREADS, SMEM_BYTES, stream>>>(xq, wq, scale, bias,
                                                               static_cast<TO*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16; x NCHW. cp % 16 == 0.
int mf_int8_quantize(int device, int dtype, const void* x, const float* mult,
                     void* xq, int n, int c, int hw, int cp, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long pixels = (long long)n * hw;
  dim3 grid((unsigned)((pixels + QPIX - 1) / QPIX), cp / 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    int8_quantize_kernel<float><<<grid, QPIX, 0, s>>>(static_cast<const float*>(x), mult,
                                                      static_cast<int8_t*>(xq), n, c, hw, cp);
  else
    int8_quantize_kernel<__nv_bfloat16><<<grid, QPIX, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), mult, static_cast<int8_t*>(xq), n, c, hw, cp);
  return (int)cudaGetLastError();
}

// out_dtype: 0 float32, 1 bfloat16. xq [n, h, w, cp]; wq [cout, kh, kw, cp];
// out [n, cout, ho, wo]. bias may be null.
int mf_int8_conv(int device, int out_dtype, const void* xq, const void* wq, const float* scale,
                 const float* bias, void* out, int n, int h, int w, int cp, int cout, int kh,
                 int kw, int stride, int pad, int ho, int wo, void* stream) {
  (void)kh;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Geom g{n, h, w, cp, cout, kw, stride, pad, ho, wo, n * ho * wo, kh * kw * cp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  return out_dtype == 0 ? launch_conv<float>(a, b, scale, bias, out, g, s)
                        : launch_conv<__nv_bfloat16>(a, b, scale, bias, out, g, s);
}

}  // extern "C"
