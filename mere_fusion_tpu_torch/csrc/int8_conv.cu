// K5: the int8 convolution of MuseTalk's int8 serving tier (sm_90a), as five
// kernels: the whole of one int8 conv, operands included.
//
// Replaces the XLA int8 conv of mere_fusion_tpu/ops/quant.py:51 (int8_conv:
// SmoothQuant factors from the live amax, conv_general_dilated on int8
// operands with int32 accumulation, dequantised in f32); it is not a Pallas
// site. Each kernel computes one step of ops/quant.py's plain version in its
// order and rounding, so the five together equal int8_conv_plain bit for bit:
//
// - int8_amax_kernel: per input channel, max |x| over (N, H, W) and max |K|
//   over (cout, kh, kw), as partial maxima of a (channel, split) grid. |v| is
//   taken as the bits of a non-negative float, which order as unsigned
//   integers, so the reduction is exact in any order.
// - int8_factors_kernel: one block: the partials reduced, then s = ax^α /
//   ak^(1-α) (powf, IEEE division), sx = max(ax / s) / 127 floored at 1e-12,
//   mult = 1 / (s·sx).
// - int8_pack_kernel: a block an output channel: fl(K·s), its amax, sw =
//   max(amax, 1e-8) / 127, round(fl(K·s) / sw) clipped to ±127 written
//   straight into the conv's [cout, kh·kw, cp] int8 layout through shared
//   memory, and the dequantising sx·sw.
// - int8_quantize_kernel: x·mult rounded half to even and clipped, bf16 or
//   f32 NCHW in, int8 NHWC out (channels zero-padded to cp, a multiple of
//   16): a 64-pixel × 128-channel tile a block, 16-byte loads along the
//   pixels, a byte transpose in registers into XOR-swizzled shared words, and
//   16-byte stores along the channels.
// - int8_conv_kernel: the implicit-GEMM conv on wgmma s8 (m64n256k32, s32
//   accumulators), operands swapped: the weights are wgmma's A (M = 128
//   output channels a tile, two consumer warpgroups of 64), the activation
//   its B (N = 256 output pixels a tile: a bn × bh × bw box of the output,
//   e.g. 8 × 32 rows at 32², 1 × 256 at 256², 16 images of 4² in the UNet's
//   deepest blocks). K runs over taps (r, s) and 128-channel chunks: one
//   thread of a producer warpgroup loads each stage with two TMA boxes, the
//   weights' [128 channels, 1 tap, 128 outputs] and the activation's [128
//   channels, bw, bh, bn] at (ow0·st + s − pad, oh0·st + r − pad), with
//   element strides of the conv's stride; TMA fills what lies outside the
//   tensor with zeros (negative coordinates too), so padding, ragged edges
//   and a cin that is no multiple of 128 cost no code. Both boxes land in
//   128 B swizzled rows, the K-major layout wgmma reads. A ring of 4 stages
//   (48 KB each); one block an SM walks the tiles (persistent), so the
//   producer fills the next tile's stages under this one's epilogue. The
//   producer warpgroup hands its registers to the consumers (setmaxnreg: 40
//   and 232 a thread), whose 128 accumulators and epilogue would spill at
//   168. The epilogue dequantises with two separately rounded f32
//   operations, acc·scale[o] then + bias[o] (no FMA, as the plain version
//   rounds them), stages each warpgroup's rows through a swizzled buffer
//   and writes NCHW with 16-byte stores along the pixels.
//
// Bound on an H100: the conv's int8 operations (2·M·N·K at 1,979 TOPS) for
// every 3×3 conv of the VAE decode; the passes around it move bytes. The
// integer sums are exact (|Σ| < 23,040·127² < 2^31), so their order is free.
// cuTensorMapEncodeTiled is taken through cudaGetDriverEntryPoint, so the
// library does not link libcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// |v| as the bits of a non-negative float: they order as unsigned integers,
// and a NaN (magnitude bits above +inf's) wins every max, as torch's amax
// propagates it.
__device__ __forceinline__ uint32_t abs_bits(float v) { return __float_as_uint(v) & 0x7FFFFFFFu; }

// 8 consecutive values at p (16-byte aligned) as f32; bf16 widens exactly.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// max(v, lo) that keeps a NaN, as torch's clamp_min does
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

// The max of v over the block (blockDim.x a multiple of 32, at most 1024).
__device__ __forceinline__ uint32_t block_max(uint32_t v, uint32_t* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = __reduce_max_sync(0xffffffffu, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x / 32) ? red[lane] : 0u;
    v = __reduce_max_sync(0xffffffffu, v);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();  // red may be reused
  return v;
}

// ---------------------------------------------------------------------------
// (a) per-channel amax of the activation and the weight

constexpr int RED_THREADS = 256;

// x: [n, c, hw]; w: [cout, c, khw]. ax_part / ak_part: [c, splits].
template <typename TX, typename TW>
__global__ void __launch_bounds__(RED_THREADS) int8_amax_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w, float* __restrict__ ax_part,
    float* __restrict__ ak_part, int n, int c, int hw, int cout, int khw, int vec) {
  __shared__ uint32_t red[33];
  const int ch = blockIdx.x, sp = blockIdx.y, splits = gridDim.y;
  const int first = sp * RED_THREADS + threadIdx.x, step = splits * RED_THREADS;
  uint32_t m = 0;
  if (vec) {  // hw % 8 == 0 and x 16-byte aligned: 8 values of one image a load
    const int chunks = n * (hw / 8);
#pragma unroll 4
    for (int j = first; j < chunks; j += step) {
      const int e = 8 * j, img = e / hw, off = e - img * hw;
      float v[8];
      load8(x + ((long long)img * c + ch) * hw + off, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) m = max(m, abs_bits(v[i]));
    }
  } else {
    const int total = n * hw;
    for (int e = first; e < total; e += step) {
      const int img = e / hw, off = e - img * hw;
      m = max(m, abs_bits(to_f32(x[((long long)img * c + ch) * hw + off])));
    }
  }
  uint32_t mk = 0;
  const int wtotal = cout * khw;
  for (int j = first; j < wtotal; j += step) {
    const int o = j / khw, t = j - o * khw;
    mk = max(mk, abs_bits(to_f32(w[((long long)o * c + ch) * khw + t])));
  }
  m = block_max(m, red);
  mk = block_max(mk, red);
  if (threadIdx.x == 0) {
    ax_part[ch * splits + sp] = __uint_as_float(m);
    ak_part[ch * splits + sp] = __uint_as_float(mk);
  }
}

// ---------------------------------------------------------------------------
// (b) the SmoothQuant factors, in the order of ops/quant.py smooth_factors

constexpr int FAC_THREADS = 1024;

__global__ void __launch_bounds__(FAC_THREADS) int8_factors_kernel(
    const float* __restrict__ ax_part, const float* __restrict__ ak_part, int c, int splits,
    float alpha, float beta, float* __restrict__ s_out, float* __restrict__ mult,
    float* __restrict__ sx_out) {
  __shared__ uint32_t red[33];
  uint32_t m = 0;
  for (int ch = threadIdx.x; ch < c; ch += FAC_THREADS) {
    uint32_t bx = 0, bk = 0;
    for (int sp = 0; sp < splits; ++sp) {
      bx = max(bx, __float_as_uint(ax_part[ch * splits + sp]));
      bk = max(bk, __float_as_uint(ak_part[ch * splits + sp]));
    }
    const float ax = __uint_as_float(bx), ak = __uint_as_float(bk);
    float s = 1.0f, t = ax;
    if (ax > 0.0f && ak > 0.0f) {
      s = __fdiv_rn(powf(clamp_min(ax, 1e-8f), alpha), powf(clamp_min(ak, 1e-8f), beta));
      t = __fdiv_rn(ax, s);
    }
    s_out[ch] = s;
    m = max(m, __float_as_uint(t));  // t >= 0
  }
  m = block_max(m, red);  // its barriers also publish s_out within the block
  const float sx = clamp_min(__fdiv_rn(__uint_as_float(m), 127.0f), 1e-12f);
  if (threadIdx.x == 0) *sx_out = sx;
  for (int ch = threadIdx.x; ch < c; ch += FAC_THREADS)
    mult[ch] = __fdiv_rn(1.0f, __fmul_rn(s_out[ch], sx));
}

// ---------------------------------------------------------------------------
// (c) the weights: s·K quantised per output channel into [cout, khw, cp]

constexpr int PACK_THREADS = 256;

template <typename TW>
__global__ void __launch_bounds__(PACK_THREADS) int8_pack_kernel(
    const TW* __restrict__ w, const float* __restrict__ s, const float* __restrict__ sx,
    int8_t* __restrict__ wq, float* __restrict__ scale, int c, int khw, int cp) {
  extern __shared__ __align__(16) int8_t row[];  // [khw][cp]
  __shared__ uint32_t red[33];
  const int o = blockIdx.x, len = c * khw;
  const TW* wo = w + (long long)o * len;
  uint32_t m = 0;
  for (int j = threadIdx.x; j < len; j += PACK_THREADS)
    m = max(m, abs_bits(__fmul_rn(to_f32(wo[j]), s[j / khw])));
  m = block_max(m, red);
  const float sw = __fdiv_rn(clamp_min(__uint_as_float(m), 1e-8f), 127.0f);
  const int padc = cp - c;
  for (int j = threadIdx.x; j < khw * padc; j += PACK_THREADS) {
    const int t = j / padc;
    row[t * cp + c + (j - t * padc)] = 0;
  }
  for (int j = threadIdx.x; j < len; j += PACK_THREADS) {
    const int ch = j / khw, t = j - ch * khw;
    const float q = rintf(__fdiv_rn(__fmul_rn(to_f32(wo[j]), s[ch]), sw));
    row[t * cp + ch] = (int8_t)(int)fminf(fmaxf(q, -127.0f), 127.0f);
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(wq + (long long)o * khw * cp);
  const uint4* src = reinterpret_cast<const uint4*>(row);
  for (int j = threadIdx.x; j < khw * cp / 16; j += PACK_THREADS) dst[j] = src[j];
  if (threadIdx.x == 0) scale[o] = __fmul_rn(*sx, sw);
}

// ---------------------------------------------------------------------------
// (d) the activation: NCHW bf16/f32 → int8 NHWC

constexpr int QT_PIX = 64;       // pixels a tile (8 chunks of 8)
constexpr int QT_CH = 128;       // channels a tile (8 warps of 16)
constexpr int QT_THREADS = 256;

__device__ __forceinline__ uint32_t q8(float v, float mult) {
  float f = __fmul_rn(v, mult);
  f = fminf(fmaxf(f, -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(f);
}

// x: [n, c, hw]; xq: [n, hw, cp]. Thread (warp, lane): channels c0 + 16 warp
// + 4 (lane / 8) .. + 3 (its shared word column cw), pixels p0 + 8 (lane % 8)
// .. + 7; word (pixel p, column cw) sits at column cw ^ 4 (p / 8), so the
// word stores and the 16-byte reads of a row are free of bank conflicts.
template <typename T>
__global__ void __launch_bounds__(QT_THREADS) int8_quantize_kernel(
    const T* __restrict__ x, const float* __restrict__ mult, int8_t* __restrict__ xq, int c,
    int hw, int cp, int vec) {
  __shared__ __align__(16) uint32_t tile[QT_PIX][QT_CH / 4];
  const int p0 = blockIdx.x * QT_PIX, c0 = blockIdx.y * QT_CH, ni = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = lane % 8, cw = 4 * warp + lane / 8, pb = p0 + 8 * k;
  uint32_t word[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) word[i] = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ch = c0 + 4 * cw + j;
    if (ch >= c) continue;  // zero channels up to cp
    const float mu = mult[ch];
    const T* src = x + ((long long)ni * c + ch) * hw + pb;
    float v[8];
    if (vec && pb + 8 <= hw) {
      load8(src, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = pb + i < hw ? to_f32(src[i]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) word[i] |= q8(v[i], mu) << (8 * j);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) tile[8 * k + i][cw ^ (4 * k)] = word[i];
  __syncthreads();
  for (int e = threadIdx.x; e < QT_PIX * QT_CH / 16; e += QT_THREADS) {
    const int p = e / 8, q = e % 8;
    if (p0 + p >= hw || c0 + 16 * q >= cp) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(&tile[p][4 * (q ^ (p / 8))]);
    *reinterpret_cast<uint4*>(xq + ((long long)ni * hw + p0 + p) * cp + c0 + 16 * q) = val;
  }
}

// ---------------------------------------------------------------------------
// (e) the conv: wgmma s8 fed by TMA

constexpr int CV_BM = 128;                 // output channels a tile (two warpgroups of 64)
constexpr int CV_BN = 256;                 // output pixels a tile
constexpr int CV_BK = 128;                 // input channels (bytes) a stage: one swizzled row
constexpr int CV_STAGES = 4;
constexpr int CV_CONSUMERS = 256;
constexpr int CV_THREADS = CV_CONSUMERS + 128;  // and a producer warpgroup (one thread loads)
// Registers a thread after setmaxnreg: the producer warpgroup gives up what
// the consumers take (launched at 168 = 65,536 / 384, rounded down to 8).
constexpr int CV_PRODUCER_REGS = 40;
constexpr int CV_CONSUMER_REGS = 232;
constexpr uint32_t CV_A_BYTES = CV_BM * CV_BK;
constexpr uint32_t CV_B_BYTES = CV_BN * CV_BK;
constexpr uint32_t CV_STAGE_BYTES = CV_A_BYTES + CV_B_BYTES;
constexpr uint32_t CV_OUT_ROW = 256;       // bytes of a staged output row
constexpr uint32_t CV_OUT_BYTES = 64 * CV_OUT_ROW;  // a warpgroup's staging buffer
constexpr uint32_t CV_OUT = CV_STAGES * CV_STAGE_BYTES;
constexpr uint32_t CV_BAR = CV_OUT + 2 * CV_OUT_BYTES;
constexpr size_t CV_SMEM = CV_BAR + 8 * 2 * CV_STAGES + 1024;  // + slack to align the base

struct ConvGeom {
  int n, cp, cout, kh, kw, stride, pad, ho, wo;
  int bw, bh, bn;        // the pixel tile: a bn × bh × bw box of the output
  int tw, th, tn, tm;    // tiles along wo, ho, n and cout
  int chunks;            // 128-channel chunks: ceil(cp / 128)
  int tiles;
  int bias_bf16;
};

struct TileCoord {
  int o0, n0, oh0, ow0;
};

// Output-channel tiles vary fastest, so the blocks in flight share pixel tiles.
__device__ __forceinline__ TileCoord tile_coord(const ConvGeom& g, int tile) {
  const int mt = tile % g.tm;
  int pt = tile / g.tm;
  const int tw = pt % g.tw;
  pt /= g.tw;
  const int th = pt % g.th, tn = pt / g.th;
  return {mt * CV_BM, tn * g.bn, th * g.bh, tw * g.bw};
}

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

// Waits for the completion of the barrier's phase of this parity; traps
// after 2^24 polls instead of hanging the card (the launch then fails with
// an error the wrapper raises).
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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a K-major tile in 128 B swizzled rows (8-row groups
// 1024 bytes apart), as csrc/attention.cu's sw128_desc.
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma window.
__device__ __forceinline__ void fence_regs(int (&r)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define MF_D128                                                                            \
  "{"                                                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "            \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "            \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "             \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "             \
  "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "             \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "             \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "           \
  "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "               \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"                             \
  "}"
#define MF_ACC128                                                                          \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),      \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),           \
      "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),        \
      "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),        \
      "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),        \
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),        \
      "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),        \
      "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),        \
      "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),        \
      "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),        \
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]),        \
      "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]),        \
      "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]),        \
      "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),        \
      "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),        \
      "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]),        \
      "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]),     \
      "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]),  \
      "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),  \
      "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),  \
      "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]),  \
      "+r"(d[127])

// d (+)= A B for a 64 × 256 × 32 step: A (64 output channels × 32 input
// channels) and B (256 pixels × 32 input channels), both K-major in shared
// memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " MF_D128 ", %128, %129, p;\n}\n"
      : MF_ACC128
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Element u of a 16-byte chunk held as four words (u a compile-time index).
template <typename TO>
__device__ __forceinline__ TO element(const uint32_t (&words)[4], int u);
template <>
__device__ __forceinline__ float element<float>(const uint32_t (&words)[4], int u) {
  return __uint_as_float(words[u]);
}
template <>
__device__ __forceinline__ __nv_bfloat16 element<__nv_bfloat16>(const uint32_t (&words)[4], int u) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(words[u / 2] >> (16 * (u % 2))));
}

__device__ __forceinline__ float bias_at(const void* bias, int bf16, int o) {
  if (bias == nullptr) return 0.0f;
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[o])
              : static_cast<const float*>(bias)[o];
}

// Consumer thread t of warpgroup wg holds, in acc, output channel rows
// r = 16 (warp % 4) + lane / 4 (registers i with i & 2 == 0) and r + 8, and
// tile pixel columns 8 (i / 4) + 2 (lane % 4) + (i & 1); column p of the tile
// is pixel (n0 + p / (bw·bh), oh0 + p / bw % bh, ow0 + p % bw).
template <typename TO>
__global__ void __launch_bounds__(CV_THREADS, 1) int8_conv_kernel(
    const __grid_constant__ CUtensorMap tw_map, const __grid_constant__ CUtensorMap tx_map,
    const float* __restrict__ scale, const void* __restrict__ bias, TO* __restrict__ out,
    ConvGeom g) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = base + CV_BAR, empty0 = full0 + 8 * CV_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kiters = g.kh * g.kw * g.chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < CV_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CV_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CV_CONSUMERS / 32) {
    // producer: each stage's weight box and activation box, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(CV_PRODUCER_REGS));
    if (warp == CV_CONSUMERS / 32 && lane == 0) {
      const uint32_t tx = CV_A_BYTES + CV_BK * g.bw * g.bh * g.bn;
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
        const TileCoord tc = tile_coord(g, tile);
        for (int r = 0; r < g.kh; ++r)
          for (int s = 0; s < g.kw; ++s)
            for (int ck = 0; ck < g.chunks; ++ck, ++it) {
              const uint32_t st = it % CV_STAGES, use = it / CV_STAGES;
              if (use > 0) mbar_wait(empty0 + 8 * st, (use - 1) & 1);
              const uint32_t full = full0 + 8 * st, a = base + st * CV_STAGE_BYTES;
              mbar_expect_tx(full, tx);
              tma_load_3d(a, &tw_map, ck * CV_BK, r * g.kw + s, tc.o0, full);
              tma_load_4d(a + CV_A_BYTES, &tx_map, ck * CV_BK, tc.ow0 * g.stride + s - g.pad,
                          tc.oh0 * g.stride + r - g.pad, tc.n0, full);
            }
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CV_CONSUMER_REGS));
  constexpr int E = sizeof(TO);
  constexpr int CPR = CV_OUT_ROW / E;       // tile columns a staging round: 128 bf16, 64 f32
  constexpr int CHUNK = 16 / E;             // columns of a 16-byte chunk
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int row = (warp % 4) * 16 + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);
  uint8_t* const stage_out = gbase + CV_OUT + wg * CV_OUT_BYTES;
  const int bhw = g.bw * g.bh;
  const bool vec = g.bw % CHUNK == 0 && g.wo % CHUNK == 0;
  const uint64_t desc0 = sw128_desc(base);
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    const TileCoord tc = tile_coord(g, tile);
    for (int ki = 0; ki < kiters; ++ki, ++it) {
      const uint32_t st = it % CV_STAGES;
      mbar_wait(full0 + 8 * st, (it / CV_STAGES) & 1);
      const uint64_t da = desc0 + (st * CV_STAGE_BYTES + wg * 64 * CV_BK) / 16;
      const uint64_t db = desc0 + (st * CV_STAGE_BYTES + CV_A_BYTES) / 16;
      fence_regs(acc);
      wgmma_fence();
      // all four k32 steps of the chunk, past cp too (TMA's zeros): a wgmma
      // under a condition is serialised by ptxas
#pragma unroll
      for (int ks = 0; ks < CV_BK / 32; ++ks)
        wgmma_s8(acc, da + 2 * ks, db + 2 * ks, ki > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free it
      fence_regs(acc);
      if (ki > 0) mbar_arrive(empty0 + 8 * ((it - 1) % CV_STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * ((it - 1) % CV_STAGES));

    // epilogue: y = acc·scale[o] + bias[o], each rounded on its own
    const int oa = tc.o0 + 64 * wg + row, ob = oa + 8;
    const float sa = oa < g.cout ? scale[oa] : 0.0f, sb = ob < g.cout ? scale[ob] : 0.0f;
    const float ba = oa < g.cout ? bias_at(bias, g.bias_bf16, oa) : 0.0f;
    const float bb = ob < g.cout ? bias_at(bias, g.bias_bf16, ob) : 0.0f;
#pragma unroll
    for (int rd = 0; rd < CV_BN / CPR; ++rd) {
      // this round's columns into the staging rows: row lr's 16-byte chunk q
      // sits at chunk q ^ (lr % 8)
#pragma unroll
      for (int i = 0; i < 128; i += 2) {
        const int j = i / 4;  // the 8-column block
        if (j / (CPR / 8) != rd) continue;
        const int half = (i >> 1) & 1, lr = row + 8 * half;
        const float sc = half ? sb : sa, bi = half ? bb : ba;
        float y0 = __fmul_rn(__int2float_rn(acc[i]), sc);
        float y1 = __fmul_rn(__int2float_rn(acc[i + 1]), sc);
        if (bias != nullptr) {
          y0 = __fadd_rn(y0, bi);
          y1 = __fadd_rn(y1, bi);
        }
        const int lc = (j % (CPR / 8)) * 8 + col;  // column within the round
        const int q = lc / CHUNK, off = (lc % CHUNK) * E;
        uint8_t* p = stage_out + lr * CV_OUT_ROW + 16 * (q ^ (lr % 8)) + off;
        if constexpr (E == 2) {
          *reinterpret_cast<uint32_t*>(p) = bf16_pair(y0, y1);
        } else {
          *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
        }
      }
      named_barrier(1 + wg, 128);
      // 64 rows × 16 chunks out, each chunk CHUNK consecutive tile columns
      for (int e = tid; e < 64 * 16; e += 128) {
        const int lr = e / 16, q = e % 16;
        const int o = tc.o0 + 64 * wg + lr;
        if (o >= g.cout) continue;
        const int p = rd * CPR + q * CHUNK;
        const uint4 val =
            *reinterpret_cast<const uint4*>(stage_out + lr * CV_OUT_ROW + 16 * (q ^ (lr % 8)));
        if (vec) {  // the chunk lies in one output row: in bounds whole or not at all
          const int ni = tc.n0 + p / bhw, oh = tc.oh0 + p % bhw / g.bw, ow = tc.ow0 + p % g.bw;
          if (ni < g.n && oh < g.ho && ow < g.wo)
            *reinterpret_cast<uint4*>(out + (((long long)ni * g.cout + o) * g.ho + oh) * g.wo +
                                      ow) = val;
        } else {
          const uint32_t words[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
          for (int u = 0; u < CHUNK; ++u) {
            const int pu = p + u;
            const int ni = tc.n0 + pu / bhw, oh = tc.oh0 + pu % bhw / g.bw, ow = tc.ow0 + pu % g.bw;
            if (ni < g.n && oh < g.ho && ow < g.wo)
              out[(((long long)ni * g.cout + o) * g.ho + oh) * g.wo + ow] = element<TO>(words, u);
          }
        }
      }
      named_barrier(1 + wg, 128);
    }
  }
}

// ---------------------------------------------------------------------------
// host side

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

// An int8 tensor in 128 B swizzled boxes; out-of-bounds elements read as zeros.
bool int8_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
              const cuuint32_t* steps) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int pow2ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

template <typename TO>
int launch_conv(const void* xq, const void* wq, const float* scale, const void* bias, void* out,
                int h, int w, ConvGeom g, int device, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tw_map, tx_map;
  const int khw = g.kh * g.kw, st = g.stride;
  {  // weights [cout, khw, cp]: boxes of 128 channels × 1 tap × 128 outputs
    const cuuint64_t dims[3] = {(cuuint64_t)g.cp, (cuuint64_t)khw, (cuuint64_t)g.cout};
    const cuuint64_t strides[2] = {(cuuint64_t)g.cp, (cuuint64_t)khw * g.cp};
    const cuuint32_t box[3] = {CV_BK, 1, CV_BM};
    const cuuint32_t steps[3] = {1, 1, 1};
    if (!int8_map(&tw_map, encode, wq, 3, dims, strides, box, steps))
      return (int)cudaErrorInvalidValue;
  }
  {  // activation [n, h, w, cp]: boxes of 128 channels × bw × bh × bn pixels, the conv's stride
    const cuuint64_t dims[4] = {(cuuint64_t)g.cp, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)g.n};
    const cuuint64_t strides[3] = {(cuuint64_t)g.cp, (cuuint64_t)w * g.cp,
                                   (cuuint64_t)h * w * g.cp};
    const cuuint32_t box[4] = {CV_BK, (cuuint32_t)(g.bw * st), (cuuint32_t)(g.bh * st),
                               (cuuint32_t)g.bn};
    const cuuint32_t steps[4] = {1, (cuuint32_t)st, (cuuint32_t)st, 1};
    if (!int8_map(&tx_map, encode, xq, 4, dims, strides, box, steps))
      return (int)cudaErrorInvalidValue;
  }
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(int8_conv_kernel<TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CV_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  int sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int blocks = g.tiles < sms ? g.tiles : sms;
  int8_conv_kernel<TO><<<blocks, CV_THREADS, CV_SMEM, stream>>>(tw_map, tx_map, scale, bias,
                                                                static_cast<TO*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtypes: 0 float32, 1 bfloat16. x [n, c, hw]; w [cout, c, khw]; ax_part,
// ak_part [c, splits] f32. vec: hw % 8 == 0 and x 16-byte aligned.
int mf_int8_amax(int device, int x_dtype, const void* x, int w_dtype, const void* w,
                 float* ax_part, float* ak_part, int n, int c, int hw, int cout, int khw,
                 int splits, int vec, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(c, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_dtype == 0 && w_dtype == 0)
    int8_amax_kernel<float, float><<<grid, RED_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), ax_part, ak_part, n, c, hw,
        cout, khw, vec);
  else if (x_dtype == 1 && w_dtype == 1)
    int8_amax_kernel<bf, bf><<<grid, RED_THREADS, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(w), ax_part, ak_part, n, c, hw, cout,
        khw, vec);
  else if (x_dtype == 1)
    int8_amax_kernel<bf, float><<<grid, RED_THREADS, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const float*>(w), ax_part, ak_part, n, c, hw,
        cout, khw, vec);
  else
    int8_amax_kernel<float, bf><<<grid, RED_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const bf*>(w), ax_part, ak_part, n, c, hw,
        cout, khw, vec);
  return (int)cudaGetLastError();
}

// s, mult [c]; sx [1].
int mf_int8_factors(int device, const float* ax_part, const float* ak_part, int c, int splits,
                    float alpha, float beta, float* s, float* mult, float* sx, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int8_factors_kernel<<<1, FAC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ax_part, ak_part, c, splits, alpha, beta, s, mult, sx);
  return (int)cudaGetLastError();
}

// w [cout, c, khw] (w_dtype 0 float32, 1 bfloat16) → wq [cout, khw, cp] int8,
// scale [cout] = sx·sw. cp % 16 == 0.
int mf_int8_pack(int device, int w_dtype, const void* w, const float* s, const float* sx,
                 void* wq, float* scale, int cout, int c, int khw, int cp, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int bytes = khw * cp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(wq);
  if (w_dtype == 0) {
    if (bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(int8_pack_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
      if (e != cudaSuccess) return (int)e;
    }
    int8_pack_kernel<float><<<cout, PACK_THREADS, bytes, st>>>(static_cast<const float*>(w), s, sx,
                                                               q, scale, c, khw, cp);
  } else {
    if (bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(int8_pack_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return (int)e;
    }
    int8_pack_kernel<__nv_bfloat16><<<cout, PACK_THREADS, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(w), s, sx, q, scale, c, khw, cp);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16; x [n, c, hw] → xq [n, hw, cp]. cp % 16 == 0;
// vec: hw % 8 == 0 and x 16-byte aligned.
int mf_int8_quantize(int device, int dtype, const void* x, const float* mult, void* xq, int n,
                     int c, int hw, int cp, int vec, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((hw + QT_PIX - 1) / QT_PIX, (cp + QT_CH - 1) / QT_CH, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  if (dtype == 0)
    int8_quantize_kernel<float><<<grid, QT_THREADS, 0, s>>>(static_cast<const float*>(x), mult, q,
                                                            c, hw, cp, vec);
  else
    int8_quantize_kernel<__nv_bfloat16><<<grid, QT_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), mult, q, c, hw, cp, vec);
  return (int)cudaGetLastError();
}

// out_dtype: 0 float32, 1 bfloat16; bias_dtype likewise (bias may be null).
// xq [n, h, w, cp] and wq [cout, kh, kw, cp] int8, 16-byte aligned, cp % 16
// == 0; scale [cout] f32; out [n, cout, ho, wo]. 1 <= stride <= 8.
int mf_int8_conv(int device, int out_dtype, const void* xq, const void* wq, const float* scale,
                 const void* bias, int bias_dtype, void* out, int n, int h, int w, int cp,
                 int cout, int kh, int kw, int stride, int pad, int ho, int wo, void* stream) {
  if (cp % 16 || stride < 1 || stride > 8 || ho <= 0 || wo <= 0 ||
      ((reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(wq)) % 16))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  ConvGeom g{};
  g.n = n; g.cp = cp; g.cout = cout; g.kh = kh; g.kw = kw; g.stride = stride; g.pad = pad;
  g.ho = ho; g.wo = wo;
  // the pixel tile: whole rows where they fit, then whole images; TMA boxes
  // span at most 256 elements a dimension
  const int lim = 256 / stride;
  g.bw = pow2ceil(wo) < lim ? pow2ceil(wo) : lim;
  g.bh = pow2ceil(ho) < CV_BN / g.bw ? pow2ceil(ho) : CV_BN / g.bw;
  if (g.bh > lim) g.bh = lim;
  g.bn = pow2ceil(n) < CV_BN / (g.bw * g.bh) ? pow2ceil(n) : CV_BN / (g.bw * g.bh);
  g.tw = (wo + g.bw - 1) / g.bw;
  g.th = (ho + g.bh - 1) / g.bh;
  g.tn = (n + g.bn - 1) / g.bn;
  g.tm = (cout + CV_BM - 1) / CV_BM;
  g.chunks = (cp + CV_BK - 1) / CV_BK;
  const long long tiles = (long long)g.tw * g.th * g.tn * g.tm;
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  g.tiles = (int)tiles;
  g.bias_bf16 = bias_dtype == 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dtype == 0 ? launch_conv<float>(xq, wq, scale, bias, out, h, w, g, device, s)
                        : launch_conv<__nv_bfloat16>(xq, wq, scale, bias, out, h, w, g, device, s);
}

}  // extern "C"
