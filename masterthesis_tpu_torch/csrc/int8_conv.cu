// int8 serving convolutions: the stride-1 3x3 conv, the stride-2 down conv,
// the two stride-1 convs of the residual block, and the sub-pixel transposed
// conv. Four TPU kernels come from this one source.
//
// Replaces masterthesis_tpu/ops/pallas/conv_int8.py:
//   pallas_int8_conv3x3  (:187)   -> quant_pad (optional prologue, reflect or
//                                    zero pad) + conv (3x3, stride 1) [+ stats]
//   pallas_int8_downconv (:1303)  -> quant_pad + conv (3x3, stride 2) [+ stats]
//   pallas_int8_resblock (:989)   -> quant_pad, conv (h1 stored NHWC), stats
//                                    (forms conv2's prologue affine),
//                                    quant_pad of NHWC h1, conv (h2 NHWC),
//                                    stats, residual (NCHW out through
//                                    shared-memory tiles)     (7 launches)
//   pallas_int8_deconv   (:577)   -> quant_pad (zero pad at the end) + conv
//                                    (2x2 taps to 4 phases, interleaving
//                                    store) [+ stats]
// Channels are zero-padded to a multiple of 32 (K_ALIGN, one k32 step) in the
// operands, and any number of output rows is guarded, so unaligned widths
// (BaseModel's 268/276/146-channel convs) run as they are. The wrappers are
// masterthesis_tpu_torch/ops/kernels/int8_conv.py, whose plain versions do the
// same arithmetic with torch ops.
//
// The convs are wgmma m64nNk32 s8 -> s32 implicit GEMMs fed by TMA, for
// sm_90a, with no im2col in device memory: blocks of two consumer
// warpgroups and one producer warp that keeps TMA loads of k-slabs (128
// channels, the 128-byte swizzle's width; conv_box_kernel takes 64 with the
// 64-byte swizzle for inputs of at most 64 channels) in flight through an
// mbarrier ring. The weights come as (R, taps, Cp) 3-D boxes, so a tail slab (Cp %
// 128) reads zeros past Cp in both operands, and a tail N tile is a launch
// of its own at the narrowest wgmma width (N = 128/64/32) that covers it,
// with a weight box of as many rows. After the main loop the s32 tile is
// staged in shared memory, [column][row], from which the per-tile int64
// partials are added one column per thread, without shuffles. The pipeline
// (ring_init, produce, consume, stage_acc) is shared by two kernels, which
// differ in their A boxes and their epilogues:
// - conv_s1_wgmma_kernel, stride 1 (kernels 4, 6): M = output pixels over
//   the padded grid's width (m = oy * Wp + ox), so for tap (ky, kx) an M
//   tile's A rows are one contiguous run of the (B * Hp * Wp, Cp) int8 view
//   from m0 + ky * Wp + kx: a plain 2-D box; the rows m >= Ho * Wp and the 2
//   columns ox >= Wo are dropped in the epilogue. N tiles of 256, one block
//   per SM; NCHW y is stored from the staged tile coalesced along the
//   pixels, NHWC y (kernel 6's h1 and h2) along the channels. At (8, 256,
//   64, 64) it is bound by operations: 38.7 G int8 operations (0.0195 ms at
//   1,979 TOP/s) against 43 MB (0.0128 ms).
// - conv_box_kernel, stride 2 (kernel 7) and the transposed conv's 2x2 taps
//   to four phase rows (kernel 5): M tiles are boxes of output rows x
//   columns, each tap's A rows one 5-D TMA box (see the kernel). They are
//   bound by bytes (their int8 input and f32 output, 25-151 MB, against 9.66
//   G MACs), so their epilogue is kept off the main loop's way: N tiles of
//   128 and a small ring for two blocks per SM, and y handed to TMA stores.
// The f32 <-> int8 conversions are separate passes through device memory,
// bound by bytes; the resblock (kernel 6) as a whole moves about 271 MB over
// its 7 launches against 77.3 G int8 operations.
//
// Activations are f32 or bf16 (the model's compute dtype), a compile-time
// type of every kernel that reads or writes them (TIn, TOut, T), never a
// branch at run time: the quantize-and-pad launches read either and apply
// the prologue in f32, the convs compute y = acc * scale + bias in f32 and
// round it once to the output type (the transposed and stride-2 convs
// before they stage it for TMA stores: rows of 32 output columns, 128 bytes
// of f32 with the 128-byte swizzle or 64 bytes of bf16 with the 64-byte
// one), and the residual adds x + round(h * a + b) in f32 and rounds the
// sum, as the JAX package's composed block does in bf16 (x +
// y.astype(x.dtype)). The statistics come from the integer accumulators, so
// they are the same in either type.
//
// Numerics. The prologue and the quantize are written with __fmul_rn /
// __fadd_rn (no FMA contraction) and rounded with rintf (half to even), so
// that fed the same input and affine the int8 operands equal torch's
// round(x * a + b ...) exactly; int32 sums are exact in any order, and the
// dequantize acc * scale + bias is two rounded operations, so y is equal too.
// Statistics are exact too. Per output row the conv sums the int32
// accumulators and their squares in int64 (per-tile partials, no atomics);
// the stats launch adds the partials (the squares as 32-bit halves, so no
// shape overflows), rounds each total once to f64, and forms
// sum(y) = s * A1 + n * bias and sum(y^2) = s^2 * A2 + 2 s bias * A1 +
// n * bias^2 in f64 with each step rounded, then rounds to f32. These are the
// moments of acc * s + bias before y's own f32 rounding, which moves them by
// far less than an f32 ulp of the sums. Any summation order gives the same
// integers, so the plain version, which repeats the f64 steps with torch ops,
// gets the same bits: an int8 chain quantizing with these statistics does not
// flip a value between kernel and plain version, and a run repeats exactly.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace mt::sm90;

// ---------------------------------------------------------------------------
// quantize and pad: NCHW f32 -> padded NHWC int8, channels zero-padded to Cp.
// A block writes up to kQSeg padded pixels of one padded row for kQC = 128
// channels, or 64 for a 64-channel input (scripts/int8_conv_knobs.py times
// the choices). A thread reads 4 columns of 4 channel rows (16-byte loads
// along x), and quantizes and transposes them into 4 words of 4 channels
// each, which go to a [pixel][channel] tile; then kQC / 16 threads write a
// pixel's kQC bytes. Pads of
// at most one (every conv here), so that a reflected column lies within 2 of
// the block's own source columns; rows and columns past a pad are zeros
// (the stride-2 conv's input rounded to an even size).
// ---------------------------------------------------------------------------
constexpr int kQSeg = 256;              // padded pixels per block
constexpr int kQSpan = kQSeg + 8;       // source columns a block may read, from a multiple of 4

__device__ __forceinline__ int reflect_index(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// the prologue affine and relu/lrelu, then clip(round(v * inv), +-127)
__device__ __forceinline__ uint32_t quantize(float v, float inv, bool affine, float sa, float sb,
                                             int relu, float alpha) {
  if (affine) {
    v = __fadd_rn(__fmul_rn(v, sa), sb);
    if (relu) v = fmaxf(v, __fmul_rn(alpha, v));
  }
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

// 4 consecutive values from 4-aligned src as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void load4(const float* src, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(src);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  mt::Vec<__nv_bfloat16>::lo_hi(u.x, v[0], v[1]);
  mt::Vec<__nv_bfloat16>::lo_hi(u.y, v[2], v[3]);
}

// kQC channels per block: 128, or 64 where Cp is at most 64 (fewer leave
// threads idle); TIn f32 or bf16
template <int kQC, typename TIn>
__global__ void __launch_bounds__(256)
    quant_pad_kernel(const TIn* __restrict__ x, int8_t* __restrict__ out,
                     const float* __restrict__ inv_sx, const float* __restrict__ pa,
                     const float* __restrict__ pb, int relu, float alpha, int C, int H, int W,
                     int Cp, int Hp, int Wp, int pt, int pl, int reflect) {
  constexpr int kQPitch = kQC / 4 + 1;  // tile words per pixel
  __shared__ uint32_t tile[kQSpan * kQPitch];
  const int b = blockIdx.x / Hp, yp = blockIdx.x % Hp;
  const int x0 = blockIdx.y * kQSeg, c0 = blockIdx.z * kQC;
  int y = yp - pt;
  bool row_ok = true;
  if (y < 0 || y >= H) {  // a pad row, or past it a zero row
    if (reflect && y >= -1 && y <= H) y = reflect_index(y, H); else row_ok = false;
  }
  const int lo = max(0, x0 - pl - 2) & ~3, hi = min(W, x0 - pl + kQSeg + 2);
  if (row_ok && hi > lo) {
    const float inv = *inv_sx;
    const int groups = (hi - lo + 3) / 4;  // 4-column groups, along x first
    for (int i = threadIdx.x; i < groups * (kQC / 4); i += 256) {
      const int cq = i / groups, xs = lo + 4 * (i % groups);
      uint32_t word[4] = {0u, 0u, 0u, 0u};  // word[e]: 4 channels at column xs + e
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + 4 * cq + k;
        if (c >= C) continue;
        const int64_t bc = static_cast<int64_t>(b) * C + c;
        const TIn* src = x + (bc * H + y) * W + xs;
        float v[4];
        if (W % 4 == 0) {
          load4(src, v);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = xs + e < hi ? mt::to_float(src[e]) : 0.f;
        }
        const float sa = pa != nullptr ? pa[bc] : 1.f, sb = pa != nullptr ? pb[bc] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          word[e] |= quantize(v[e], inv, pa != nullptr, sa, sb, relu, alpha) << (8 * k);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (xs + e < hi) tile[(xs + e - lo) * kQPitch + cq] = word[e];
    }
  }
  __syncthreads();
  constexpr int kParts = kQC / 16;  // threads per padded pixel, 16 channels each
  const int n = kParts * min(kQSeg, Wp - x0);
  for (int i = threadIdx.x; i < n; i += 256) {
    const int xp = x0 + i / kParts, part = i % kParts;
    if (c0 + 16 * part >= Cp) continue;
    int xs = xp - pl;
    bool ok = row_ok;
    if (xs < 0 || xs >= W) {
      if (reflect && xs >= -1 && xs <= W) xs = reflect_index(xs, W); else ok = false;
    }
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ok) {
      const uint32_t* t = tile + (xs - lo) * kQPitch + 4 * part;
      v = make_uint4(t[0], t[1], t[2], t[3]);
    }
    *reinterpret_cast<uint4*>(
        out + ((static_cast<int64_t>(b) * Hp + yp) * Wp + xp) * Cp + c0 + 16 * part) = v;
  }
}

// NHWC (B, H, W, C) f32 or bf16 -> padded NHWC int8, the same arithmetic
// (kernel 6's second quantize, of h1 as conv1 stores it): one thread per 16
// channels of a padded pixel, reading 64 (f32) or 32 (bf16) bytes along the
// channels (and the affine's 128) and writing 16. Block (padded row b x Hp +
// yp, 256 of the row's Wp x Cp / 16 threads).
constexpr int kQV = 16;

template <typename TIn>
__global__ void __launch_bounds__(256)
    quant_pad_nhwc_kernel(const TIn* __restrict__ h, int8_t* __restrict__ out,
                          const float* __restrict__ inv_sx, const float* __restrict__ pa,
                          const float* __restrict__ pb, int relu, float alpha, int C, int H,
                          int W, int Cp, int Hp, int Wp, int pt, int pl, int reflect) {
  const int groups = Cp / kQV;
  const int j = blockIdx.y * 256 + threadIdx.x;
  if (j >= Wp * groups) return;
  const int xp = j / groups, c0 = (j - xp * groups) * kQV;
  const int b = blockIdx.x / Hp, yp = blockIdx.x - b * Hp;
  int y = yp - pt, x = xp - pl;
  bool ok = true;
  if (y < 0 || y >= H) {
    if (reflect) y = reflect_index(y, H); else ok = false;
  }
  if (x < 0 || x >= W) {
    if (reflect) x = reflect_index(x, W); else ok = false;
  }
  uint32_t word[4] = {0u, 0u, 0u, 0u};
  if (ok && c0 < C) {
    const float inv = *inv_sx;
    const TIn* src = h + ((static_cast<int64_t>(b) * H + y) * W + x) * C + c0;
    const int64_t bc = static_cast<int64_t>(b) * C + c0;
    const bool affine = pa != nullptr;
    float v[kQV], sa[kQV], sb[kQV];
    if (C % 4 == 0 && c0 + kQV <= C) {
#pragma unroll
      for (int e = 0; e < kQV; e += 4) {
        float f[4];
        load4(src + e, f);
        v[e] = f[0];
        v[e + 1] = f[1];
        v[e + 2] = f[2];
        v[e + 3] = f[3];
        if (affine) {
          const float4 fa = *reinterpret_cast<const float4*>(pa + bc + e);
          const float4 fb = *reinterpret_cast<const float4*>(pb + bc + e);
          sa[e] = fa.x;
          sa[e + 1] = fa.y;
          sa[e + 2] = fa.z;
          sa[e + 3] = fa.w;
          sb[e] = fb.x;
          sb[e + 1] = fb.y;
          sb[e + 2] = fb.z;
          sb[e + 3] = fb.w;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < kQV; ++e) {
        const bool in = c0 + e < C;
        v[e] = in ? mt::to_float(src[e]) : 0.f;
        sa[e] = in && affine ? pa[bc + e] : 1.f;
        sb[e] = in && affine ? pb[bc + e] : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < kQV; ++e)
      if (c0 + e < C)
        word[e / 4] |= quantize(v[e], inv, affine, sa[e], sb[e], relu, alpha) << (8 * (e % 4));
  }
  *reinterpret_cast<uint4*>(out + ((static_cast<int64_t>(b) * Hp + yp) * Wp + xp) * Cp + c0) =
      make_uint4(word[0], word[1], word[2], word[3]);
}

// ---------------------------------------------------------------------------
// the stride-1 conv (wgmma, see the note at the top): a block of two consumer
// warpgroups (threads 0-255, rows 0-63 and 64-127 of the 128-row tile) and
// one producer warp (threads 256-287). Shared memory: kWStages slabs of A (128
// rows x 128 channels, 16 KB) and B (256 rows x 128 channels, 32 KB) as
// 128-byte-swizzled TMA boxes, then the full/empty mbarriers; after the main
// loop the ring holds the s32 tile, [column][row].
// ---------------------------------------------------------------------------
constexpr int kWThreads = 288;
constexpr int kWM = 128, kWN = 256, kWK = 128;
constexpr int kWStages = 4;
constexpr int kWABytes = kWM * kWK, kWBBytes = kWN * kWK;
constexpr int kWSmem = kWStages * (kWABytes + kWBBytes) + 2 * kWStages * 8 + 1024;
constexpr int kStage = kWM + 5;  // s32 per staged column: an odd pitch (see the epilogue)
static_assert((kWN * kStage + kWM) * 4 <= kWStages * (kWABytes + kWBBytes),
              "the staged tile and its row table fit the ring");

// D (64 x N s32, in registers: the first N / 2 of d) += A (64 x 32) * B (32 x
// N), s8 operands K-major in shared memory through their descriptors
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// The template's pipeline, shared by both conv kernels. A block's ring holds
// kStages slabs of A (kA bytes apart: 128 rows of kSlab channels) and of B
// (kB bytes apart: the N tile's kNW rows of kSlab channels), TMA boxes with
// the kSlab-byte swizzle, and a full and an empty mbarrier per stage.
template <int kStages>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, plus the bytes
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// the producer: ksteps k-slabs through the ring, each of `bytes` bytes that
// load(a slab, b slab, k, full barrier) requests by TMA
template <int kStages, int kA, int kB, typename Load>
__device__ __forceinline__ void produce(uint8_t* ring_a, uint8_t* ring_b, uint64_t* full,
                                        uint64_t* empty, int ksteps, uint32_t bytes, Load load) {
  int stage = 0;
  uint32_t phase = 0;
  for (int k = 0; k < ksteps; ++k) {
    mbar_wait(&empty[stage], phase ^ 1);
    mbar_expect_tx(&full[stage], bytes);
    load(ring_a + stage * kA, ring_b + stage * kB, k, &full[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// a consumer warpgroup (wg 0 or 1): acc = its 64 rows of A times the tile's
// kNW rows of B over ksteps slabs, both K-major; a k32 step is 32 bytes
// along the swizzled rows. A tail slab's channels past Cp are zeros in both
// (TMA's fill), so its last steps add nothing
template <int kNW, int kSlab, int kStages, int kA, int kB>
__device__ __forceinline__ void consume(int (&acc)[kNW / 2], const uint8_t* ring_a,
                                        const uint8_t* ring_b, uint64_t* full, uint64_t* empty,
                                        int ksteps, int wg) {
#pragma unroll
  for (int i = 0; i < kNW / 2; ++i) acc[i] = 0;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int k = 0; k < ksteps; ++k) {
    mbar_wait(&full[stage], phase);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSlab / 32; ++kk) {
      const uint8_t* a = ring_a + stage * kA + wg * 64 * kSlab + kk * 32;
      const uint8_t* w = ring_b + stage * kB + kk * 32;
      if (kSlab == 128)
        wgmma_s8<kNW>(acc, smem_desc(a, 16, 1024), smem_desc(w, 16, 1024));
      else
        wgmma_s8<kNW>(acc, smem_desc_64b(a), smem_desc_64b(w));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous slab's products are done: release it
    fence_acc(acc);
    if (k > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// the s32 tile staged [column][row] at the odd pitch kStage, so that reading
// a column along its rows, a row along its columns or one column per thread
// hits 32 banks: accumulator 4j + 2h + e is row 16 warp + lane / 4 + 8 h of
// this warpgroup's 64, column 8 j + 2 (lane % 4) + e
template <int kNW>
__device__ __forceinline__ void stage_acc(int* st, const int (&acc)[kNW / 2], int wg) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kNW / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        st[(8 * j + 2 * (lane % 4) + e) * kStage + wg * 64 + warp * 16 + lane / 4 + 8 * h] =
            acc[4 * j + 2 * h + e];
}

struct WConvArgs {
  const float* scale;
  const float* bias;
  void* y;  // TOut
  long long* psum;
  long long* psq;
  int Hp, Wp, Cp, R, tiles, nhwc, ntile0;
};

// out[b, n, oy, ox] (or [b, oy, ox, n]) = dequant(sum_{ky, kx, c} in[b, oy +
// ky, ox + kx, c] * w[n, 3 ky + kx, c]) over the padded NHWC int8 input (B,
// Hp, Wp, Cp). Block (blockIdx.x = image x tiles + tile, blockIdx.y + ntile0 =
// N tile) computes rows m0 .. m0 + 127 of m = oy * Wp + ox and columns n0 ..
// n0 + kNW - 1. kNW is 256 but for the last N tile of an R that is not a
// multiple of 256 (a launch of its own): a compile-time width keeps every
// wgmma out of divergent code, which ptxas would otherwise serialize. map_w's
// box holds kNW weight rows, so a narrow tail tile loads only its own rows.
// TOut is y's type, f32 or bf16.
template <int kNW, typename TOut>
__global__ void __launch_bounds__(kWThreads, 1)
    conv_s1_wgmma_kernel(const __grid_constant__ CUtensorMap map_in,
                         const __grid_constant__ CUtensorMap map_w, WConvArgs p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  uint8_t* ring_a = smem_raw + (((base + 1023) & ~1023u) - base);
  uint8_t* ring_b = ring_a + kWStages * kWABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_b + kWStages * kWBBytes);
  uint64_t* empty = full + kWStages;
  ring_init<kWStages>(full, empty);
  __syncthreads();

  const int b = blockIdx.x / p.tiles, tile = blockIdx.x % p.tiles;
  const int m0 = tile * kWM, n0 = (blockIdx.y + p.ntile0) * kWN;
  const int cslabs = (p.Cp + kWK - 1) / kWK, ksteps = 9 * cslabs;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // the producer warp
    if (threadIdx.x == 256) {
      const int row0 = b * p.Hp * p.Wp + m0, wp = p.Wp;
      const CUtensorMap *in = &map_in, *wt = &map_w;
      produce<kWStages, kWABytes, kWBBytes>(
          ring_a, ring_b, full, empty, ksteps, kWABytes + kNW * kWK,
          [=](uint8_t* a, uint8_t* w, int k, uint64_t* bar) {
            const int tap = k / cslabs, c0 = (k % cslabs) * kWK;
            tma_load_2d(a, in, bar, c0, row0 + (tap / 3) * wp + tap % 3);
            tma_load_3d(w, wt, bar, c0, tap, n0);
          });
    }
    return;
  }

  int acc[kNW / 2];
  consume<kNW, kWK, kWStages, kWABytes, kWBBytes>(acc, ring_a, ring_b, full, empty, ksteps, wg);

  // the epilogue, over the ring once both warpgroups are done with it: the
  // staged s32 tile, read along a column's rows (NCHW stores), a row's
  // columns (NHWC stores) or one column per thread (the statistics); and
  // each row's output pixel oy * Wo + ox, or -1 for a dropped row
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  int* st = reinterpret_cast<int*>(ring_a);
  int* pix = st + kWN * kStage;
  const int lane = threadIdx.x % 32;
  stage_acc<kNW>(st, acc, wg);
  const int Ho = p.Hp - 2, Wo = p.Wp - 2;
  if (threadIdx.x < kWM) {
    const int m = m0 + threadIdx.x;
    const int oy = m / p.Wp, ox = m - oy * p.Wp;
    pix[threadIdx.x] = oy < Ho && ox < Wo ? oy * Wo + ox : -1;
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");

  const int ncols = min(kNW, p.R - n0);
  const int64_t hw = static_cast<int64_t>(Ho) * Wo;
  if (p.psum != nullptr && threadIdx.x < ncols) {  // a column per thread
    const int* col = st + threadIdx.x * kStage;
    long long s = 0, q = 0;
    for (int r = 0; r < kWM; ++r) {
      if (pix[r] < 0) continue;
      const int a = col[r];
      s += a;
      q += static_cast<long long>(a) * a;
    }
    const int64_t o = (static_cast<int64_t>(b) * p.tiles + tile) * p.R + n0 + threadIdx.x;
    p.psum[o] = s;
    p.psq[o] = q;
  }
  const int gw = threadIdx.x / 32;  // 8 warps
  if (p.nhwc) {  // a warp per row, its lanes along the columns
    constexpr int kPer = (kNW + 31) / 32;
    float sc[kPer], bi[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int n = n0 + lane + 32 * i;
      sc[i] = n < p.R ? p.scale[n] : 0.f;
      bi[i] = n < p.R && p.bias != nullptr ? p.bias[n] : 0.f;
    }
    for (int r = gw; r < kWM; r += 8) {
      const int px = pix[r];
      if (px < 0) continue;
      TOut* orow = static_cast<TOut*>(p.y) + (static_cast<int64_t>(b) * hw + px) * p.R + n0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = lane + 32 * i;
        if (c < ncols) {
          float v = __fmul_rn(__int2float_rn(st[c * kStage + r]), sc[i]);
          if (p.bias != nullptr) v = __fadd_rn(v, bi[i]);
          orow[c] = mt::from_float<TOut>(v);
        }
      }
    }
  } else {  // a warp per column, its lanes along the rows
    for (int c = gw; c < ncols; c += 8) {
      const int n = n0 + c;
      const float sc = p.scale[n];
      const float bi = p.bias != nullptr ? p.bias[n] : 0.f;
      TOut* ycol = static_cast<TOut*>(p.y) + (static_cast<int64_t>(b) * p.R + n) * hw;
#pragma unroll
      for (int r = lane; r < kWM; r += 32) {
        const int px = pix[r];
        if (px < 0) continue;
        float v = __fmul_rn(__int2float_rn(st[c * kStage + r]), sc);
        if (p.bias != nullptr) v = __fadd_rn(v, bi);
        ycol[px] = mt::from_float<TOut>(v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the stride-2 and transposed convs (kernels 7 and 5): the template's block
// and main loop over M tiles that are boxes of by output rows x bx output
// columns (box_tile: bx = 32, 64 or 128, the least that holds Wo, or 128;
// by = min(128 / bx, Ho)), whose A rows are one TMA box per tap: for stride 2 of the padded
// input viewed as (Cp, 2, Wp / 2, 2, B Hp / 2), row and column parities
// apart (box (128, 1, bx, 1, by) at (c0, kx & 1, ox0 + kx / 2, ky & 1, b Hp
// / 2 + oy0 + ky / 2)); for the transposed conv's 2x2 taps of the input
// padded at the end viewed as (Cp, Wp, B Hp) (box (128, bx, by) at (c0, ox0
// + kx, b Hp + oy0 + ky)). Bound by bytes, with y the most of them (f32 or
// bf16), so the epilogue is kept short and off the main loop's way: N tiles
// of 128 and a 3-deep ring leave room for two blocks per SM, so that one's
// epilogue runs beside the other's main loop, and y goes out by TMA stores.
// The block stages its s32 tile [column][row] (as the stride-1 conv does),
// adds each column's pixels inside Ho and Wo into its int64 partials, then
// writes y, dequantized from the accumulators and rounded to TOut, over it
// in the stores' own layout (rows of 32 output columns: 128 bytes of f32
// with the 128-byte swizzle, 64 of bf16 with the 64-byte one, as
// swizzled() lays them); one thread issues a box store per 32 columns and
// waits only until the stores have read shared memory, and the writes to
// device memory go on while the SM runs other blocks. Boxes past Wo, Ho or
// Co are clipped by the stores, and a box never covers a column that
// another block owns (the box tile is at least 32 columns wide). TMA needs
// y's rows at a multiple of 16 bytes (mt_int8_y_by_tma: f32 Wo % 4 == 0,
// bf16 Wo % 8 == 0; a transposed conv's rows are 2 Wo); for other widths a
// warp per staged row stores them (tma_y == 0). The grid (one dimension)
// runs an M tile's N tiles back to back, so that the 2-4 blocks that read
// one A box run together and its re-reads hit L2 (every M tile of N tile 0
// before N tile 1's was 1-12 % slower at 2-4 N tiles: PERF.md).
//   stride 2: y (B, Co, Ho, Wo) as a (Wo, Ho, Co, B, 1) array; staged row
//     c by + ly of chunk j holds columns ox0 + 32 j .. + 31 of output row oy0
//     + ly of channel n0 + c.
//   transposed: y (B, Co, 2 Ho, 2 Wo) as (2 Wo, 2, Ho, Co, B), x = 2 ox + px,
//     output row 2 oy + py; the weight rows are n = co 4 + py 2 + px (the
//     plain version's phase_row), so that an N tile holds whole channels, and
//     staged row (co by + ly) 2 + py of chunk j holds x = 2 ox0 + 32 j .. +
//     31 of output row 2 (oy0 + ly) + py of channel n0 / 4 + co.
// ---------------------------------------------------------------------------
struct BConvArgs {
  const float* scale;
  const float* bias;
  void* y;  // TOut
  long long* psum;
  long long* psq;
  int Hp, Cp, R, Ho, Wo;
  int tiles, tiles_x, bx, by;  // M tiles per image, and per band of by rows; the box
  int n0;                      // the launch's first output row
  int tma_y;                   // y by TMA stores (map_y), or by the threads
  int ntiles;                  // N tiles of this launch, each M tile's back to back
};

// the box conv's N tile, and its ring: kSlab channels (bytes) a slab, 128
// with the 128-byte swizzle, or 64 with the 64-byte one for inputs of at
// most 64 channels (a 128-channel slab of them would be half zeros); at N
// 128 a ring small enough that two blocks share an SM and one's epilogue
// overlaps the other's main loop, and big enough for the s32 tile (pitch
// kStage) and then y (kNW x 128 f32 at most), which go over it
constexpr int kBoxNW = 128;

template <int kNW, int kSlab>
struct BoxRing {
  static constexpr int kA = kWM * kSlab, kB = kNW * kSlab;  // an A slab, a B slab
  static constexpr int kStaged = kNW * kStage * 4;  // the s32 tile
  // at least 3 stages, and as many as the staged tile needs
  static constexpr int kStages = (kStaged + kA + kB - 1) / (kA + kB) > 3
                                     ? (kStaged + kA + kB - 1) / (kA + kB) : 3;
  static constexpr int kBytes = kStages * (kA + kB);
  static constexpr int kSmem = kBytes + 2 * 2 * 128 * 8 + 2 * kStages * 8 + 2 * kNW * 4 + 1024;
  static_assert(kStaged <= kBytes && kNW * kWM * 4 <= kBytes, "the staged tile fits the ring");
};

// the byte offset of element (row, x), x < 32, of a region of rows of 32 T
// (128 bytes of f32, 64 of bf16) that starts on a 1024-byte boundary, as
// TMA's swizzle of the row's width lays it: a row's 16-byte units are XORed
// with address bits [7:9] (128-byte swizzle: the row's place in its
// 1024-byte block) or [7:8] (64-byte swizzle: its place in a 512-byte
// block, in pairs of rows)
template <typename T>
__device__ __forceinline__ int swizzled(int row, int x) {
  constexpr int kRow = 32 * static_cast<int>(sizeof(T));
  const int byte = x * static_cast<int>(sizeof(T));
  return row * kRow + (((byte >> 4) ^ ((row * kRow >> 7) & (kRow / 16 - 1))) << 4) + (byte & 15);
}

// a transposed conv's two adjacent output columns (px 0, 1) as one store
__device__ __forceinline__ void store_pair(float* to, float a, float b) {
  *reinterpret_cast<float2*>(to) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* to, float a, float b) {
  *reinterpret_cast<uint32_t*>(to) = mt::Vec<__nv_bfloat16>::pack2(a, b);
}

template <int kNW, bool kSub, int kSlab, typename TOut>
__global__ void __launch_bounds__(kWThreads, 2)
    conv_box_kernel(const __grid_constant__ CUtensorMap map_in,
                    const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_y, BConvArgs p) {
  using Ring = BoxRing<kNW, kSlab>;
  constexpr int kA = Ring::kA, kB = Ring::kB, kBoxStages = Ring::kStages;
  constexpr int kKw = kSub ? 2 : 3, kTaps = kKw * kKw;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  uint8_t* ring_a = smem_raw + (((base + 1023) & ~1023u) - base);
  uint8_t* ring_b = ring_a + kBoxStages * kA;
  long long* red = reinterpret_cast<long long*>(ring_b + kBoxStages * kB);  // [2][2][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * 2 * 128);
  uint64_t* empty = full + kBoxStages;
  float2* sc_bi = reinterpret_cast<float2*>(empty + kBoxStages);  // [kNW]: (scale, bias)
  ring_init<kBoxStages>(full, empty);
  const int mt = blockIdx.x / p.ntiles, nt = blockIdx.x % p.ntiles;  // M tile, N tile
  const int b = mt / p.tiles, tile = mt % p.tiles;
  const int ty = tile / p.tiles_x, tx = tile - ty * p.tiles_x;
  const int oy0 = ty * p.by, ox0 = tx * p.bx;
  const int n0 = p.n0 + nt * kNW;
  if (threadIdx.x < kNW) {
    const int n = n0 + threadIdx.x;
    sc_bi[threadIdx.x] = make_float2(n < p.R ? p.scale[n] : 0.f,
                                     n < p.R && p.bias != nullptr ? p.bias[n] : 0.f);
  }
  __syncthreads();

  const int cslabs = (p.Cp + kSlab - 1) / kSlab, ksteps = kTaps * cslabs;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer warp
    if (threadIdx.x == 256) {
      const int hp = p.Hp;
      const CUtensorMap *in = &map_in, *wt = &map_w;
      produce<kBoxStages, kA, kB>(
          ring_a, ring_b, full, empty, ksteps, (p.bx * p.by + kNW) * kSlab,
          [=](uint8_t* a, uint8_t* w, int k, uint64_t* bar) {
            const int tap = k / cslabs, c0 = (k - tap * cslabs) * kSlab;
            const int ky = tap / kKw, kx = tap - ky * kKw;
            if (kSub)
              tma_load_5d(a, in, bar, c0, ox0 + kx, b * hp + oy0 + ky, 0, 0);
            else
              tma_load_5d(a, in, bar, c0, kx & 1, ox0 + (kx >> 1), ky & 1,
                          b * (hp / 2) + oy0 + (ky >> 1));
            tma_load_3d(w, wt, bar, c0, tap, n0);
          });
    }
    return;
  }

  int acc[kNW / 2];
  consume<kNW, kSlab, kBoxStages, kA, kB>(acc, ring_a, ring_b, full, empty, ksteps, wg);

  // the epilogue, over the ring once both warpgroups are done with it
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  // tile row r is box pixel (r / bx, r % bx): bx is 32, 64 or 128 (box_tile)
  const int lg = p.bx == 128 ? 7 : p.bx == 64 ? 6 : 5;  // log2 bx
  const int by = p.by, chunk_rows = kSub ? kNW / 2 * by : kNW * by;
  const int vy = min(by, p.Ho - oy0), vx = min(p.bx, p.Wo - ox0);  // the box's pixels inside
  // 1. the s32 tile [column][row] (box pixel r / bx, r % bx of row r)
  int* st = reinterpret_cast<int*>(ring_a);
  stage_acc<kNW>(st, acc, wg);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  // 2. the int64 partials over the pixels inside: each warpgroup adds its 64
  // rows of a column per thread, then the two are added
  if (p.psum != nullptr) {
    const int c = threadIdx.x % 128, r0 = wg * 64;
    long long s = 0, q = 0;
    if (c < kNW) {
      const int* col = st + c * kStage;
      if (vy == by && vx == p.bx) {  // the whole box inside: rows < bx by
        const int r1 = min(r0 + 64, p.bx * by);
        long long s2 = 0, q2 = 0;  // two chains of additions
#pragma unroll 4
        for (int r = r0; r < r1 - 1; r += 2) {
          const int a = col[r], a2 = col[r + 1];
          s += a;
          q += static_cast<long long>(a) * a;
          s2 += a2;
          q2 += static_cast<long long>(a2) * a2;
        }
        if ((r1 - r0) & 1) {
          const int a = col[r1 - 1];
          s += a;
          q += static_cast<long long>(a) * a;
        }
        s += s2;
        q += q2;
      } else {
        for (int r = r0; r < r0 + 64; ++r) {
          if ((r >> lg) >= vy || (r & (p.bx - 1)) >= vx) continue;
          const int a = col[r];
          s += a;
          q += static_cast<long long>(a) * a;
        }
      }
    }
    red[wg * 256 + c] = s;
    red[wg * 256 + 128 + c] = q;
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the s32 tile is read: y goes over it
  if (p.psum != nullptr && threadIdx.x < min(kNW, p.R - n0)) {
    const int64_t o = (static_cast<int64_t>(b) * p.tiles + tile) * p.R + n0 + threadIdx.x;
    p.psum[o] = red[threadIdx.x] + red[256 + threadIdx.x];
    p.psq[o] = red[128 + threadIdx.x] + red[384 + threadIdx.x];
  }
  // 3. y, dequantized from the accumulators and rounded to TOut, into the
  // stores' layout (rows of 32 TOut, kRow bytes). Column c = 8 j + 2 (lane %
  // 4) + e is staged row row0 + j step, and 2 step is a multiple of 8, so
  // the row's swizzle alternates between two values. For the transposed
  // conv e is px: a thread's two values of a j sit side by side (one 8-byte
  // store of f32, 4-byte of bf16)
  constexpr int kRow = 32 * static_cast<int>(sizeof(TOut));
  uint8_t* sy = ring_a;
  const int q4 = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + lane / 4 + 8 * h, ly = r >> lg, lx = r & (p.bx - 1);
    if (ly >= by) continue;  // past a box of fewer than 128 pixels
#pragma unroll
    for (int e = 0; e < (kSub ? 1 : 2); ++e) {
      const int x = kSub ? 2 * lx : lx;
      const int row0 = kSub ? (((q4 >> 1) * by + ly) << 1) + (q4 & 1) : (2 * q4 + e) * by + ly;
      const int step = kSub ? 4 * by : 8 * by;
      uint8_t* at = sy + (x >> 5) * chunk_rows * kRow;
      // the byte offsets of rows row0 + j step, j even and odd
      const int o0 = swizzled<TOut>(row0, x & 31);
      const int o1 = swizzled<TOut>(row0 + step, x & 31) - step * kRow;
#pragma unroll
      for (int j = 0; j < kNW / 8; ++j) {
        const int c = 8 * j + 2 * q4 + e;
        const float2 sb = sc_bi[c];
        float v = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), sb.x);
        if (p.bias != nullptr) v = __fadd_rn(v, sb.y);
        uint8_t* to = at + j * step * kRow + (j & 1 ? o1 : o0);
        if (kSub) {
          const float2 sb1 = sc_bi[c + 1];
          float v1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sb1.x);
          if (p.bias != nullptr) v1 = __fadd_rn(v1, sb1.y);
          store_pair(reinterpret_cast<TOut*>(to), v, v1);
        } else {
          *reinterpret_cast<TOut*>(to) = mt::from_float<TOut>(v);
        }
      }
    }
  }
  // the chunks of 32 output columns that hold some inside the box
  const int chunks = ((kSub ? 2 * vx : vx) + 31) >> 5;
  if (p.tma_y) {
    fence_proxy_async();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int j = 0; j < chunks; ++j) {
        if (kSub)
          tma_store_5d(&map_y, sy + j * chunk_rows * kRow, 2 * ox0 + 32 * j, 0, oy0, n0 >> 2, b);
        else
          tma_store_5d(&map_y, sy + j * chunk_rows * kRow, ox0 + 32 * j, oy0, n0, b, 0);
      }
      tma_store_drain_reads();
    }
    return;
  }
  // a warp per staged row of 32 output columns, its lanes along them
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int gw = threadIdx.x / 32;
  const int co_n = kSub ? p.R / 4 : p.R, plane_h = kSub ? 2 * p.Ho : p.Ho;
  const int plane_w = kSub ? 2 * p.Wo : p.Wo;
  for (int row = gw; row < chunks * chunk_rows; row += 8) {
    const int j = row / chunk_rows, rr = row - j * chunk_rows;
    const int cl = kSub ? rr >> 1 : rr, co_l = cl / by, ly = cl - co_l * by;
    const int co = (kSub ? n0 >> 2 : n0) + co_l;
    const int oy = kSub ? 2 * (oy0 + ly) + (rr & 1) : oy0 + ly;
    const int x = (kSub ? 2 * ox0 : ox0) + 32 * j + lane;
    if (co < co_n && oy0 + ly < p.Ho && x < plane_w)
      static_cast<TOut*>(p.y)[((static_cast<int64_t>(b) * co_n + co) * plane_h + oy) * plane_w +
                              x] =
          *reinterpret_cast<const TOut*>(sy + j * chunk_rows * kRow + swizzled<TOut>(rr, lane));
  }
}

// ---------------------------------------------------------------------------
// statistics: per-(sample, channel) sum and sum of squares of y from the
// exact int64 partials (see Numerics above), phases added in order; then
// optionally the IN/AdaIN affine a = (1 + gamma) / sqrt(max(var, 0) + eps),
// b = beta - mean * a, each step correctly rounded as torch's separate ops
// are. One warp per (sample, channel): its lanes stride over the tiles and a
// shuffle adds their integers, exact in any order.
// ---------------------------------------------------------------------------
constexpr int kStatsThreads = 256;

__global__ void stats_kernel(const long long* __restrict__ psum,
                             const long long* __restrict__ psq,
                             const float* __restrict__ scale, const float* __restrict__ bias,
                             float* __restrict__ s, float* __restrict__ q,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             float* __restrict__ a, float* __restrict__ shift, int B,
                             int tiles, int R, int Co, double hw, float n, float eps) {
  const int i = (blockIdx.x * kStatsThreads + threadIdx.x) / mt::kWarp;
  const int lane = threadIdx.x % mt::kWarp;
  if (i >= B * Co) return;  // whole warps: i is the same across a warp
  const int b = i / Co, co = i % Co;
  const int phases = R / Co;
  double ss = 0.0, qq = 0.0;
  for (int ph = 0; ph < phases; ++ph) {
    const int row = phases * co + ph;  // phase ph = 2 py + px of a transposed conv
    long long s1 = 0, hi = 0, lo = 0;
    for (int t = lane; t < tiles; t += mt::kWarp) {
      const int64_t o = (static_cast<int64_t>(b) * tiles + t) * R + row;
      s1 += psum[o];
      const long long p2 = psq[o];
      hi += p2 >> 32;
      lo += p2 & 0xffffffffLL;
    }
    s1 = mt::warp_sum(s1);
    hi = mt::warp_sum(hi);
    lo = mt::warp_sum(lo);
    const double d1 = __ll2double_rn(s1);
    const double d2 = __dadd_rn(__dmul_rn(__ll2double_rn(hi), 4294967296.0), __ll2double_rn(lo));
    const double sc = scale[row];
    const double bi = bias != nullptr ? static_cast<double>(bias[row]) : 0.0;
    const double s_ph = __dadd_rn(__dmul_rn(sc, d1), __dmul_rn(hw, bi));
    const double q_ph = __dadd_rn(__dadd_rn(__dmul_rn(__dmul_rn(sc, sc), d2),
                                            __dmul_rn(__dmul_rn(2.0 * sc, bi), d1)),
                                  __dmul_rn(hw, __dmul_rn(bi, bi)));
    ss = __dadd_rn(ss, s_ph);
    qq = __dadd_rn(qq, q_ph);
  }
  if (lane != 0) return;
  const float sf = __double2float_rn(ss), qf = __double2float_rn(qq);
  s[i] = sf;
  q[i] = qf;
  if (a != nullptr) {
    const float mean = __fdiv_rn(sf, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(qf, n), __fmul_rn(mean, mean)), 0.f);
    const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
    const float av = __fmul_rn(__fadd_rn(1.f, gamma[i]), rstd);
    a[i] = av;
    shift[i] = __fsub_rn(beta[i], __fmul_rn(mean, av));
  }
}

// out NCHW = x NCHW + round(h * a + b), h NHWC (B, HW, C) as conv2 stores
// it, all of type T (f32 or bf16; the affine in f32, rounded to T, then the
// sum in f32 rounded to T: the JAX package's x + y.astype(x.dtype)): a block
// moves a tile of 32 pixels x 64 channels of h through shared memory,
// reading h along its channels and x and out along the pixels. Block (pixel
// tile, b, channel group), 256 threads.
constexpr int kRP = 32, kRC = 64;

template <typename T>
__global__ void __launch_bounds__(256)
    residual_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ h,
                         const float* __restrict__ a, const float* __restrict__ b,
                         T* __restrict__ out, int C, int HW) {
  __shared__ float tile[kRC][kRP + 1];
  const int p0 = blockIdx.x * kRP, bi = blockIdx.y, c0 = blockIdx.z * kRC;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // this thread's x values (channels warp + 8 k, pixel p0 + lane), loaded
  // before the tile so that their latency overlaps h's
  constexpr int kPer = kRC / 8;
  const bool px_ok = p0 + lane < HW;
  float xv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = c0 + warp + 8 * k;
    xv[k] = px_ok && c < C ? mt::to_float(x[(static_cast<int64_t>(bi) * C + c) * HW + p0 + lane])
                           : 0.f;
  }
  const T* hb = h + static_cast<int64_t>(bi) * HW * C;
  if (C % 4 == 0) {
    for (int i = threadIdx.x; i < kRP * (kRC / 4); i += 256) {
      const int j = i / (kRC / 4), c = c0 + 4 * (i % (kRC / 4));
      if (p0 + j >= HW || c >= C) continue;
      float v[4];
      load4(hb + static_cast<int64_t>(p0 + j) * C + c, v);
      tile[c - c0][j] = v[0];
      tile[c - c0 + 1][j] = v[1];
      tile[c - c0 + 2][j] = v[2];
      tile[c - c0 + 3][j] = v[3];
    }
  } else {
    for (int i = threadIdx.x; i < kRP * kRC; i += 256) {
      const int j = i / kRC, c = c0 + i % kRC;
      if (p0 + j < HW && c < C)
        tile[c - c0][j] = mt::to_float(hb[static_cast<int64_t>(p0 + j) * C + c]);
    }
  }
  __syncthreads();
  if (!px_ok) return;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = warp + 8 * k;
    if (c0 + c >= C) break;
    const int64_t bc = static_cast<int64_t>(bi) * C + c0 + c;
    const float y =
        mt::to_float(mt::from_float<T>(__fadd_rn(__fmul_rn(tile[c][lane], a[bc]), b[bc])));
    out[bc * HW + p0 + lane] = mt::from_float<T>(__fadd_rn(xv[k], y));
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int kNW, typename TOut>
int launch_s1(const CUtensorMap& map_in, const void* w, WConvArgs a, int64_t B, int ntile0,
              int ntiles, cudaStream_t stream) {
  // the weights as (R, 9, Cp) boxes of kNW rows: past R they read zeros
  CUtensorMap map_w;
  if (!make_map_3d(&map_w, kInt8, w, a.Cp, 9, a.R, kWK, kNW)) return cudaErrorInvalidValue;
  // the shared-memory opt-in, once per device (a host call on every launch
  // of a path that waits on the host)
  static uint64_t allowed = 0;
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return got;
  if (dev >= 64 || !(allowed >> dev & 1)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        conv_s1_wgmma_kernel<kNW, TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
    if (attr != cudaSuccess) return attr;
    if (dev < 64) allowed |= 1ULL << dev;
  }
  a.ntile0 = ntile0;
  dim3 grid(static_cast<unsigned>(B * a.tiles), static_cast<unsigned>(ntiles));
  conv_s1_wgmma_kernel<kNW, TOut><<<grid, kWThreads, kWSmem, stream>>>(map_in, map_w, a);
  return last_error();
}

// the stride-1 conv's launches: checks, the input's TMA descriptor, the full
// N tiles at width 256, then a last, narrower tile if R is not a multiple of
// 256
template <typename TOut>
int conv_s1(const void* xq, const void* w, WConvArgs a, int64_t B, cudaStream_t stream) {
  const uint64_t rows = static_cast<uint64_t>(B) * a.Hp * a.Wp;
  if (a.Hp < 3 || a.Wp < 3 || rows >= (1ULL << 31) || !aligned(xq) || !aligned(w) ||
      B * a.tiles >= (1LL << 31) || (a.R + kWN - 1) / kWN >= 65536)
    return cudaErrorInvalidValue;
  if (B == 0 || a.R == 0) return last_error();
  CUtensorMap map_in;
  if (!make_map(&map_in, kInt8, xq, a.Cp, rows, kWK, kWM)) return cudaErrorInvalidValue;
  const int full = a.R / kWN, tail = a.R % kWN;
  if (full > 0) {
    const int err = launch_s1<256, TOut>(map_in, w, a, B, 0, full, stream);
    if (err != cudaSuccess) return err;
  }
  if (tail > 128) return launch_s1<256, TOut>(map_in, w, a, B, full, 1, stream);
  if (tail > 64) return launch_s1<128, TOut>(map_in, w, a, B, full, 1, stream);
  if (tail > 32) return launch_s1<64, TOut>(map_in, w, a, B, full, 1, stream);
  if (tail > 0) return launch_s1<32, TOut>(map_in, w, a, B, full, 1, stream);
  return last_error();
}

// the dynamic shared-memory opt-in of a kernel, once per device (a host call
// on every launch of a path that waits on the host)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, uint64_t& allowed) {
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return got;
  if (dev < 64 && (allowed >> dev & 1)) return cudaSuccess;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr == cudaSuccess && dev < 64) allowed |= 1ULL << dev;
  return attr;
}

// the box tile of the stride-2 and transposed convs: bx = 32, 64 or 128
// output columns, the least that holds Wo, or 128 (a power of two: the
// epilogue finds a row's box pixel by shifts), x by = min(128 / bx, Ho) rows
void box_tile(int64_t Ho, int64_t Wo, int64_t* bx, int64_t* by) {
  *bx = Wo <= 32 ? 32 : Wo <= 64 ? 64 : kWM;
  const int64_t rows = kWM / *bx;
  *by = rows < Ho ? rows : Ho;
}

template <int kSlab>
constexpr CUtensorMapSwizzle slab_swizzle() {
  return kSlab == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

template <int kNW, bool kSub, int kSlab, typename TOut>
int launch_box(const CUtensorMap& map_in, const void* w, BConvArgs a, int64_t B, int n0,
               int ntiles, cudaStream_t stream) {
  // the weights as (R, taps, Cp) boxes of kNW rows: past R they read zeros
  CUtensorMap map_w, map_y = {};
  if (!make_map_3d(&map_w, kInt8, w, a.Cp, kSub ? 4 : 9, a.R, kSlab, kNW, slab_swizzle<kSlab>()))
    return cudaErrorInvalidValue;
  if (a.tma_y) {  // y as the stores see it (see conv_box_kernel), e bytes an element
    constexpr bool f32 = std::is_same<TOut, float>::value;
    constexpr uint64_t e = sizeof(TOut);
    const CUtensorMapSwizzle swizzle = f32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
    const uint64_t wo = a.Wo, ho = a.Ho, bb = B, by = static_cast<uint64_t>(a.by);
    const bool made =
        kSub ? make_map_5d(&map_y, f32 ? kF32 : kBf16, a.y, {2 * wo, 2, ho, a.R / 4u, bb},
                           {2 * e * wo, 4 * e * wo, 4 * e * ho * wo, a.R * e * ho * wo},
                           {32, 2, static_cast<uint32_t>(by), kNW / 4, 1}, swizzle)
             : make_map_5d(&map_y, f32 ? kF32 : kBf16, a.y,
                           {wo, ho, static_cast<uint64_t>(a.R), bb, 1},
                           {e * wo, e * ho * wo, e * a.R * ho * wo, e * bb * a.R * ho * wo},
                           {32, static_cast<uint32_t>(by), kNW, 1, 1}, swizzle);
    if (!made) return cudaErrorInvalidValue;
  }
  constexpr int kSmem = BoxRing<kNW, kSlab>::kSmem;
  static uint64_t allowed = 0;
  const cudaError_t err = allow_smem(conv_box_kernel<kNW, kSub, kSlab, TOut>, kSmem, allowed);
  if (err != cudaSuccess) return err;
  a.n0 = n0;
  a.ntiles = ntiles;
  const unsigned grid = static_cast<unsigned>(B * a.tiles * ntiles);
  conv_box_kernel<kNW, kSub, kSlab, TOut><<<grid, kWThreads, kSmem, stream>>>(map_in, map_w,
                                                                            map_y, a);
  return last_error();
}

// the full N tiles at width 128 in one launch, then a last, narrower tile
// if R is not a multiple of 128, at the narrowest wgmma width that covers it
template <bool kSub, int kSlab, typename TOut>
int conv_box(const CUtensorMap& map_in, const void* w, BConvArgs a, int64_t B,
             cudaStream_t stream) {
  const int full = a.R / kBoxNW, tail = a.R % kBoxNW, n0 = full * kBoxNW;
  if (full > 0) {
    const int err = launch_box<kBoxNW, kSub, kSlab, TOut>(map_in, w, a, B, 0, full, stream);
    if (err != cudaSuccess) return err;
  }
  if (tail > 64) return launch_box<128, kSub, kSlab, TOut>(map_in, w, a, B, n0, 1, stream);
  if (tail > 32) return launch_box<64, kSub, kSlab, TOut>(map_in, w, a, B, n0, 1, stream);
  if (tail > 0) return launch_box<32, kSub, kSlab, TOut>(map_in, w, a, B, n0, 1, stream);
  return last_error();
}

template <bool kSub, typename TOut>
int conv_box_slab(bool narrow, const CUtensorMap& map_in, const void* w, BConvArgs a, int64_t B,
                  cudaStream_t stream) {
  return narrow ? conv_box<kSub, 64, TOut>(map_in, w, a, B, stream)
                : conv_box<kSub, 128, TOut>(map_in, w, a, B, stream);
}

template <typename TIn>
void quant_pad_launch(int qc, dim3 grid, cudaStream_t stream, const void* x, void* out,
                      const void* inv_sx, const void* pa, const void* pb, int relu, float alpha,
                      int C, int H, int W, int Cp, int Hp, int Wp, int pt, int pl, int reflect) {
  auto kernel = qc == 64 ? quant_pad_kernel<64, TIn> : quant_pad_kernel<128, TIn>;
  kernel<<<grid, 256, 0, stream>>>(static_cast<const TIn*>(x), static_cast<int8_t*>(out),
                                   static_cast<const float*>(inv_sx),
                                   static_cast<const float*>(pa), static_cast<const float*>(pb),
                                   relu, alpha, C, H, W, Cp, Hp, Wp, pt, pl, reflect);
}

}  // namespace

// x: (B, C, H, W) f32, or bf16 with x_bf16; out: (B, Hp, Wp, Cp) int8 (Cp a
// multiple of 32), with pads of at most one row or column at each side and,
// past them, zero rows and columns to Hp x Wp (at most one more of each);
// inv_sx: one f32 on the device; pa, pb: (B, C) f32 or null.
extern "C" int mt_int8_quant_pad(const void* x, void* out, const void* inv_sx, const void* pa,
                                 const void* pb, int relu, float alpha, int64_t B, int64_t C,
                                 int64_t H, int64_t W, int64_t Cp, int64_t Hp, int64_t Wp,
                                 int64_t pt, int64_t pl, int reflect, int x_bf16, void* stream) {
  const int64_t pr = Wp - W - pl, pb_ = Hp - H - pt;
  if (Cp % 32 != 0 || Cp / 64 >= 65536 || B * Hp >= (1LL << 31) || pl < 0 || pl > 1 || pr < 0 ||
      pr > 2 || pt < 0 || pt > 1 || pb_ < 0 || pb_ > 2 || !aligned(out) ||
      (W % 4 == 0 && !aligned(x)))
    return cudaErrorInvalidValue;
  if (B == 0 || Hp == 0 || Wp == 0) return last_error();
  const int qc = Cp <= 64 ? 64 : 128;  // channels per block
  dim3 grid(static_cast<unsigned>(B * Hp), static_cast<unsigned>((Wp + kQSeg - 1) / kQSeg),
            static_cast<unsigned>((Cp + qc - 1) / qc));
  auto launch = x_bf16 ? quant_pad_launch<__nv_bfloat16> : quant_pad_launch<float>;
  launch(qc, grid, static_cast<cudaStream_t>(stream), x, out, inv_sx, pa, pb, relu, alpha,
         static_cast<int>(C), static_cast<int>(H), static_cast<int>(W), static_cast<int>(Cp),
         static_cast<int>(Hp), static_cast<int>(Wp), static_cast<int>(pt), static_cast<int>(pl),
         reflect);
  return last_error();
}

// the same from x NHWC (B, H, W, C) f32, or bf16 with x_bf16 (16-byte aligned)
extern "C" int mt_int8_quant_pad_nhwc(const void* x, void* out, const void* inv_sx, const void* pa,
                                      const void* pb, int relu, float alpha, int64_t B, int64_t C,
                                      int64_t H, int64_t W, int64_t Cp, int64_t Hp, int64_t Wp,
                                      int64_t pt, int64_t pl, int reflect, int x_bf16,
                                      void* stream) {
  const int64_t row = Wp * (Cp / kQV);  // threads per padded row
  if (Cp % kQV != 0 || !aligned(x) || !aligned(out) ||
      (pa != nullptr && (!aligned(pa) || !aligned(pb))) || B * Hp >= (1LL << 31) ||
      (row + 255) / 256 >= 65536)
    return cudaErrorInvalidValue;
  if (B * Hp * row > 0) {
    dim3 grid(static_cast<unsigned>(B * Hp), static_cast<unsigned>((row + 255) / 256));
    auto st = static_cast<cudaStream_t>(stream);
    const int c = static_cast<int>(C), h = static_cast<int>(H), w = static_cast<int>(W);
    const int cp = static_cast<int>(Cp), hp = static_cast<int>(Hp), wp = static_cast<int>(Wp);
    const int t = static_cast<int>(pt), l = static_cast<int>(pl);
    const float* fa = static_cast<const float*>(pa);
    const float* fb = static_cast<const float*>(pb);
    int8_t* q = static_cast<int8_t*>(out);
    const float* inv = static_cast<const float*>(inv_sx);
    if (x_bf16)
      quant_pad_nhwc_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), q, inv, fa, fb, relu, alpha, c, h, w, cp, hp, wp,
          t, l, reflect);
    else
      quant_pad_nhwc_kernel<float><<<grid, 256, 0, st>>>(static_cast<const float*>(x), q, inv, fa,
                                                         fb, relu, alpha, c, h, w, cp, hp, wp, t,
                                                         l, reflect);
  }
  return last_error();
}

// The M tiles per image of mt_int8_conv's launch, which are the rows of its
// statistics partials, and in *tile_rows the most output pixels of one tile:
// stride 1 without phases runs over the padded width, m = oy * Wp + ox in
// tiles of kWM rows; stride 2 and the transposed conv over box tiles of by
// output rows x bx columns (box_tile).
extern "C" int64_t mt_int8_stat_tiles(int64_t stride, int phases, int64_t Ho, int64_t Wo,
                                      int64_t Wp, int64_t* tile_rows) {
  *tile_rows = kWM;
  if (Ho <= 0 || Wo <= 0) return 0;
  if (stride == 1 && !phases) return (Ho * Wp + kWM - 1) / kWM;
  int64_t bx = 0, by = 0;
  box_tile(Ho, Wo, &bx, &by);
  *tile_rows = bx * by;
  return ((Ho + by - 1) / by) * ((Wo + bx - 1) / bx);
}

// The rows of one N tile of mt_int8_conv (stride, phases): 256 (kWN) for
// stride 1 without phases, else kBoxNW.
extern "C" int64_t mt_int8_n_tile(int64_t stride, int phases) {
  return stride == 1 && !phases ? kWN : kBoxNW;
}

// The output rows of each conv launch of mt_int8_conv, in launch order, in
// rows[0..1]; returns the number of launches: the full N tiles in one
// launch, then a tail tile.
extern "C" int mt_int8_conv_launches(int64_t stride, int phases, int64_t R, int64_t* rows) {
  const int64_t nw = mt_int8_n_tile(stride, phases);
  int n = 0;
  if (R >= nw) rows[n++] = R / nw * nw;
  if (R % nw != 0) rows[n++] = R % nw;
  return n;
}

// Whether mt_int8_conv's stride-2 or transposed conv (stride, phases) of
// output width Wo stores y (f32, or bf16 with y_bf16) by TMA box stores,
// given a 16-byte-aligned y: TMA needs y's rows, Wo (stride 2) or 2 Wo
// (transposed) elements, at a multiple of 16 bytes. The stride-1 convs
// store by the threads.
extern "C" int mt_int8_y_by_tma(int64_t stride, int phases, int64_t Wo, int y_bf16) {
  if (stride == 1 && !phases) return 0;
  return (phases ? 2 * Wo : Wo) * (y_bf16 ? 2 : 4) % 16 == 0;
}

// xq: (B, Hp, Wp, Cp) int8; w: (R, T, Cp) int8; scale, bias: (R,) f32 (bias
// may be null); y: (B, Co, Ho, Wo) f32 (bf16 with y_bf16), or (B, Ho, Wo, Co) when nhwc (stride
// 1 without phases only), or (B, Co, 2Ho, 2Wo) when phases (T = 4 taps of a
// 2x2 conv, R = 4 Co, row n = co 4 + py 2 + px to output pixel (2 oy + py, 2
// ox + px)); psum, psq: (B, tiles, R) int64 or null, tiles as
// mt_int8_stat_tiles gives them. Stride 2 takes even Hp and Wp.
extern "C" int mt_int8_conv(const void* xq, const void* w, const void* scale, const void* bias,
                            void* y, void* psum, void* psq, int64_t B, int64_t Hp, int64_t Wp,
                            int64_t Cp, int64_t R, int64_t T, int64_t kw, int64_t stride,
                            int64_t Ho, int64_t Wo, int64_t Co, int64_t tiles, int phases,
                            int nhwc, int y_bf16, void* stream) {
  int64_t tile_rows = 0;
  if (Cp % 32 != 0 || B >= 65536 || (R + 31) / 32 >= 65536 || tiles >= (1LL << 31) ||
      tiles != mt_int8_stat_tiles(stride, phases, Ho, Wo, Wp, &tile_rows))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (stride == 1 && !phases) {
    if (T != 9 || kw != 3 || Ho != Hp - 2 || Wo != Wp - 2 || Co != R) return cudaErrorInvalidValue;
    WConvArgs a{static_cast<const float*>(scale), static_cast<const float*>(bias), y,
                static_cast<long long*>(psum), static_cast<long long*>(psq),
                static_cast<int>(Hp), static_cast<int>(Wp), static_cast<int>(Cp),
                static_cast<int>(R), static_cast<int>(tiles), nhwc, 0};
    return y_bf16 ? conv_s1<__nv_bfloat16>(xq, w, a, B, st) : conv_s1<float>(xq, w, a, B, st);
  }
  const bool sub = phases != 0;
  const bool ok =
      sub ? stride == 1 && T == 4 && kw == 2 && Ho == Hp - 1 && Wo == Wp - 1 && R == 4 * Co
          : stride == 2 && T == 9 && kw == 3 && Hp % 2 == 0 && Wp % 2 == 0 &&
                Ho == (Hp - 3) / 2 + 1 && Wo == (Wp - 3) / 2 + 1 && Co == R;
  if (!ok || nhwc || static_cast<uint64_t>(B) * Hp * Wp >= (1ULL << 31) ||
      B * tiles * ((R + kBoxNW - 1) / kBoxNW) >= (1LL << 31) || 4 * Ho * Wo >= (1LL << 31) ||
      !aligned(xq) || !aligned(w))
    return cudaErrorInvalidValue;
  if (B == 0 || R == 0 || tiles == 0) return last_error();
  int64_t bx = 0, by = 0;
  box_tile(Ho, Wo, &bx, &by);
  BConvArgs a{static_cast<const float*>(scale), static_cast<const float*>(bias), y,
              static_cast<long long*>(psum),
              static_cast<long long*>(psq), static_cast<int>(Hp), static_cast<int>(Cp),
              static_cast<int>(R), static_cast<int>(Ho), static_cast<int>(Wo),
              static_cast<int>(tiles), static_cast<int>((Wo + bx - 1) / bx),
              static_cast<int>(bx), static_cast<int>(by), 0,
              mt_int8_y_by_tma(stride, phases, Wo, y_bf16) && aligned(y)};
  // slabs of 64 channels for inputs of at most 64 (the ring's A rows then
  // 64 bytes, with the 64-byte swizzle)
  const bool narrow = Cp <= 64;
  const uint32_t slab = narrow ? 64 : kWK;
  const CUtensorMapSwizzle swizzle = narrow ? slab_swizzle<64>() : slab_swizzle<128>();
  const uint64_t c = static_cast<uint64_t>(Cp), wp = static_cast<uint64_t>(Wp);
  const uint64_t rows = static_cast<uint64_t>(B) * Hp;
  const uint32_t bxu = static_cast<uint32_t>(bx), byu = static_cast<uint32_t>(by);
  CUtensorMap map_in;
  if (sub) {
    // the input as (Cp, Wp, B Hp): tap (ky, kx) of a box is one box at (c0,
    // ox0 + kx, b Hp + oy0 + ky)
    if (!make_map_5d(&map_in, kInt8, xq, {c, wp, rows, 1, 1},
                     {c, wp * c, rows * wp * c, rows * wp * c}, {slab, bxu, byu, 1, 1}, swizzle))
      return cudaErrorInvalidValue;
    return y_bf16 ? conv_box_slab<true, __nv_bfloat16>(narrow, map_in, w, a, B, st)
                  : conv_box_slab<true, float>(narrow, map_in, w, a, B, st);
  }
  // the input as (Cp, 2, Wp / 2, 2, B Hp / 2): tap (ky, kx) of a box is one
  // box at (c0, kx & 1, ox0 + kx / 2, ky & 1, b Hp / 2 + oy0 + ky / 2), which
  // lands as by x bx pixel rows of a slab's bytes
  if (!make_map_5d(&map_in, kInt8, xq, {c, 2, wp / 2, 2, rows / 2}, {c, 2 * c, wp * c, 2 * wp * c},
                   {slab, 1, bxu, 1, byu}, swizzle))
    return cudaErrorInvalidValue;
  return y_bf16 ? conv_box_slab<false, __nv_bfloat16>(narrow, map_in, w, a, B, st)
                : conv_box_slab<false, float>(narrow, map_in, w, a, B, st);
}

// psum, psq: (B, tiles, R) int64; scale, bias: (R,) f32 (bias may be null)
// -> s, q: (B, Co) f32 over all phases, hw values per phase row; with gamma
// and beta ((B, Co) f32) also the norm affine a, b ((B, Co) f32) over n
// values.
extern "C" int mt_int8_stats(const void* psum, const void* psq, const void* scale,
                             const void* bias, void* s, void* q, const void* gamma,
                             const void* beta, void* a, void* b, int64_t B, int64_t tiles,
                             int64_t R, int64_t Co, int64_t hw, float n, float eps,
                             void* stream) {
  const int64_t total = B * Co;
  if (total >= (1LL << 26) || R % Co != 0 || tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  if (total > 0) {
    const int64_t threads = total * mt::kWarp;
    stats_kernel<<<static_cast<unsigned>((threads + kStatsThreads - 1) / kStatsThreads),
                   kStatsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(psum), static_cast<const long long*>(psq),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float*>(s), static_cast<float*>(q), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(a), static_cast<float*>(b),
        static_cast<int>(B), static_cast<int>(tiles), static_cast<int>(R),
        static_cast<int>(Co), static_cast<double>(hw), n, eps);
  }
  return last_error();
}

// x, out: (B, C, HW) f32, or bf16 with bf16; h: (B, HW, C) of the same type,
// 16-byte aligned; a, b: (B, C) f32
extern "C" int mt_int8_residual_nhwc(const void* x, const void* h, const void* a, const void* b,
                                     void* out, int64_t B, int64_t C, int64_t HW, int bf16,
                                     void* stream) {
  if (!aligned(h) || B >= 65536 || (C + kRC - 1) / kRC >= 65536 ||
      (HW + kRP - 1) / kRP >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (B > 0 && C > 0 && HW > 0) {
    dim3 grid(static_cast<unsigned>((HW + kRP - 1) / kRP), static_cast<unsigned>(B),
              static_cast<unsigned>((C + kRC - 1) / kRC));
    auto st = static_cast<cudaStream_t>(stream);
    const float* fa = static_cast<const float*>(a);
    const float* fb = static_cast<const float*>(b);
    if (bf16)
      residual_nhwc_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(h), fa, fb,
          static_cast<__nv_bfloat16*>(out), static_cast<int>(C), static_cast<int>(HW));
    else
      residual_nhwc_kernel<float><<<grid, 256, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(h), fa, fb,
          static_cast<float*>(out), static_cast<int>(C), static_cast<int>(HW));
  }
  return last_error();
}
