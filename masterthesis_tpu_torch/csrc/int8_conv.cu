// int8 serving convolutions: one implicit-GEMM template for the stride-2
// down conv, the two stride-1 convs of the residual block, and the sub-pixel
// transposed conv.
//
// Replaces masterthesis_tpu/ops/pallas/conv_int8.py:
//   pallas_int8_downconv (:1303)  -> quant_pad + conv (3x3, stride 2) [+ stats]
//   pallas_int8_resblock (:989)   -> quant_pad, conv, stats (forms conv2's
//                                    prologue affine), quant_pad, conv,
//                                    stats, residual
//   pallas_int8_deconv   (:577)   -> quant_pad (zero pad at the end) + conv
//                                    (2x2 taps to 4 phases, interleaving
//                                    store) [+ stats]
// The wrappers are masterthesis_tpu_torch/ops/kernels/int8_conv.py, whose
// plain versions do the same arithmetic with torch ops.
//
// Bound. The resblock convs are bound by operations (19.33 G MACs each at
// 8x256x64x64, against ~67 MB of f32 in and out); the down convs and the
// transposed convs by bytes (their f32 input and output, 134-201 MB, against
// 9.66 G MACs). This first version is a simple, right design: the int8
// products run on the tensor cores through mma.sync m16n8k32 (int32
// accumulate), fed from shared memory double-buffered through registers, and
// the f32 <-> int8 conversions are separate passes through device memory.
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
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// quantize and pad: NCHW f32 -> padded NHWC int8, channels zero-padded to Cp.
// One block writes a 32 (x) by 32 (channel) tile of one padded row: it reads
// 32 channel rows coalesced along x, and writes 4-byte channel groups.
// ---------------------------------------------------------------------------
constexpr int kQT = 32;

__device__ __forceinline__ int reflect_index(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__global__ void __launch_bounds__(kQT * 8)
    quant_pad_kernel(const float* __restrict__ x, int8_t* __restrict__ out,
                     const float* __restrict__ inv_sx, const float* __restrict__ pa,
                     const float* __restrict__ pb, int relu, float alpha, int C, int H,
                     int W, int Cp, int Hp, int Wp, int pt, int pl, int reflect,
                     int cblocks) {
  __shared__ int8_t tile[kQT][kQT + 4];  // [channel][x]
  const int b = blockIdx.z / cblocks;
  const int c0 = (blockIdx.z % cblocks) * kQT;
  const int yp = blockIdx.y;
  const int x0 = blockIdx.x * kQT;
  const float inv = *inv_sx;
  int y = yp - pt;
  bool row_ok = true;
  if (y < 0 || y >= H) {
    if (reflect) y = reflect_index(y, H); else row_ok = false;
  }
  int xs = x0 + threadIdx.x - pl;
  bool col_ok = x0 + threadIdx.x < Wp;
  if (xs < 0 || xs >= W) {
    if (reflect) xs = reflect_index(xs, W); else col_ok = false;
  }
  for (int cc = threadIdx.y; cc < kQT; cc += 8) {
    const int c = c0 + cc;
    int q = 0;
    if (row_ok && col_ok && c < C) {
      float v = x[((static_cast<int64_t>(b) * C + c) * H + y) * W + xs];
      if (pa != nullptr) {
        const int64_t bc = static_cast<int64_t>(b) * C + c;
        v = __fadd_rn(__fmul_rn(v, pa[bc]), pb[bc]);
        if (relu) v = fmaxf(v, __fmul_rn(alpha, v));
      }
      const float r = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
      q = static_cast<int>(r);
    }
    tile[cc][threadIdx.x] = static_cast<int8_t>(q);
  }
  __syncthreads();
  const int t = threadIdx.y * kQT + threadIdx.x;  // 256 threads, 256 words
  const int xx = t / 8, cg = (t % 8) * 4;
  const int xp = x0 + xx;
  if (xp < Wp && c0 + cg < Cp) {
    char4 word = make_char4(tile[cg][xx], tile[cg + 1][xx], tile[cg + 2][xx], tile[cg + 3][xx]);
    *reinterpret_cast<char4*>(
        out + ((static_cast<int64_t>(b) * Hp + yp) * Wp + xp) * Cp + c0 + cg) = word;
  }
}

// ---------------------------------------------------------------------------
// the conv: implicit GEMM, M = output pixels of one image, N = output rows
// (Co, or 4 Co phase rows), K = taps x Cp. A 128-thread block computes a
// 64 x 64 tile, each of its four warps 32 x 32 as 2 x 4 mma.sync m16n8k32.
// Per k-step (one tap, 32 channels) every thread loads 16 bytes of A and 16
// of B into registers, which go to shared memory at the next step while the
// tensor cores work on the current one.
// ---------------------------------------------------------------------------
constexpr int kTileM = 64, kTileN = 64, kTileK = 32;
constexpr int kConvThreads = 128;
constexpr int kRowBytes = 48;  // 32 bytes of k padded: fragment reads hit 32 banks

struct ConvArgs {
  const int8_t* xq;
  const int8_t* w;
  const float* scale;
  const float* bias;
  float* y;
  long long* psum;
  long long* psq;
  int Hp, Wp, Cp, R, T, kw, stride, Ho, Wo, Co, tiles;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kPhases>
__global__ void __launch_bounds__(kConvThreads) conv_kernel(ConvArgs p) {
  __shared__ __align__(16) uint8_t As[2][kTileM * kRowBytes];
  __shared__ __align__(16) uint8_t Bs[2][kTileN * kRowBytes];
  __shared__ long long red_s[2][kTileN], red_q[2][kTileN];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int warp_m = warp / 2, warp_n = warp % 2;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  const int hw = p.Ho * p.Wo;

  // this thread's load slots: row tid/2 of the A and B tiles, 16 bytes each
  const int lrow = tid / 2, lhalf = (tid % 2) * 16;
  const int m_ld = m0 + lrow, n_ld = n0 + lrow;
  const bool a_ok = m_ld < hw, b_ok = n_ld < p.R;
  const int8_t* a_base = p.xq;
  if (a_ok) {
    const int oy = m_ld / p.Wo, ox = m_ld % p.Wo;
    a_base += ((static_cast<int64_t>(b) * p.Hp + oy * p.stride) * p.Wp + ox * p.stride) *
                  p.Cp + lhalf;
  }
  const int8_t* b_base = p.w + (b_ok ? static_cast<int64_t>(n_ld) * p.T * p.Cp + lhalf : 0);
  const int csteps = p.Cp / kTileK;
  const int steps = p.T * csteps;

  auto load = [&](int s, uint4& ra, uint4& rb) {
    const int tap = s / csteps, c0 = (s % csteps) * kTileK;
    const int ky = tap / p.kw, kx = tap % p.kw;
    ra = a_ok ? __ldg(reinterpret_cast<const uint4*>(
                    a_base + (static_cast<int64_t>(ky) * p.Wp + kx) * p.Cp + c0))
              : make_uint4(0, 0, 0, 0);
    rb = b_ok ? __ldg(reinterpret_cast<const uint4*>(b_base + tap * p.Cp + c0))
              : make_uint4(0, 0, 0, 0);
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  uint4 ra, rb;
  load(0, ra, rb);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    *reinterpret_cast<uint4*>(&As[buf][lrow * kRowBytes + lhalf]) = ra;
    *reinterpret_cast<uint4*>(&Bs[buf][lrow * kRowBytes + lhalf]) = rb;
    __syncthreads();
    if (s + 1 < steps) load(s + 1, ra, rb);
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint8_t* r0 = &As[buf][(warp_m * 32 + mi * 16 + g) * kRowBytes + tig * 4];
      const uint8_t* r8 = r0 + 8 * kRowBytes;
      af[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
      af[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
      af[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      af[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint8_t* r0 = &Bs[buf][(warp_n * 32 + ni * 8 + g) * kRowBytes + tig * 4];
      bf[ni][0] = *reinterpret_cast<const uint32_t*>(r0);
      bf[ni][1] = *reinterpret_cast<const uint32_t*>(r0 + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
  }

  // epilogue: dequantize, store NCHW (interleaving the four phases of the
  // transposed conv), and per-column int64 partial sums of acc and acc^2
  const int out_w = kPhases ? 2 * p.Wo : p.Wo;
  const int out_hw = kPhases ? 4 * hw : hw;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + warp_n * 32 + ni * 8 + tig * 2 + j;
      long long ps = 0, pq = 0;
      if (n < p.R) {
        const float sc = p.scale[n];
        const float bi = p.bias != nullptr ? p.bias[n] : 0.f;
        int co = n, py = 0, px = 0;
        if (kPhases) {
          const int ph = n / p.Co;
          co = n - ph * p.Co;
          py = ph >> 1;
          px = ph & 1;
        }
        float* ybase = p.y + (static_cast<int64_t>(b) * p.Co + co) * out_hw;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + warp_m * 32 + mi * 16 + g + 8 * h;
            if (m < hw) {
              const int a = acc[mi][ni][2 * h + j];
              float v = __fmul_rn(__int2float_rn(a), sc);
              if (p.bias != nullptr) v = __fadd_rn(v, bi);
              const int oy = m / p.Wo, ox = m % p.Wo;
              if (kPhases) {
                ybase[static_cast<int64_t>(2 * oy + py) * out_w + 2 * ox + px] = v;
              } else {
                ybase[m] = v;
              }
              ps += a;
              pq += static_cast<long long>(a) * a;
            }
          }
        }
      }
      if (p.psum != nullptr) {
        // sum over the 8 row groups of the warp (lanes with the same tig)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          ps += __shfl_xor_sync(0xffffffffu, ps, o);
          pq += __shfl_xor_sync(0xffffffffu, pq, o);
        }
        if (g == 0) {
          const int col = warp_n * 32 + ni * 8 + tig * 2 + j;
          red_s[warp_m][col] = ps;
          red_q[warp_m][col] = pq;
        }
      }
    }
  }
  if (p.psum != nullptr) {
    __syncthreads();
    if (tid < kTileN && n0 + tid < p.R) {
      const int64_t o = (static_cast<int64_t>(b) * p.tiles + blockIdx.x) * p.R + n0 + tid;
      p.psum[o] = red_s[0][tid] + red_s[1][tid];
      p.psq[o] = red_q[0][tid] + red_q[1][tid];
    }
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
    const int row = ph * Co + co;
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

// out = x + (h * a + b), per-(sample, channel) a and b
__global__ void residual_kernel(const float* __restrict__ x, const float* __restrict__ h,
                                const float* __restrict__ a, const float* __restrict__ b,
                                float* __restrict__ out, int64_t n, int64_t hw) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  if (hw % 4 == 0) {
    const int64_t bc = i / hw;
    const float av = a[bc], bv = b[bc];
    const float4 xv = *reinterpret_cast<const float4*>(x + i);
    const float4 hv = *reinterpret_cast<const float4*>(h + i);
    float4 o;
    o.x = __fadd_rn(xv.x, __fadd_rn(__fmul_rn(hv.x, av), bv));
    o.y = __fadd_rn(xv.y, __fadd_rn(__fmul_rn(hv.y, av), bv));
    o.z = __fadd_rn(xv.z, __fadd_rn(__fmul_rn(hv.z, av), bv));
    o.w = __fadd_rn(xv.w, __fadd_rn(__fmul_rn(hv.w, av), bv));
    *reinterpret_cast<float4*>(out + i) = o;
  } else {
    for (int64_t k = i; k < i + 4 && k < n; ++k) {
      const int64_t bc = k / hw;
      out[k] = __fadd_rn(x[k], __fadd_rn(__fmul_rn(h[k], a[bc]), b[bc]));
    }
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// x: (B, C, H, W) f32; out: (B, Hp, Wp, Cp) int8 (Cp a multiple of 32);
// inv_sx: one f32 on the device; pa, pb: (B, C) f32 or null.
extern "C" int mt_int8_quant_pad(const void* x, void* out, const void* inv_sx, const void* pa,
                                 const void* pb, int relu, float alpha, int64_t B, int64_t C,
                                 int64_t H, int64_t W, int64_t Cp, int64_t Hp, int64_t Wp,
                                 int64_t pt, int64_t pl, int reflect, void* stream) {
  if (Cp % kQT != 0 || B * (Cp / kQT) >= (1 << 30) || Hp >= 65536) return cudaErrorInvalidValue;
  const int cblocks = static_cast<int>(Cp / kQT);
  dim3 grid(static_cast<unsigned>((Wp + kQT - 1) / kQT), static_cast<unsigned>(Hp),
            static_cast<unsigned>(B * cblocks));
  if (B > 0 && Hp > 0 && Wp > 0) {
    quant_pad_kernel<<<grid, dim3(kQT, 8), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(out),
        static_cast<const float*>(inv_sx), static_cast<const float*>(pa),
        static_cast<const float*>(pb), relu, alpha, static_cast<int>(C), static_cast<int>(H),
        static_cast<int>(W), static_cast<int>(Cp), static_cast<int>(Hp), static_cast<int>(Wp),
        static_cast<int>(pt), static_cast<int>(pl), reflect, cblocks);
  }
  return last_error();
}

// xq: (B, Hp, Wp, Cp) int8; w: (R, T, Cp) int8; scale, bias: (R,) f32 (bias
// may be null); y: (B, Co, Ho, Wo) f32, or (B, Co, 2Ho, 2Wo) when phases
// (R = 4 Co, row n = phase * Co + co); psum, psq: (B, tiles, R) int64 or null.
extern "C" int mt_int8_conv(const void* xq, const void* w, const void* scale, const void* bias,
                            void* y, void* psum, void* psq, int64_t B, int64_t Hp, int64_t Wp,
                            int64_t Cp, int64_t R, int64_t T, int64_t kw, int64_t stride,
                            int64_t Ho, int64_t Wo, int64_t Co, int phases, void* stream) {
  if (Cp % kTileK != 0 || B >= 65536 || (R + kTileN - 1) / kTileN >= 65536)
    return cudaErrorInvalidValue;
  ConvArgs a;
  a.xq = static_cast<const int8_t*>(xq);
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<float*>(y);
  a.psum = static_cast<long long*>(psum);
  a.psq = static_cast<long long*>(psq);
  a.Hp = static_cast<int>(Hp);
  a.Wp = static_cast<int>(Wp);
  a.Cp = static_cast<int>(Cp);
  a.R = static_cast<int>(R);
  a.T = static_cast<int>(T);
  a.kw = static_cast<int>(kw);
  a.stride = static_cast<int>(stride);
  a.Ho = static_cast<int>(Ho);
  a.Wo = static_cast<int>(Wo);
  a.Co = static_cast<int>(Co);
  a.tiles = static_cast<int>((Ho * Wo + kTileM - 1) / kTileM);
  dim3 grid(static_cast<unsigned>(a.tiles), static_cast<unsigned>((R + kTileN - 1) / kTileN),
            static_cast<unsigned>(B));
  if (B > 0 && a.tiles > 0) {
    auto st = static_cast<cudaStream_t>(stream);
    if (phases) {
      conv_kernel<true><<<grid, kConvThreads, 0, st>>>(a);
    } else {
      conv_kernel<false><<<grid, kConvThreads, 0, st>>>(a);
    }
  }
  return last_error();
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

// x, h, out: (planes, hw) f32; a, b: (planes,) f32. x and h 16-byte aligned.
extern "C" int mt_int8_residual(const void* x, const void* h, const void* a, const void* b,
                                void* out, int64_t planes, int64_t hw, void* stream) {
  const int64_t n = planes * hw;
  const int64_t threads = (n + 3) / 4;
  if ((threads + 255) / 256 >= (1LL << 31)) return cudaErrorInvalidValue;
  if (n > 0) {
    residual_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(h), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(out), n, hw);
  }
  return last_error();
}
