// The whole residual block of the training step, forward and backward:
//
//   out = x + norm2(conv2(act(norm1(conv1(pad(x)))))),
//   norm_i(h) = (1 + gamma) * (h - mean_i) * rstd_i + beta
//
// with centered two-pass statistics over the stored (rounded) conv outputs,
// gamma and beta shared by both norms, act relu or nothing.
//
// Replaces masterthesis_tpu/ops/pallas/resblock_bf16.py:
//   pallas_resblock_fwd (:309) -> pad(x), conv, stats, pad(norm1 + relu),
//                                 conv, stats, residual          (7 launches)
//   pallas_resblock_bwd (:568) -> norm2 sums, norm2 apply (dh2, padded by 2),
//                                 pad(a1), wgrad + reduce (dW2), conv (dgrad
//                                 of dh2 with flipT(W2)), norm1 sums (pad
//                                 adjoint folded in, relu mask), norm1 apply,
//                                 pad(x), wgrad + reduce (dW1), conv (dgrad),
//                                 dx = g + folded dgrad           (13 launches)
// The wrappers are masterthesis_tpu_torch/ops/kernels/resblock_train.py,
// whose plain versions do the same arithmetic with torch ops.
//
// Bound. At the flagship's (16, 256, 64, 64) bf16 each 3x3 conv is 77.3
// GFLOP: the forward (2 convs) takes at least 0.156 ms at the 989 TFLOP/s
// bf16 dense peak, the backward (2 dgrads, 2 wgrads) 0.31 ms; their bytes
// (about 5 and 8 activations of 33.5 MB) take less, so both are bound by
// operations. The TPU kernel holds an image's padded buffers in VMEM (about
// 2.4 MB each); a Hopper block has 227 KB of shared memory, so here every
// intermediate goes through device memory, in NHWC, and the kernel is a
// sequence of launches. This first version is simple and right: one
// implicit-GEMM template (mma.sync m16n8k16 bf16 -> f32, 64 x 64 tiles, 128
// threads, double-buffered through registers, as csrc/int8_conv.cu) serves
// conv1, conv2 and both dgrads (a full correlation over dh zero-padded by 2);
// one wgrad GEMM sums over the pixels in per-block partials that a second
// pass adds in a fixed order. No float atomics: every run gives the same
// bits. In f32 (for the comparisons on the card) the same tiles run on the
// CUDA cores.
//
// Numerics, as ref_resblock_aux and its VJP: the convs take T operands and
// accumulate in f32; h1, h2, dh1, dh2 and the dgrad outputs are stored in T
// (the backward casts dh and the full-correlation output before the pad
// adjoint, as the TPU kernel does); statistics and the norm backward's sums
// are f64 sums of f32 terms, rounded once; the elementwise steps use
// __fmul_rn / __fadd_rn (no FMA contraction), as torch's separate ops do.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kIsBf16 = sizeof(T) == 2;

__device__ __forceinline__ int reflect_index(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[mt::Vec<T>::kElems]) {
  mt::Vec<T>::unpack(*reinterpret_cast<const uint4*>(p), f);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[mt::Vec<T>::kElems]) {
  *reinterpret_cast<uint4*>(p) = mt::Vec<T>::pack(f);
}

// a = (1 + gamma) * rstd, b = beta - mean * a for one (sample, channel)
__device__ __forceinline__ void norm_affine(const float* mean, const float* rstd,
                                            const float* gamma, const float* beta, int64_t i,
                                            float& a, float& b) {
  a = __fmul_rn(__fadd_rn(1.f, gamma[i]), rstd[i]);
  b = __fsub_rn(beta[i], __fmul_rn(mean[i], a));
}

// ---------------------------------------------------------------------------
// pad: (B, H, W, C) -> (B, H+2, W+2, C), reflect or zero, optionally through
// the norm affine and relu first (a1 = relu(norm1(h1)), rounded to T). One
// thread per 16-byte vector of channels.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void pad_kernel(const T* __restrict__ src, T* __restrict__ dst,
                           const float* __restrict__ mean, const float* __restrict__ rstd,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           int relu, int H, int W, int C, int reflect, int64_t total) {
  constexpr int V = mt::Vec<T>::kElems;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cvs = C / V;
  const int cv = static_cast<int>(i % cvs);
  int64_t pix = i / cvs;
  const int xp = static_cast<int>(pix % (W + 2));
  pix /= (W + 2);
  const int yp = static_cast<int>(pix % (H + 2));
  const int b = static_cast<int>(pix / (H + 2));
  int y = yp - 1, x = xp - 1;
  float v[V];
  const bool inside = y >= 0 && y < H && x >= 0 && x < W;
  if (!inside && !reflect) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = 0.f;
  } else {
    y = reflect_index(y, H);
    x = reflect_index(x, W);
    load_vec(src + ((static_cast<int64_t>(b) * H + y) * W + x) * C + cv * V, v);
    if (mean != nullptr) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float a, bb;
        norm_affine(mean, rstd, gamma, beta, static_cast<int64_t>(b) * C + cv * V + e, a, bb);
        v[e] = __fadd_rn(__fmul_rn(v[e], a), bb);
        if (relu) v[e] = fmaxf(v[e], 0.f);
      }
    }
  }
  store_vec(dst + i * V, v);
}

// ---------------------------------------------------------------------------
// the conv: out[b, oy, ox, n] = sum_{ky, kx, c} in[b, oy + ky, ox + kx, c] *
// w[n, 3 ky + kx, c] over a padded NHWC input (B, Ho + 2, Wo + 2, C). M =
// output pixels of one image, N = output channels, K = 9 taps x C. A
// 128-thread block computes a 64 x 64 tile, each of its four warps 32 x 32;
// per k-step (one tap, 32 bytes of channels) every thread loads 16 bytes of
// A and 16 of B into registers, which go to shared memory at the next step
// while the tensor cores work on the current one.
// ---------------------------------------------------------------------------
constexpr int kTileM = 64, kTileN = 64;
constexpr int kThreads = 128;
constexpr int kRowBytes = 48;  // 32 bytes of k padded: fragment reads hit 32 banks

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct ConvArgs {
  const void* in;
  const void* w;
  void* out;
  int Hp, Wp, C, N, Ho, Wo;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) conv_kernel(ConvArgs p) {
  constexpr int KT = 32 / sizeof(T);  // k elements per step
  __shared__ __align__(16) uint8_t As[2][kTileM * kRowBytes];
  __shared__ __align__(16) uint8_t Bs[2][kTileN * kRowBytes];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int warp_m = warp / 2, warp_n = warp % 2;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  const int hw = p.Ho * p.Wo;

  // this thread's load slots: row tid/2 of the A and B tiles, 16 bytes each
  const int lrow = tid / 2, lhalf = (tid % 2) * 16;
  const int m_ld = m0 + lrow, n_ld = n0 + lrow;
  const bool a_ok = m_ld < hw, b_ok = n_ld < p.N;
  const uint8_t* a_base = static_cast<const uint8_t*>(p.in) + lhalf;
  if (a_ok) {
    const int oy = m_ld / p.Wo, ox = m_ld % p.Wo;
    a_base += ((static_cast<int64_t>(b) * p.Hp + oy) * p.Wp + ox) * p.C * sizeof(T);
  }
  const uint8_t* b_base = static_cast<const uint8_t*>(p.w) + lhalf +
                          (b_ok ? static_cast<int64_t>(n_ld) * 9 * p.C * sizeof(T) : 0);
  const int csteps = p.C / KT;
  const int steps = 9 * csteps;

  auto load = [&](int s, uint4& ra, uint4& rb) {
    const int tap = s / csteps, c0 = (s % csteps) * KT;
    const int ky = tap / 3, kx = tap % 3;
    ra = a_ok ? __ldg(reinterpret_cast<const uint4*>(
                    a_base + (static_cast<int64_t>(ky * p.Wp + kx) * p.C + c0) * sizeof(T)))
              : make_uint4(0, 0, 0, 0);
    rb = b_ok ? __ldg(reinterpret_cast<const uint4*>(
                    b_base + (static_cast<int64_t>(tap) * p.C + c0) * sizeof(T)))
              : make_uint4(0, 0, 0, 0);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  uint4 ra, rb;
  load(0, ra, rb);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    *reinterpret_cast<uint4*>(&As[buf][lrow * kRowBytes + lhalf]) = ra;
    *reinterpret_cast<uint4*>(&Bs[buf][lrow * kRowBytes + lhalf]) = rb;
    __syncthreads();
    if (s + 1 < steps) load(s + 1, ra, rb);
    if constexpr (kIsBf16<T>) {
      // the m16n8k16 bf16 fragments sit at the same bytes as int8_conv.cu's
      // m16n8k32 int8 ones: two k values per 32-bit register
      uint32_t af[2][4], bfr[4][2];
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
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(r0);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    } else {
      // f32: the same output fragments, on the CUDA cores
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* ar = reinterpret_cast<const float*>(
              &As[buf][(warp_m * 32 + mi * 16 + g + 8 * h) * kRowBytes]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float* br = reinterpret_cast<const float*>(
                  &Bs[buf][(warp_n * 32 + ni * 8 + tig * 2 + j) * kRowBytes]);
              float sacc = acc[mi][ni][2 * h + j];
#pragma unroll
              for (int k = 0; k < KT; ++k) sacc = fmaf(ar[k], br[k], sacc);
              acc[mi][ni][2 * h + j] = sacc;
            }
        }
    }
  }

  // epilogue: round to T, store NHWC, two neighbouring channels per store
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp_m * 32 + mi * 16 + g + 8 * h;
      if (m >= hw) continue;
      T* orow = out + (static_cast<int64_t>(b) * hw + m) * p.N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + warp_n * 32 + ni * 8 + tig * 2;
        if (n < p.N) store2(orow + n, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// wgrad: part[s, t, co, ci] = sum over the pixels P of split s of
// d[P, co] * a[P + tap t, ci], with d = dh zero-padded by 2 (B, H+4, W+4, Co)
// and a the conv's padded input (B, H+2, W+2, Ci). M = Co, N = Ci, K =
// pixels; the tiles are loaded pixel-major, as they lie in memory, and the
// fragments read across rows.
// ---------------------------------------------------------------------------
struct WgradArgs {
  const void* a;
  const void* d;
  float* part;
  int H, W, Ci, Co, chunk;
  int64_t pixels;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(WgradArgs p) {
  constexpr int KT = 32 / sizeof(T);                 // pixels per step
  constexpr int kPitch = kTileM * sizeof(T) + 16;    // bytes per pixel row, padded
  constexpr int kChunks = kTileM * sizeof(T) / 16;   // 16-byte loads per row
  __shared__ __align__(16) uint8_t As[2][KT * kPitch];
  __shared__ __align__(16) uint8_t Bs[2][KT * kPitch];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int warp_m = warp / 2, warp_n = warp % 2;
  const int ci0 = blockIdx.x * kTileN, co0 = blockIdx.y * kTileM;
  const int tap = blockIdx.z % 9, split = blockIdx.z / 9;
  const int ty = tap / 3, tx = tap % 3;
  const int64_t p_begin = static_cast<int64_t>(split) * p.chunk;
  const int64_t p_end = p_begin + p.chunk < p.pixels ? p_begin + p.chunk : p.pixels;
  const int hw = p.H * p.W;
  const int steps = static_cast<int>((p_end - p_begin + KT - 1) / KT);

  const int lrow = tid / kChunks, lchunk = tid % kChunks;
  const T* dptr = static_cast<const T*>(p.d);
  const T* aptr = static_cast<const T*>(p.a);
  auto load = [&](int s, uint4& ra, uint4& rb) {
    const int64_t P = p_begin + static_cast<int64_t>(s) * KT + lrow;
    if (P < p_end) {
      const int b = static_cast<int>(P / hw), r = static_cast<int>(P % hw);
      const int y = r / p.W, x = r % p.W;
      ra = __ldg(reinterpret_cast<const uint4*>(
          dptr + ((static_cast<int64_t>(b) * (p.H + 4) + y + 2) * (p.W + 4) + x + 2) * p.Co +
          co0 + lchunk * (16 / sizeof(T))));
      rb = __ldg(reinterpret_cast<const uint4*>(
          aptr + ((static_cast<int64_t>(b) * (p.H + 2) + y + ty) * (p.W + 2) + x + tx) * p.Ci +
          ci0 + lchunk * (16 / sizeof(T))));
    } else {
      ra = make_uint4(0, 0, 0, 0);
      rb = make_uint4(0, 0, 0, 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  uint4 ra, rb;
  if (steps > 0) load(0, ra, rb);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    *reinterpret_cast<uint4*>(&As[buf][lrow * kPitch + lchunk * 16]) = ra;
    *reinterpret_cast<uint4*>(&Bs[buf][lrow * kPitch + lchunk * 16]) = rb;
    __syncthreads();
    if (s + 1 < steps) load(s + 1, ra, rb);
    if constexpr (kIsBf16<T>) {
      const uint16_t* A16 = reinterpret_cast<const uint16_t*>(As[buf]);
      const uint16_t* B16 = reinterpret_cast<const uint16_t*>(Bs[buf]);
      constexpr int P16 = kPitch / 2;
      // element (k, m) of a tile is at [k * P16 + m]; a register holds the
      // pair (k, k + 1) of one m, the lower k in the lower half
      auto pair = [&](const uint16_t* t, int k, int m) {
        return static_cast<uint32_t>(t[k * P16 + m]) |
               (static_cast<uint32_t>(t[(k + 1) * P16 + m]) << 16);
      };
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m = warp_m * 32 + mi * 16 + g;
        af[mi][0] = pair(A16, 2 * tig, m);
        af[mi][1] = pair(A16, 2 * tig, m + 8);
        af[mi][2] = pair(A16, 2 * tig + 8, m);
        af[mi][3] = pair(A16, 2 * tig + 8, m + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = warp_n * 32 + ni * 8 + g;
        bfr[ni][0] = pair(B16, 2 * tig, n);
        bfr[ni][1] = pair(B16, 2 * tig + 8, n);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    } else {
      const float* A32 = reinterpret_cast<const float*>(As[buf]);
      const float* B32 = reinterpret_cast<const float*>(Bs[buf]);
      constexpr int P32 = kPitch / 4;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = warp_m * 32 + mi * 16 + g + 8 * h;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int n = warp_n * 32 + ni * 8 + tig * 2 + j;
              float sacc = acc[mi][ni][2 * h + j];
#pragma unroll
              for (int k = 0; k < KT; ++k) sacc = fmaf(A32[k * P32 + m], B32[k * P32 + n], sacc);
              acc[mi][ni][2 * h + j] = sacc;
            }
        }
    }
  }

  float* part = p.part + (static_cast<int64_t>(split) * 9 + tap) * p.Co * p.Ci;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + warp_m * 32 + mi * 16 + g + 8 * h;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int ci = ci0 + warp_n * 32 + ni * 8 + tig * 2;
        store2(part + static_cast<int64_t>(co) * p.Ci + ci, acc[mi][ni][2 * h],
               acc[mi][ni][2 * h + 1]);
      }
    }
}

// dW (Co, Ci, 3, 3) f32 = sum over the splits, in order, of the partials
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int splits, int Co, int Ci) {
  const int64_t n = 9LL * Co * Ci;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;  // i runs over (t, co, ci), as the partials lie
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * n + i];
  const int t = static_cast<int>(i / (static_cast<int64_t>(Co) * Ci));
  const int64_t rem = i % (static_cast<int64_t>(Co) * Ci);
  out[rem * 9 + t] = s;  // rem = co * Ci + ci
}

// ---------------------------------------------------------------------------
// Per-(sample, channel) reductions over the pixels. A block (8, 32) owns 8
// 16-byte vectors of channels of one sample; its 32 rows stride over the
// pixels, and the rows' f64 partials are added in a fixed order.
// ---------------------------------------------------------------------------
constexpr int kRedX = 8, kRedY = 32;

template <int V>
__device__ __forceinline__ void block_rows_sum(double (&s)[V], double (*scratch)[kRedX * V]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int e = 0; e < V; ++e) scratch[ty][tx * V + e] = s[e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < V; ++e) {
    double t = 0.0;
    for (int r = 0; r < kRedY; ++r) t += scratch[r][tx * V + e];
    s[e] = t;
  }
  __syncthreads();
}

// mean and rstd of h (B, HW, C): centered, f64 sums of the f32 values
template <typename T>
__global__ void __launch_bounds__(kRedX * kRedY)
    stats_kernel(const T* __restrict__ h, float* __restrict__ mean, float* __restrict__ rstd,
                 int HW, int C, float eps) {
  constexpr int V = mt::Vec<T>::kElems;
  __shared__ double scratch[kRedY][kRedX * V];
  const int b = blockIdx.y;
  const int c0 = (blockIdx.x * kRedX + threadIdx.x) * V;
  const bool ok = c0 < C;
  const T* base = h + static_cast<int64_t>(b) * HW * C + c0;
  double s[V], q[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = q[e] = 0.0;
  if (ok) {
    for (int p = threadIdx.y; p < HW; p += kRedY) {
      float v[V];
      load_vec(base + static_cast<int64_t>(p) * C, v);
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] += v[e];
    }
  }
  block_rows_sum<V>(s, scratch);
  double m[V];
#pragma unroll
  for (int e = 0; e < V; ++e) m[e] = s[e] / HW;
  if (ok) {
    for (int p = threadIdx.y; p < HW; p += kRedY) {
      float v[V];
      load_vec(base + static_cast<int64_t>(p) * C, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const double d = v[e] - m[e];
        q[e] += d * d;
      }
    }
  }
  block_rows_sum<V>(q, scratch);
  if (ok && threadIdx.y == 0) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int64_t i = static_cast<int64_t>(b) * C + c0 + e;
      mean[i] = __double2float_rn(m[e]);
      const float var = __double2float_rn(q[e] / HW);
      rstd[i] = __double2float_rn(1.0 / sqrt(static_cast<double>(__fadd_rn(var, eps))));
    }
  }
}

// The upstream gradient d of a norm at core pixel (y, x), V channels from c0:
// g itself, or (folded) the pad adjoint of P (B, H+2, W+2, C), the dgrad of
// the next conv: with reflect padding the border rows and columns fold back
// onto the reflected interior ones (padded row 0 onto core row 1, row H+1
// onto row H-2; columns alike, separably); with zero padding the border
// drops. P's values are T; the fold sums them in f32.
template <typename T>
__device__ __forceinline__ void load_d(float (&d)[mt::Vec<T>::kElems], const T* src, bool folded,
                                       bool reflect, int b, int y, int x, int H, int W, int C,
                                       int c0) {
  constexpr int V = mt::Vec<T>::kElems;
  if (!folded) {
    load_vec(src + ((static_cast<int64_t>(b) * H + y) * W + x) * C + c0, d);
    return;
  }
  int rows[3] = {y + 1, -1, -1}, cols[3] = {x + 1, -1, -1};
  if (reflect) {
    if (y == 1) rows[1] = 0;
    if (y == H - 2) rows[2] = H + 1;
    if (x == 1) cols[1] = 0;
    if (x == W - 2) cols[2] = W + 1;
  }
  // each row's columns first, then the rows: the association of the plain
  // version's column fold followed by its row fold
#pragma unroll
  for (int e = 0; e < V; ++e) d[e] = 0.f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (rows[r] < 0) continue;
    float row[V];
#pragma unroll
    for (int e = 0; e < V; ++e) row[e] = 0.f;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (cols[q] < 0) continue;
      float v[V];
      load_vec(src + ((static_cast<int64_t>(b) * (H + 2) + rows[r]) * (W + 2) + cols[q]) * C + c0,
               v);
#pragma unroll
      for (int e = 0; e < V; ++e) row[e] = __fadd_rn(row[e], v[e]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) d[e] = __fadd_rn(d[e], row[e]);
  }
}

struct NormBwdArgs {
  const void* src;  // g (B, H, W, C), or P (B, H+2, W+2, C) when folded
  const void* h;    // the norm's input (B, H, W, C)
  const float *mean, *rstd, *gamma, *beta;
  const float *s1, *s2;  // the sums (apply only)
  float *o1, *o2;        // the sums (sums only)
  void* dst;             // dh, (B, H+4, W+4, C) (apply only)
  int H, W, C, folded, reflect, relu;
};

// d, masked by the forward's relu (n1 = h * a + b > 0) when relu, and
// yhat = (h - mean) * rstd, for V channels
template <typename T>
__device__ __forceinline__ void d_and_yhat(const NormBwdArgs& p, int b, int y, int x, int c0,
                                           float (&d)[mt::Vec<T>::kElems],
                                           float (&yh)[mt::Vec<T>::kElems]) {
  constexpr int V = mt::Vec<T>::kElems;
  load_d<T>(d, static_cast<const T*>(p.src), p.folded, p.reflect, b, y, x, p.H, p.W, p.C, c0);
  float hv[V];
  load_vec(static_cast<const T*>(p.h) + ((static_cast<int64_t>(b) * p.H + y) * p.W + x) * p.C + c0,
           hv);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int64_t i = static_cast<int64_t>(b) * p.C + c0 + e;
    yh[e] = __fmul_rn(__fsub_rn(hv[e], p.mean[i]), p.rstd[i]);
    if (p.relu) {
      float a, bb;
      norm_affine(p.mean, p.rstd, p.gamma, p.beta, i, a, bb);
      if (!(__fadd_rn(__fmul_rn(hv[e], a), bb) > 0.f)) d[e] = 0.f;
    }
  }
}

// pass A of a norm's backward: o1 = sum d, o2 = sum d * yhat per (b, c)
template <typename T>
__global__ void __launch_bounds__(kRedX * kRedY) norm_bwd_sums_kernel(NormBwdArgs p) {
  constexpr int V = mt::Vec<T>::kElems;
  __shared__ double scratch[kRedY][kRedX * V];
  const int b = blockIdx.y;
  const int c0 = (blockIdx.x * kRedX + threadIdx.x) * V;
  const bool ok = c0 < p.C;
  double s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.0;
  if (ok) {
    const int hw = p.H * p.W;
    for (int q = threadIdx.y; q < hw; q += kRedY) {
      float d[V], yh[V];
      d_and_yhat<T>(p, b, q / p.W, q % p.W, c0, d, yh);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s1[e] += d[e];
        s2[e] += static_cast<double>(d[e]) * yh[e];
      }
    }
  }
  block_rows_sum<V>(s1, scratch);
  block_rows_sum<V>(s2, scratch);
  if (ok && threadIdx.y == 0) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int64_t i = static_cast<int64_t>(b) * p.C + c0 + e;
      p.o1[i] = __double2float_rn(s1[e]);
      p.o2[i] = __double2float_rn(s2[e]);
    }
  }
}

// pass B: dh = (1 + gamma) * rstd * (d - s1/n - yhat * s2/n), rounded to T,
// into dh zero-padded by 2 (the border written as zeros)
template <typename T>
__global__ void norm_bwd_apply_kernel(NormBwdArgs p, int64_t total) {
  constexpr int V = mt::Vec<T>::kElems;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cvs = p.C / V;
  const int c0 = static_cast<int>(i % cvs) * V;
  int64_t pix = i / cvs;
  const int x = static_cast<int>(pix % (p.W + 4)) - 2;
  pix /= (p.W + 4);
  const int y = static_cast<int>(pix % (p.H + 4)) - 2;
  const int b = static_cast<int>(pix / (p.H + 4));
  float out[V];
  if (y < 0 || y >= p.H || x < 0 || x >= p.W) {
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = 0.f;
  } else {
    float d[V], yh[V];
    d_and_yhat<T>(p, b, y, x, c0, d, yh);
    const float n = static_cast<float>(p.H * p.W);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int64_t k = static_cast<int64_t>(b) * p.C + c0 + e;
      const float coef = __fmul_rn(__fadd_rn(1.f, p.gamma[k]), p.rstd[k]);
      const float t = __fsub_rn(__fsub_rn(d[e], __fdiv_rn(p.s1[k], n)),
                                __fmul_rn(yh[e], __fdiv_rn(p.s2[k], n)));
      out[e] = __fmul_rn(coef, t);
    }
  }
  store_vec(static_cast<T*>(p.dst) + i * V, out);
}

// out = x + h * a + b with the norm affine of (mean, rstd, gamma, beta)
template <typename T>
__global__ void residual_kernel(const T* __restrict__ x, const T* __restrict__ h,
                                const float* __restrict__ mean, const float* __restrict__ rstd,
                                const float* __restrict__ gamma, const float* __restrict__ beta,
                                T* __restrict__ out, int HW, int C, int64_t total) {
  constexpr int V = mt::Vec<T>::kElems;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cvs = C / V;
  const int c0 = static_cast<int>(i % cvs) * V;
  const int b = static_cast<int>(i / cvs / HW);
  float xv[V], hv[V];
  load_vec(x + i * V, xv);
  load_vec(h + i * V, hv);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float a, bb;
    norm_affine(mean, rstd, gamma, beta, static_cast<int64_t>(b) * C + c0 + e, a, bb);
    xv[e] = __fadd_rn(xv[e], __fadd_rn(__fmul_rn(hv[e], a), bb));
  }
  store_vec(out + i * V, xv);
}

// dx = g + the pad adjoint of P (B, H+2, W+2, C), rounded to T
template <typename T>
__global__ void dx_kernel(const T* __restrict__ g, const T* __restrict__ P, T* __restrict__ out,
                          int H, int W, int C, int reflect, int64_t total) {
  constexpr int V = mt::Vec<T>::kElems;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cvs = C / V;
  const int c0 = static_cast<int>(i % cvs) * V;
  int64_t pix = i / cvs;
  const int x = static_cast<int>(pix % W);
  pix /= W;
  const int y = static_cast<int>(pix % H);
  const int b = static_cast<int>(pix / H);
  float gv[V], d[V];
  load_vec(g + i * V, gv);
  load_d<T>(d, P, true, reflect, b, y, x, H, W, C, c0);
#pragma unroll
  for (int e = 0; e < V; ++e) gv[e] = __fadd_rn(gv[e], d[e]);
  store_vec(out + i * V, gv);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

constexpr int kEltThreads = 256;

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kEltThreads - 1) / kEltThreads); }

template <typename T>
int pad(const void* src, void* dst, const void* mean, const void* rstd, const void* gamma,
        const void* beta, int relu, int64_t B, int64_t H, int64_t W, int64_t C, int reflect,
        void* stream) {
  const int64_t total = B * (H + 2) * (W + 2) * (C / mt::Vec<T>::kElems);
  if (C % mt::Vec<T>::kElems || (total + kEltThreads - 1) / kEltThreads >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (total > 0)
    pad_kernel<T><<<blocks_for(total), kEltThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), relu, static_cast<int>(H), static_cast<int>(W),
        static_cast<int>(C), reflect, total);
  return last_error();
}

template <typename T>
int conv(const void* in, const void* w, void* out, int64_t B, int64_t Hp, int64_t Wp, int64_t C,
         int64_t N, void* stream) {
  if (C % (32 / sizeof(T)) || N % 2 || B >= 65536 || (N + kTileN - 1) / kTileN >= 65536 ||
      Hp < 3 || Wp < 3)
    return cudaErrorInvalidValue;
  ConvArgs a{in, w, out, static_cast<int>(Hp), static_cast<int>(Wp), static_cast<int>(C),
             static_cast<int>(N), static_cast<int>(Hp - 2), static_cast<int>(Wp - 2)};
  const int64_t tiles = ((Hp - 2) * (Wp - 2) + kTileM - 1) / kTileM;
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>((N + kTileN - 1) / kTileN),
            static_cast<unsigned>(B));
  if (B > 0) conv_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return last_error();
}

template <typename T>
int stats(const void* h, void* mean, void* rstd, int64_t B, int64_t HW, int64_t C, float eps,
          void* stream) {
  constexpr int V = mt::Vec<T>::kElems;
  if (C % V || B >= 65536) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>((C / V + kRedX - 1) / kRedX), static_cast<unsigned>(B));
  if (B > 0 && C > 0)
    stats_kernel<T><<<grid, dim3(kRedX, kRedY), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(h), static_cast<float*>(mean), static_cast<float*>(rstd),
        static_cast<int>(HW), static_cast<int>(C), eps);
  return last_error();
}

template <typename T>
int norm_bwd(const void* src, int folded, int reflect, const void* h, const void* mean,
             const void* rstd, const void* gamma, const void* beta, int relu, void* s1, void* s2,
             void* dst, int64_t B, int64_t H, int64_t W, int64_t C, void* stream) {
  constexpr int V = mt::Vec<T>::kElems;
  if (C % V || B >= 65536 || H < 2 || W < 2) return cudaErrorInvalidValue;
  NormBwdArgs p{src, h,
                static_cast<const float*>(mean), static_cast<const float*>(rstd),
                static_cast<const float*>(gamma), static_cast<const float*>(beta),
                static_cast<const float*>(s1), static_cast<const float*>(s2),
                static_cast<float*>(s1), static_cast<float*>(s2), dst,
                static_cast<int>(H), static_cast<int>(W), static_cast<int>(C),
                folded, reflect, relu};
  auto st = static_cast<cudaStream_t>(stream);
  if (B == 0 || C == 0) return last_error();
  if (dst == nullptr) {
    dim3 grid(static_cast<unsigned>((C / V + kRedX - 1) / kRedX), static_cast<unsigned>(B));
    norm_bwd_sums_kernel<T><<<grid, dim3(kRedX, kRedY), 0, st>>>(p);
  } else {
    const int64_t total = B * (H + 4) * (W + 4) * (C / V);
    if ((total + kEltThreads - 1) / kEltThreads >= (1LL << 31)) return cudaErrorInvalidValue;
    norm_bwd_apply_kernel<T><<<blocks_for(total), kEltThreads, 0, st>>>(p, total);
  }
  return last_error();
}

template <typename T>
int residual(const void* x, const void* h, const void* mean, const void* rstd, const void* gamma,
             const void* beta, void* out, int64_t B, int64_t HW, int64_t C, void* stream) {
  const int64_t total = B * HW * (C / mt::Vec<T>::kElems);
  if (C % mt::Vec<T>::kElems || (total + kEltThreads - 1) / kEltThreads >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (total > 0)
    residual_kernel<T><<<blocks_for(total), kEltThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<T*>(out), static_cast<int>(HW),
        static_cast<int>(C), total);
  return last_error();
}

template <typename T>
int wgrad(const void* a, const void* d, void* part, int64_t B, int64_t H, int64_t W, int64_t Ci,
          int64_t Co, int64_t chunk, int64_t splits, void* stream) {
  const int64_t pixels = B * H * W;
  if (Ci % kTileN || Co % kTileM || chunk <= 0 || splits * 9 >= 65536 ||
      (pixels + chunk - 1) / chunk != splits || chunk >= (1LL << 31))
    return cudaErrorInvalidValue;
  WgradArgs p{a, d, static_cast<float*>(part), static_cast<int>(H), static_cast<int>(W),
              static_cast<int>(Ci), static_cast<int>(Co), static_cast<int>(chunk), pixels};
  dim3 grid(static_cast<unsigned>(Ci / kTileN), static_cast<unsigned>(Co / kTileM),
            static_cast<unsigned>(9 * splits));
  if (splits > 0) wgrad_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return last_error();
}

template <typename T>
int dx(const void* g, const void* P, void* out, int64_t B, int64_t H, int64_t W, int64_t C,
       int reflect, void* stream) {
  const int64_t total = B * H * W * (C / mt::Vec<T>::kElems);
  if (C % mt::Vec<T>::kElems || H < 2 || W < 2 ||
      (total + kEltThreads - 1) / kEltThreads >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (total > 0)
    dx_kernel<T><<<blocks_for(total), kEltThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(g), static_cast<const T*>(P), static_cast<T*>(out),
        static_cast<int>(H), static_cast<int>(W), static_cast<int>(C), reflect, total);
  return last_error();
}

}  // namespace

// Every tensor is contiguous NHWC in T (bf16 or f32) unless said otherwise;
// statistics, norm sums and gamma/beta are (B, C) f32; every pointer is
// 16-byte aligned. Each entry point returns cudaGetLastError().
#define MT_RB_ENTRY_POINTS(SUFFIX, T)                                                          \
  /* src (B, H, W, C) -> dst (B, H+2, W+2, C); with mean != null, relu?(norm(src)) first */  \
  extern "C" int mt_rb_pad_##SUFFIX(const void* src, void* dst, const void* mean,             \
                                    const void* rstd, const void* gamma, const void* beta,    \
                                    int relu, int64_t B, int64_t H, int64_t W, int64_t C,     \
                                    int reflect, void* stream) {                              \
    return pad<T>(src, dst, mean, rstd, gamma, beta, relu, B, H, W, C, reflect, stream);     \
  }                                                                                           \
  /* in (B, Hp, Wp, C), w (N, 9, C) -> out (B, Hp-2, Wp-2, N) */                              \
  extern "C" int mt_rb_conv_##SUFFIX(const void* in, const void* w, void* out, int64_t B,     \
                                     int64_t Hp, int64_t Wp, int64_t C, int64_t N,            \
                                     void* stream) {                                          \
    return conv<T>(in, w, out, B, Hp, Wp, C, N, stream);                                      \
  }                                                                                           \
  /* h (B, HW, C) -> mean, rstd */                                                            \
  extern "C" int mt_rb_stats_##SUFFIX(const void* h, void* mean, void* rstd, int64_t B,      \
                                      int64_t HW, int64_t C, float eps, void* stream) {       \
    return stats<T>(h, mean, rstd, B, HW, C, eps, stream);                                    \
  }                                                                                           \
  /* out = x + norm(h) */                                                                     \
  extern "C" int mt_rb_residual_##SUFFIX(const void* x, const void* h, const void* mean,     \
                                         const void* rstd, const void* gamma,                 \
                                         const void* beta, void* out, int64_t B, int64_t HW,  \
                                         int64_t C, void* stream) {                           \
    return residual<T>(x, h, mean, rstd, gamma, beta, out, B, HW, C, stream);                 \
  }                                                                                           \
  /* src: g (B, H, W, C), or the dgrad P (B, H+2, W+2, C) when folded; h the norm's input. */ \
  /* dst null: the sums s1, s2 out; else dh (B, H+4, W+4, C) out from the sums s1, s2 */      \
  extern "C" int mt_rb_norm_bwd_##SUFFIX(                                                     \
      const void* src, int folded, int reflect, const void* h, const void* mean,              \
      const void* rstd, const void* gamma, const void* beta, int relu, void* s1, void* s2,    \
      void* dst, int64_t B, int64_t H, int64_t W, int64_t C, void* stream) {                  \
    return norm_bwd<T>(src, folded, reflect, h, mean, rstd, gamma, beta, relu, s1, s2, dst,   \
                       B, H, W, C, stream);                                                   \
  }                                                                                           \
  /* a (B, H+2, W+2, Ci), d (B, H+4, W+4, Co) -> part (splits, 9, Co, Ci) f32 */              \
  extern "C" int mt_rb_wgrad_##SUFFIX(const void* a, const void* d, void* part, int64_t B,   \
                                      int64_t H, int64_t W, int64_t Ci, int64_t Co,           \
                                      int64_t chunk, int64_t splits, void* stream) {          \
    return wgrad<T>(a, d, part, B, H, W, Ci, Co, chunk, splits, stream);                      \
  }                                                                                           \
  /* out = g + pad adjoint of P (B, H+2, W+2, C) */                                           \
  extern "C" int mt_rb_dx_##SUFFIX(const void* g, const void* P, void* out, int64_t B,       \
                                   int64_t H, int64_t W, int64_t C, int reflect,              \
                                   void* stream) {                                            \
    return dx<T>(g, P, out, B, H, W, C, reflect, stream);                                     \
  }

MT_RB_ENTRY_POINTS(bf16, bf16)
MT_RB_ENTRY_POINTS(f32, float)

// part (splits, 9, Co, Ci) f32 -> dW (Co, Ci, 3, 3) f32
extern "C" int mt_rb_wgrad_reduce(const void* part, void* out, int64_t splits, int64_t Co,
                                  int64_t Ci, void* stream) {
  const int64_t n = 9 * Co * Ci;
  if ((n + kEltThreads - 1) / kEltThreads >= (1LL << 31)) return cudaErrorInvalidValue;
  if (n > 0)
    wgrad_reduce_kernel<<<blocks_for(n), kEltThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(part), static_cast<float*>(out), static_cast<int>(splits),
        static_cast<int>(Co), static_cast<int>(Ci));
  return last_error();
}
