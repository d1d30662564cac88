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
//   pallas_resblock_bwd (:568) -> g to NHWC, norm2 sums, norm2 apply (dh2,
//                                 padded by 2), pad(a1), wgrad (dW2), conv
//                                 (dgrad of dh2 with flipT(W2)), norm1 sums
//                                 (pad adjoint folded in, relu mask), norm1
//                                 apply, pad(x), wgrad (dW1), conv (dgrad),
//                                 dx = g + folded dgrad          (12 launches)
// x, g, out and dx are NCHW, as the wrappers take and give them: the passes
// that touch them change the layout on the way.
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
// sequence of launches whose GEMMs are built for Hopper's tensor cores:
//
// - The conv (conv1, conv2 and both dgrads, a full correlation over dh
//   zero-padded by 2) is one implicit GEMM: M = output pixels, N = output
//   channels, K = 9 taps x C. The output is computed over the padded grid's
//   width (row m = oy * Wp + ox, ox < Wp), so for tap (ky, kx) the A rows of
//   an M-tile are one contiguous run of padded pixels from m0 + ky * Wp + kx
//   of the (B * Hp * Wp, C) view: a plain 2-D TMA box, no im2col. The
//   epilogue drops the 2 columns ox >= Wo. A 128 x 256 tile per block: two
//   consumer warpgroups each issue wgmma m64n256k16 (bf16 -> f32) from
//   shared memory; one producer warp keeps TMA loads of 64-channel k-slabs
//   (128 bytes, the width of the 128-byte swizzle) in flight through a ring
//   of 4 stages guarded by mbarriers. N = 256 is all of C, so each A tile is
//   read once; TMA's zero fill covers the over-read past the last image.
// - The wgrad dW[t, co, ci] = sum_P d[P, co] a[P + tap t, ci] (M = Co, N =
//   Ci, K = pixels) reads both operands pixel-major, as they lie: wgmma takes
//   them MN-major from shared memory (its transpose bits), fed by the same
//   TMA boxes. The conv inputs are written at the row pitch of dh's
//   padded-by-2 grid (a zero ring around the padded input), so one shift per
//   tap lines the two grids up and K sweeps dh's padded grid, whose zero
//   border cancels every position outside the core. 9 taps x 2 x 1 output
//   tiles of 128 x 256 are too few for 132 SMs, so K is split over a thread
//   block cluster of up to 8 blocks; each keeps its f32 partial in shared
//   memory and every element is summed over the blocks in rank order through
//   distributed shared memory: no partials in device memory, no atomics.
// - The per-(sample, channel) reductions (statistics, the norm backward's
//   sums) split each sample's pixels over a cluster of blocks and add the
//   blocks' f64 partials in rank order, so enough blocks run to fill the
//   card.
// No float atomics anywhere: every run gives the same bits. In f32 (for the
// comparisons on the card) the convs and the wgrad run on the CUDA cores
// (64 x 64 tiles, mma-free), the wgrad unsplit.
//
// Numerics, as ref_resblock_aux and its VJP: the convs take T operands and
// accumulate in f32; h1, h2, dh1, dh2 and the dgrad outputs are stored in T
// (the backward casts dh and the full-correlation output before the pad
// adjoint, as the TPU kernel does); statistics and the norm backward's sums
// are f64 sums of f32 terms, rounded once; the elementwise steps use
// __fmul_rn / __fadd_rn (no FMA contraction), as torch's separate ops do.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace mt::sm90;

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
// the bf16 wgmma instruction (the other Hopper primitives are in hopper.cuh)
// ---------------------------------------------------------------------------
// D (64 x 256 f32, in registers) += A (64 x 16) * B (16 x 256), bf16 operands from
// shared memory through their descriptors; TA / TB: the operand is MN-major (1)
// or K-major (0) in shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}


// ---------------------------------------------------------------------------
// pad: (B, H, W, C) -> (B, H+2+2r, W+2+2r, C), reflect or zero by 1, then a
// zero ring of r (r = 1 puts a conv input at the row pitch of dh's
// padded-by-2 grid, for the wgrad), optionally through the norm affine and
// relu first (a1 = relu(norm1(h1)), rounded to T). Block (32, 8) per output
// row: x over 16-byte vectors of channels, y over the row's pixels, so each
// thread's affine is loaded once.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
    pad_kernel(const T* __restrict__ src, T* __restrict__ dst, const float* __restrict__ mean,
               const float* __restrict__ rstd, const float* __restrict__ gamma,
               const float* __restrict__ beta, int relu, int H, int W, int C, int reflect,
               int ring) {
  constexpr int V = mt::Vec<T>::kElems;
  const int Wd = W + 2 + 2 * ring, Hd = H + 2 + 2 * ring;
  const int b = blockIdx.x / Hd, yp = blockIdx.x % Hd;
  const int y = yp - 1 - ring;
  T* row = dst + static_cast<int64_t>(blockIdx.x) * Wd * C;
  const bool row_pad = y >= -1 && y <= H;
  const T* srow = src + (static_cast<int64_t>(b) * H + (row_pad ? reflect_index(y, H) : 0)) * W * C;
  for (int cv = threadIdx.x; cv * V < C; cv += blockDim.x) {
    const int c0 = cv * V;
    float a[V], bb[V];
    if (mean != nullptr) {
#pragma unroll
      for (int e = 0; e < V; ++e) norm_affine(mean, rstd, gamma, beta, b * C + c0 + e, a[e], bb[e]);
    }
    for (int xp = threadIdx.y; xp < Wd; xp += blockDim.y) {
      const int x = xp - 1 - ring;
      const bool inside = y >= 0 && y < H && x >= 0 && x < W;
      const bool in_pad = row_pad && x >= -1 && x <= W;
      float v[V];
      if (!inside && !(reflect && in_pad)) {
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = 0.f;
      } else {
        load_vec(srow + static_cast<int64_t>(reflect_index(x, W)) * C + c0, v);
        if (mean != nullptr) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            v[e] = __fadd_rn(__fmul_rn(v[e], a[e]), bb[e]);
            if (relu) v[e] = fmaxf(v[e], 0.f);
          }
        }
      }
      store_vec(row + static_cast<int64_t>(xp) * C + c0, v);
    }
  }
}

// ---------------------------------------------------------------------------
// Passes that change the layout on the way (the wrappers' NCHW activations
// against the NHWC intermediates): a block moves a tile of 32 pixels x 64
// channels through shared memory, reading and writing each layout along its
// contiguous axis. Block (32 pixel tiles of one row or run, b or b x row,
// 64-channel group), 256 threads.
// ---------------------------------------------------------------------------
constexpr int kTileP = 32, kTileC = 64, kTileThreads = 256;

// x NCHW (B, C, H, W) -> dst NHWC (B, H+2h+2r, W+2h+2r, C): reflect or zero by
// the halo h (1, or 0 for a plain copy), then a zero ring of r; block (b x
// output row, column tile, channel group)
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    pad_nchw_kernel(const T* __restrict__ src, T* __restrict__ dst, int H, int W, int C,
                    int reflect, int halo, int ring) {
  constexpr int V = mt::Vec<T>::kElems;
  __shared__ float tile[kTileC][kTileP + 1];
  const int Wd = W + 2 * (halo + ring), Hd = H + 2 * (halo + ring);
  const int x0 = blockIdx.y * kTileP, c0 = blockIdx.z * kTileC;
  const int b = blockIdx.x / Hd, yp = blockIdx.x % Hd;
  const int y = yp - halo - ring;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  {
    const int xp = x0 + lane, x = xp - halo - ring;
    const bool inside = y >= 0 && y < H && x >= 0 && x < W;
    const bool in_pad = y >= -halo && y < H + halo && x >= -halo && x < W + halo;
    const bool load = xp < Wd && (inside || (reflect && in_pad));
    const int64_t off = load ? (static_cast<int64_t>(reflect_index(y, H)) * W + reflect_index(x, W))
                             : 0;
    for (int c = warp; c < kTileC; c += kTileThreads / 32)
      tile[c][lane] = load && c0 + c < C
                          ? mt::to_float(src[(static_cast<int64_t>(b) * C + c0 + c) * H * W + off])
                          : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileP * (kTileC / V); i += kTileThreads) {
    const int j = i / (kTileC / V), cv = i % (kTileC / V);
    if (x0 + j >= Wd || c0 + cv * V >= C) continue;
    float v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = tile[cv * V + e][j];
    store_vec(dst + ((static_cast<int64_t>(b) * Hd + yp) * Wd + x0 + j) * C + c0 + cv * V, v);
  }
}

// out NCHW = x NCHW + h * a + b, h NHWC (B, HW, C), with the norm affine of
// (mean, rstd, gamma, beta); block (pixel tile of the flattened H x W, b,
// channel group)
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    residual_nchw_kernel(const T* __restrict__ x, const T* __restrict__ h,
                         const float* __restrict__ mean, const float* __restrict__ rstd,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         T* __restrict__ out, int HW, int C) {
  constexpr int V = mt::Vec<T>::kElems;
  __shared__ float tile[kTileC][kTileP + 1];
  const int p0 = blockIdx.x * kTileP, b = blockIdx.y, c0 = blockIdx.z * kTileC;
  for (int i = threadIdx.x; i < kTileP * (kTileC / V); i += kTileThreads) {
    const int j = i / (kTileC / V), cv = i % (kTileC / V);
    if (p0 + j >= HW || c0 + cv * V >= C) continue;
    float v[V];
    load_vec(h + (static_cast<int64_t>(b) * HW + p0 + j) * C + c0 + cv * V, v);
#pragma unroll
    for (int e = 0; e < V; ++e) tile[cv * V + e][j] = v[e];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (p0 + lane >= HW) return;
  for (int c = warp; c < kTileC && c0 + c < C; c += kTileThreads / 32) {
    float a, bb;
    norm_affine(mean, rstd, gamma, beta, b * C + c0 + c, a, bb);
    const int64_t k = (static_cast<int64_t>(b) * C + c0 + c) * HW + p0 + lane;
    out[k] = mt::from_float<T>(
        __fadd_rn(mt::to_float(x[k]), __fadd_rn(__fmul_rn(tile[c][lane], a), bb)));
  }
}

// ---------------------------------------------------------------------------
// bf16 GEMMs on the tensor cores: a block of two consumer warpgroups (threads
// 0-255, rows 0-63 and 64-127 of the 128 x 256 tile) and one producer warp
// (threads 256-287) that issues the TMA loads. Shared memory: kStages slabs
// of A (128 rows x 64 bf16, 16 KB) and B (256 rows x 64 bf16, 32 KB), each
// as 128-byte-swizzled TMA boxes, then the full/empty mbarriers.
// ---------------------------------------------------------------------------
constexpr int kGemmThreads = 288;
constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kStages = 4;
constexpr int kABytes = kBM * kBK * 2, kBBytes = kBN * kBK * 2;
constexpr int kGemmSmem = kStages * (kABytes + kBBytes) + 2 * kStages * 8 + 1024;
constexpr int kBox = 64 * 64 * 2;  // one 64 x 64 bf16 TMA box, 8 KB

struct Ring {
  uint8_t* a;
  uint8_t* b;
  uint64_t* full;
  uint64_t* empty;
};

// carve the dynamic shared memory (aligned to 1024 bytes, the swizzle's
// period) and initialize the barriers: full counts the producer's arrival
// (plus the bytes), empty one arrival per consumer warpgroup
__device__ __forceinline__ Ring ring_setup(uint8_t* raw) {
  const uint32_t base = smem_u32(raw);
  uint8_t* p = raw + (((base + 1023) & ~1023u) - base);
  Ring r{p, p + kStages * kABytes, reinterpret_cast<uint64_t*>(p + kStages * (kABytes + kBBytes)),
         nullptr};
  r.empty = r.full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// the conv: out[b, oy, ox, n] = sum_{ky, kx, c} in[b, oy + ky, ox + kx, c] *
// w[n, 3 ky + kx, c] over a padded NHWC input (B, Hp, Wp, C), Ho = Hp - 2,
// Wo = Wp - 2. Block (blockIdx.x = image x tiles + tile, blockIdx.y = N
// tile) computes output rows m0 .. m0 + 127 of m = oy * Wp + ox.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kGemmThreads, 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_in,
                      const __grid_constant__ CUtensorMap map_w, bf16* __restrict__ out, int Hp,
                      int Wp, int C, int N, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = ring_setup(smem_raw);
  const int b = blockIdx.x / tiles;
  const int m0 = (blockIdx.x % tiles) * kBM, n0 = blockIdx.y * kBN;
  const int csteps = C / kBK, ksteps = 9 * csteps;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // the producer warp
    if (threadIdx.x == 256) {
      const int row0 = b * Hp * Wp + m0;
      int stage = 0;
      uint32_t phase = 0;
      for (int k = 0; k < ksteps; ++k) {
        mbar_wait(&ring.empty[stage], phase ^ 1);
        mbar_expect_tx(&ring.full[stage], kABytes + kBBytes);
        const int tap = k / csteps, c0 = (k % csteps) * kBK;
        tma_load_2d(ring.a + stage * kABytes, &map_in, &ring.full[stage], c0,
                    row0 + (tap / 3) * Wp + tap % 3);
        tma_load_2d(ring.b + stage * kBBytes, &map_w, &ring.full[stage], tap * C + c0, n0);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int k = 0; k < ksteps; ++k) {
    mbar_wait(&ring.full[stage], phase);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: this warpgroup's 64 rows, K-major; B: all 256 rows, K-major; a
      // k16 step is 32 bytes along the swizzled 128-byte rows
      const uint64_t da = smem_desc(ring.a + stage * kABytes + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = smem_desc(ring.b + stage * kBBytes + kk * 32, 16, 1024);
      wgmma_m64n256k16<0, 0>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous slab's products are done: release it
    fence_acc(acc);
    if (k > 0 && threadIdx.x % 128 == 0) mbar_arrive(&ring.empty[prev]);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: round to bf16, store NHWC, two neighbouring channels per store;
  // accumulator 4j + 2h + e is row 16 warp + lane / 4 + 8 h, column
  // 8 j + 2 (lane % 4) + e of this warpgroup's 64 x 256
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int Ho = Hp - 2, Wo = Wp - 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    const int oy = m / Wp, ox = m - oy * Wp;
    if (oy >= Ho || ox >= Wo) continue;
    bf16* orow = out + ((static_cast<int64_t>(b) * Ho + oy) * Wo + ox) * N;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n < N) store2(orow + n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// the wgrad: dW[co, ci, t] = sum_q d[q, co] * a[q + shift_t, ci] over q in
// dh's padded grid (B, H+4, W+4), d = dh zero-padded by 2, a the conv input
// padded by 1 and set in a zero ring of 1 at the same pitch, shift_t =
// (ty - 1) (W + 4) + tx - 1. Block (rank s of a cluster of S along x, output
// tile y, tap z) sums the 64-pixel slabs of split s of a 128 (co) x 256 (ci)
// tile; the cluster then adds the S partials element by element in rank
// order, each block a slice of the rows, and writes dW (Co, Ci, 3, 3) f32.
// ---------------------------------------------------------------------------
constexpr int kPStride = kBN + 8;  // floats per row of the partial in shared memory

__global__ void __launch_bounds__(kGemmThreads, 1)
    wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap map_d,
                       const __grid_constant__ CUtensorMap map_a, float* __restrict__ dw, int W4,
                       int Ci, int Co, int ci_tiles, int slabs) {
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = ring_setup(smem_raw);
  const uint32_t rank = cluster_rank(), splits = cluster_size();
  const int t = blockIdx.z;
  const int shift = (t / 3 - 1) * W4 + (t % 3 - 1);
  const int ci0 = (blockIdx.y % ci_tiles) * kBN, co0 = (blockIdx.y / ci_tiles) * kBM;
  const int s_begin = static_cast<int>(static_cast<int64_t>(slabs) * rank / splits);
  const int s_end = static_cast<int>(static_cast<int64_t>(slabs) * (rank + 1) / splits);
  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // the producer warp
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int s = s_begin; s < s_end; ++s) {
        mbar_wait(&ring.empty[stage], phase ^ 1);
        mbar_expect_tx(&ring.full[stage], kABytes + kBBytes);
        const int q0 = s * 64;
        uint8_t* a = ring.a + stage * kABytes;
        uint8_t* bt = ring.b + stage * kBBytes;
        tma_load_2d(a, &map_d, &ring.full[stage], co0, q0);
        tma_load_2d(a + kBox, &map_d, &ring.full[stage], co0 + 64, q0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tma_load_2d(bt + j * kBox, &map_a, &ring.full[stage], ci0 + 64 * j, q0 + shift);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    cluster_sync();  // the consumers' two cluster barriers
    cluster_sync();
    return;
  }

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int s = s_begin; s < s_end; ++s) {
    mbar_wait(&ring.full[stage], phase);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // both MN-major: a k16 step is 16 pixel rows of 128 bytes; A is this
      // warpgroup's 64-channel box of d, B the four 64-channel boxes of a
      const uint64_t da = smem_desc(ring.a + stage * kABytes + wg * kBox + kk * 2048, kBox, 1024);
      const uint64_t db = smem_desc(ring.b + stage * kBBytes + kk * 2048, kBox, 1024);
      wgmma_m64n256k16<1, 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    if (s > s_begin && threadIdx.x % 128 == 0) mbar_arrive(&ring.empty[prev]);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // the partial, f32 [128][kPStride], over the ring once both warpgroups are done
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  float* part = reinterpret_cast<float*>(ring.a);
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* prow = part + (wg * 64 + warp * 16 + lane / 4 + 8 * h) * kPStride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      *reinterpret_cast<float2*>(prow + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  cluster_sync();
  const int r_begin = kBM * rank / splits, r_end = kBM * (rank + 1) / splits;
  for (int i = threadIdx.x; i < (r_end - r_begin) * (kBN / 4); i += 256) {
    const int row = r_begin + i / (kBN / 4), c4 = (i % (kBN / 4)) * 4;
    const float* src = part + row * kPStride + c4;
    float4 v = ld_cluster_f32x4(cluster_addr(src, 0));
    for (uint32_t q = 1; q < splits; ++q) {
      const float4 u = ld_cluster_f32x4(cluster_addr(src, q));
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const float vals[4] = {v.x, v.y, v.z, v.w};
    float* o = dw + (static_cast<int64_t>(co0 + row) * Ci + ci0 + c4) * 9 + t;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ci0 + c4 + e < Ci) o[9 * e] = vals[e];
  }
  cluster_sync();  // no block leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// f32 (comparisons on the card only): the same conv and wgrad on the CUDA
// cores, 64 x 64 tiles of 128 threads, each warp 32 x 32, double-buffered
// through registers.
// ---------------------------------------------------------------------------
constexpr int kTileM = 64, kTileN = 64;
constexpr int kThreads = 128;
constexpr int kRowBytes = 48;  // 32 bytes of k padded

struct ConvArgs {
  const void* in;
  const void* w;
  void* out;
  int Hp, Wp, C, N, Ho, Wo;
};

__global__ void __launch_bounds__(kThreads) conv_f32_kernel(ConvArgs p) {
  constexpr int KT = 8;  // k elements per step
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
    a_base += ((static_cast<int64_t>(b) * p.Hp + oy) * p.Wp + ox) * p.C * 4;
  }
  const uint8_t* b_base = static_cast<const uint8_t*>(p.w) + lhalf +
                          (b_ok ? static_cast<int64_t>(n_ld) * 9 * p.C * 4 : 0);
  const int csteps = p.C / KT;
  const int steps = 9 * csteps;

  auto load = [&](int s, uint4& ra, uint4& rb) {
    const int tap = s / csteps, c0 = (s % csteps) * KT;
    const int ky = tap / 3, kx = tap % 3;
    ra = a_ok ? __ldg(reinterpret_cast<const uint4*>(
                    a_base + (static_cast<int64_t>(ky * p.Wp + kx) * p.C + c0) * 4))
              : make_uint4(0, 0, 0, 0);
    rb = b_ok ? __ldg(reinterpret_cast<const uint4*>(
                    b_base + (static_cast<int64_t>(tap) * p.C + c0) * 4))
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
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* ar =
            reinterpret_cast<const float*>(&As[buf][(warp_m * 32 + mi * 16 + g + 8 * h) * kRowBytes]);
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

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp_m * 32 + mi * 16 + g + 8 * h;
      if (m >= hw) continue;
      float* orow = out + (static_cast<int64_t>(b) * hw + m) * p.N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + warp_n * 32 + ni * 8 + tig * 2;
        if (n < p.N) store2(orow + n, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

// dW[co, ci, t] = sum over all core pixels P of d[P, co] * a[P + tap t, ci],
// d = dh zero-padded by 2 (B, H+4, W+4, Co), a the ringed conv input (B,
// H+4, W+4, Ci); the tiles are loaded pixel-major, as they lie in memory
struct WgradArgs {
  const float* a;
  const float* d;
  float* dw;
  int H, W, Ci, Co;
  int64_t pixels;
};

__global__ void __launch_bounds__(kThreads) wgrad_f32_kernel(WgradArgs p) {
  constexpr int KT = 8;                     // pixels per step
  constexpr int kPitch = kTileM * 4 + 16;   // bytes per pixel row, padded
  constexpr int kChunks = kTileM * 4 / 16;  // 16-byte loads per row
  __shared__ __align__(16) uint8_t As[2][KT * kPitch];
  __shared__ __align__(16) uint8_t Bs[2][KT * kPitch];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int warp_m = warp / 2, warp_n = warp % 2;
  const int ci0 = blockIdx.x * kTileN, co0 = blockIdx.y * kTileM;
  const int tap = blockIdx.z, ty = tap / 3, tx = tap % 3;
  const int hw = p.H * p.W;
  const int steps = static_cast<int>((p.pixels + KT - 1) / KT);

  const int lrow = tid / kChunks, lchunk = tid % kChunks;
  auto load = [&](int s, uint4& ra, uint4& rb) {
    const int64_t P = static_cast<int64_t>(s) * KT + lrow;
    if (P < p.pixels) {
      const int b = static_cast<int>(P / hw), r = static_cast<int>(P % hw);
      const int y = r / p.W, x = r % p.W;
      const int64_t row = (static_cast<int64_t>(b) * (p.H + 4) + y + 2) * (p.W + 4) + x + 2;
      ra = __ldg(reinterpret_cast<const uint4*>(p.d + row * p.Co + co0 + lchunk * 4));
      const int64_t arow =
          (static_cast<int64_t>(b) * (p.H + 4) + y + ty + 1) * (p.W + 4) + x + tx + 1;
      rb = __ldg(reinterpret_cast<const uint4*>(p.a + arow * p.Ci + ci0 + lchunk * 4));
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

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + warp_m * 32 + mi * 16 + g + 8 * h;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ci = ci0 + warp_n * 32 + ni * 8 + tig * 2 + j;
          p.dw[(static_cast<int64_t>(co) * p.Ci + ci) * 9 + tap] = acc[mi][ni][2 * h + j];
        }
    }
}

// ---------------------------------------------------------------------------
// Per-(sample, channel) reductions over the pixels. A block of 16 warps owns
// 32 16-byte vectors of channels (256 bf16 or 128 f32 channels) of one
// sample and a slice of its pixels: lane l holds channels V l .. V l + V - 1
// of the chunk and warp w strides over the slice, so each warp load is a
// whole 512-byte pixel row. The warps' f64 partials are added in warp order,
// then the blocks of a cluster (1, 1, P), which split the sample's pixels,
// add theirs in rank order, so every block gets the same totals.
// ---------------------------------------------------------------------------
constexpr int kRedWarps = 16, kRedThreads = 32 * kRedWarps, kUnroll = 4;

// the totals over the block, then the cluster, of each thread's V partials:
// thread t < 32 V gets channel t of the chunk (the others 0). scratch holds
// kRedWarps x 32 V doubles, part 32 V.
template <int V>
__device__ __forceinline__ double chunk_sum(const double (&s)[V], double* scratch, double* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int e = 0; e < V; ++e) scratch[(warp * 32 + lane) * V + e] = s[e];
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x < 32 * V) {
    for (int w = 0; w < kRedWarps; ++w) t += scratch[w * 32 * V + threadIdx.x];
    part[threadIdx.x] = t;
  }
  cluster_sync();  // also a block barrier: scratch is free again
  if (threadIdx.x < 32 * V) {
    t = 0.0;
    const uint32_t n = cluster_size();
    for (uint32_t q = 0; q < n; ++q) t += ld_cluster_f64(cluster_addr(&part[threadIdx.x], q));
  }
  cluster_sync();  // part is free again, and no block leaves while it is read
  return t;
}

__device__ __forceinline__ void pixel_slice(int hw, int& p0, int& p1) {
  const uint32_t r = cluster_rank(), n = cluster_size();
  p0 = static_cast<int>(static_cast<int64_t>(hw) * r / n);
  p1 = static_cast<int>(static_cast<int64_t>(hw) * (r + 1) / n);
}

// mean and rstd of h (B, HW, C): centered, f64 sums of the f32 values; each
// thread adds its pixels in order, kUnroll loads in flight
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
    stats_kernel(const T* __restrict__ h, float* __restrict__ mean, float* __restrict__ rstd,
                 int HW, int C, float eps) {
  constexpr int V = mt::Vec<T>::kElems;
  __shared__ double scratch[kRedWarps * 32 * V];
  __shared__ double part[32 * V], mean_s[32 * V];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.y, chunk0 = blockIdx.x * 32 * V;
  const int c0 = chunk0 + lane * V;
  const bool ok = c0 < C;
  int p0, p1;
  pixel_slice(HW, p0, p1);
  const T* base = h + static_cast<int64_t>(b) * HW * C + c0;
  double s[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = 0.0;
  if (ok) {
    for (int p = p0 + warp; p < p1; p += kUnroll * kRedWarps) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p + u * kRedWarps < p1) load_vec(base + static_cast<int64_t>(p + u * kRedWarps) * C, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p + u * kRedWarps < p1) {
#pragma unroll
          for (int e = 0; e < V; ++e) s[e] += v[u][e];
        }
    }
  }
  const double total = chunk_sum<V>(s, scratch, part);
  if (threadIdx.x < 32 * V) mean_s[threadIdx.x] = total / HW;
  __syncthreads();
  double m[V], q[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    m[e] = mean_s[lane * V + e];
    q[e] = 0.0;
  }
  if (ok) {
    for (int p = p0 + warp; p < p1; p += kUnroll * kRedWarps) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p + u * kRedWarps < p1) load_vec(base + static_cast<int64_t>(p + u * kRedWarps) * C, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p + u * kRedWarps < p1) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const double d = v[u][e] - m[e];
            q[e] += d * d;
          }
        }
    }
  }
  const double sq = chunk_sum<V>(q, scratch, part);
  const int c = chunk0 + static_cast<int>(threadIdx.x);
  if (threadIdx.x < 32 * V && c < C && cluster_rank() == 0) {
    const int64_t i = static_cast<int64_t>(b) * C + c;
    mean[i] = __double2float_rn(mean_s[threadIdx.x]);
    const float var = __double2float_rn(sq / HW);
    rstd[i] = __double2float_rn(1.0 / sqrt(static_cast<double>(__fadd_rn(var, eps))));
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

// one (sample, V channels)'s statistics and, for the relu mask, norm affine
template <int V>
struct NormCoef {
  float mean[V], rstd[V], a[V], bb[V];
};

template <int V>
__device__ __forceinline__ void load_coef(const NormBwdArgs& p, int b, int c0, NormCoef<V>& k) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int64_t i = static_cast<int64_t>(b) * p.C + c0 + e;
    k.mean[e] = p.mean[i];
    k.rstd[e] = p.rstd[i];
    norm_affine(p.mean, p.rstd, p.gamma, p.beta, i, k.a[e], k.bb[e]);
  }
}

// d, masked by the forward's relu (n1 = h * a + b > 0) when relu, and
// yhat = (h - mean) * rstd, for V channels
template <typename T>
__device__ __forceinline__ void d_and_yhat(const NormBwdArgs& p,
                                           const NormCoef<mt::Vec<T>::kElems>& k, int b, int y,
                                           int x, int c0, float (&d)[mt::Vec<T>::kElems],
                                           float (&yh)[mt::Vec<T>::kElems]) {
  constexpr int V = mt::Vec<T>::kElems;
  load_d<T>(d, static_cast<const T*>(p.src), p.folded, p.reflect, b, y, x, p.H, p.W, p.C, c0);
  float hv[V];
  load_vec(static_cast<const T*>(p.h) + ((static_cast<int64_t>(b) * p.H + y) * p.W + x) * p.C + c0,
           hv);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    yh[e] = __fmul_rn(__fsub_rn(hv[e], k.mean[e]), k.rstd[e]);
    if (p.relu && !(__fadd_rn(__fmul_rn(hv[e], k.a[e]), k.bb[e]) > 0.f)) d[e] = 0.f;
  }
}

// pass A of a norm's backward: o1 = sum d, o2 = sum d * yhat per (b, c)
template <typename T>
__global__ void __launch_bounds__(kRedThreads) norm_bwd_sums_kernel(NormBwdArgs p) {
  constexpr int V = mt::Vec<T>::kElems;
  __shared__ double scratch[kRedWarps * 32 * V];
  __shared__ double part[32 * V];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.y, chunk0 = blockIdx.x * 32 * V;
  const int c0 = chunk0 + lane * V;
  const bool ok = c0 < p.C;
  int p0, p1;
  pixel_slice(p.H * p.W, p0, p1);
  double s1[V], s2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.0;
  if (ok) {
    NormCoef<V> k;
    load_coef<V>(p, b, c0, k);
    constexpr int U = kUnroll / 2;  // the folded loads need the registers
    for (int q = p0 + warp; q < p1; q += U * kRedWarps) {
      float d[U][V], yh[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = q + u * kRedWarps;
        if (r < p1) d_and_yhat<T>(p, k, b, r / p.W, r % p.W, c0, d[u], yh[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (q + u * kRedWarps < p1) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            s1[e] += d[u][e];
            s2[e] += static_cast<double>(d[u][e]) * yh[u][e];
          }
        }
    }
  }
  const double t1 = chunk_sum<V>(s1, scratch, part);
  const double t2 = chunk_sum<V>(s2, scratch, part);
  const int c = chunk0 + static_cast<int>(threadIdx.x);
  if (threadIdx.x < 32 * V && c < p.C && cluster_rank() == 0) {
    const int64_t i = static_cast<int64_t>(b) * p.C + c;
    p.o1[i] = __double2float_rn(t1);
    p.o2[i] = __double2float_rn(t2);
  }
}

// pass B: dh = (1 + gamma) * rstd * (d - s1/n - yhat * s2/n), rounded to T,
// into dh zero-padded by 2 (the border written as zeros). Block (32, 8) per
// row of dh: x over channel vectors, y over the row's pixels, so each
// thread's coefficients are loaded once.
template <typename T>
__global__ void __launch_bounds__(256) norm_bwd_apply_kernel(NormBwdArgs p) {
  constexpr int V = mt::Vec<T>::kElems;
  const int W4 = p.W + 4;
  const int b = blockIdx.x / (p.H + 4), y = static_cast<int>(blockIdx.x % (p.H + 4)) - 2;
  T* row = static_cast<T*>(p.dst) + static_cast<int64_t>(blockIdx.x) * W4 * p.C;
  const bool core_row = y >= 0 && y < p.H;
  const float n = static_cast<float>(p.H * p.W);
  for (int cv = threadIdx.x; cv * V < p.C; cv += blockDim.x) {
    const int c0 = cv * V;
    NormCoef<V> k;
    float coef[V], s1n[V], s2n[V];
    if (core_row) {
      load_coef<V>(p, b, c0, k);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int64_t i = static_cast<int64_t>(b) * p.C + c0 + e;
        coef[e] = __fmul_rn(__fadd_rn(1.f, p.gamma[i]), p.rstd[i]);
        s1n[e] = __fdiv_rn(p.s1[i], n);
        s2n[e] = __fdiv_rn(p.s2[i], n);
      }
    }
    for (int xx = threadIdx.y; xx < W4; xx += blockDim.y) {
      const int x = xx - 2;
      float out[V];
      if (!core_row || x < 0 || x >= p.W) {
#pragma unroll
        for (int e = 0; e < V; ++e) out[e] = 0.f;
      } else {
        float d[V], yh[V];
        d_and_yhat<T>(p, k, b, y, x, c0, d, yh);
#pragma unroll
        for (int e = 0; e < V; ++e)
          out[e] = __fmul_rn(coef[e], __fsub_rn(__fsub_rn(d[e], s1n[e]), __fmul_rn(yh[e], s2n[e])));
      }
      store_vec(row + static_cast<int64_t>(xx) * p.C + c0, out);
    }
  }
}

// dx NCHW = g NCHW + the pad adjoint of P (B, H+2, W+2, C) NHWC, rounded to
// T; block (b x row, column tile, channel group)
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    dx_nchw_kernel(const T* __restrict__ g, const T* __restrict__ P, T* __restrict__ out, int H,
                   int W, int C, int reflect) {
  constexpr int V = mt::Vec<T>::kElems;
  __shared__ float tile[kTileC][kTileP + 1];
  const int x0 = blockIdx.y * kTileP, c0 = blockIdx.z * kTileC;
  const int b = blockIdx.x / H, y = blockIdx.x % H;
  for (int i = threadIdx.x; i < kTileP * (kTileC / V); i += kTileThreads) {
    const int j = i / (kTileC / V), cv = i % (kTileC / V);
    if (x0 + j >= W || c0 + cv * V >= C) continue;
    float d[V];
    load_d<T>(d, P, true, reflect, b, y, x0 + j, H, W, C, c0 + cv * V);
#pragma unroll
    for (int e = 0; e < V; ++e) tile[cv * V + e][j] = d[e];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (x0 + lane >= W) return;
  for (int c = warp; c < kTileC && c0 + c < C; c += kTileThreads / 32) {
    const int64_t k = ((static_cast<int64_t>(b) * C + c0 + c) * H + y) * W + x0 + lane;
    out[k] = mt::from_float<T>(__fadd_rn(mt::to_float(g[k]), tile[c][lane]));
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

// a launch with thread block clusters of `cluster` blocks
template <typename... Params, typename... Args>
int launch_clustered(void (*kernel)(Params...), dim3 grid, dim3 block, dim3 cluster, int smem,
                     cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? static_cast<int>(err) : last_error();
}


template <typename Kernel>
cudaError_t allow_gemm_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
}

template <typename T>
int pad(const void* src, void* dst, const void* mean, const void* rstd, const void* gamma,
        const void* beta, int relu, int64_t B, int64_t H, int64_t W, int64_t C, int reflect,
        int ring, int nchw, void* stream) {
  const int64_t Hd = H + 2 + 2 * ring, Wd = W + 2 + 2 * ring;
  const int64_t total = B * Hd * Wd * (C / mt::Vec<T>::kElems);
  if (C % mt::Vec<T>::kElems || ring < 0 || ring > 1 || B * Hd >= (1LL << 31) ||
      (nchw && (mean != nullptr || (Wd + kTileP - 1) / kTileP > 65535)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (total == 0) return last_error();
  if (nchw) {
    dim3 grid(static_cast<unsigned>(B * Hd), static_cast<unsigned>((Wd + kTileP - 1) / kTileP),
              static_cast<unsigned>((C + kTileC - 1) / kTileC));
    pad_nchw_kernel<T><<<grid, kTileThreads, 0, st>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), static_cast<int>(H),
        static_cast<int>(W), static_cast<int>(C), reflect, 1, ring);
  } else {
    pad_kernel<T><<<static_cast<unsigned>(B * Hd), dim3(32, 8), 0, st>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), relu, static_cast<int>(H), static_cast<int>(W),
        static_cast<int>(C), reflect, ring);
  }
  return last_error();
}

// src NCHW (B, C, H, W) -> dst NHWC (B, H, W, C)
template <typename T>
int nhwc(const void* src, void* dst, int64_t B, int64_t C, int64_t H, int64_t W, void* stream) {
  if (C % mt::Vec<T>::kElems || B * H >= (1LL << 31) || (W + kTileP - 1) / kTileP > 65535)
    return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((W + kTileP - 1) / kTileP),
            static_cast<unsigned>((C + kTileC - 1) / kTileC));
  if (B * H > 0 && W > 0 && C > 0)
    pad_nchw_kernel<T><<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), static_cast<int>(H),
        static_cast<int>(W), static_cast<int>(C), 0, 0, 0);
  return last_error();
}

int conv_bf16(const void* in, const void* w, void* out, int64_t B, int64_t Hp, int64_t Wp,
              int64_t C, int64_t N, cudaStream_t stream) {
  if (C % kBK || N % 8 || Hp < 3 || Wp < 3 || B * Hp * Wp >= (1LL << 31) || 9 * C * N >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return last_error();
  const int64_t tiles = ((Hp - 2) * Wp + kBM - 1) / kBM;
  CUtensorMap map_in, map_w;
  if (!make_map(&map_in, kBf16, in, C, B * Hp * Wp, kBK, kBM) ||
      !make_map(&map_w, kBf16, w, 9 * C, N, kBK, kBN))
    return cudaErrorInvalidValue;
  const cudaError_t attr = allow_gemm_smem(conv_wgmma_kernel);
  if (attr != cudaSuccess) return attr;
  dim3 grid(static_cast<unsigned>(tiles * B), static_cast<unsigned>((N + kBN - 1) / kBN));
  conv_wgmma_kernel<<<grid, kGemmThreads, kGemmSmem, stream>>>(
      map_in, map_w, static_cast<bf16*>(out), static_cast<int>(Hp), static_cast<int>(Wp),
      static_cast<int>(C), static_cast<int>(N), static_cast<int>(tiles));
  return last_error();
}

int conv_f32(const void* in, const void* w, void* out, int64_t B, int64_t Hp, int64_t Wp,
             int64_t C, int64_t N, cudaStream_t stream) {
  if (C % 8 || N % 2 || B >= 65536 || (N + kTileN - 1) / kTileN >= 65536 || Hp < 3 || Wp < 3)
    return cudaErrorInvalidValue;
  ConvArgs a{in, w, out, static_cast<int>(Hp), static_cast<int>(Wp), static_cast<int>(C),
             static_cast<int>(N), static_cast<int>(Hp - 2), static_cast<int>(Wp - 2)};
  const int64_t tiles = ((Hp - 2) * (Wp - 2) + kTileM - 1) / kTileM;
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>((N + kTileN - 1) / kTileN),
            static_cast<unsigned>(B));
  if (B > 0) conv_f32_kernel<<<grid, kThreads, 0, stream>>>(a);
  return last_error();
}

template <typename T>
int conv(const void* in, const void* w, void* out, int64_t B, int64_t Hp, int64_t Wp, int64_t C,
         int64_t N, void* stream) {
  if constexpr (kIsBf16<T>)
    return conv_bf16(in, w, out, B, Hp, Wp, C, N, static_cast<cudaStream_t>(stream));
  else
    return conv_f32(in, w, out, B, Hp, Wp, C, N, static_cast<cudaStream_t>(stream));
}

// clusters of S blocks of `kernel` (`threads` threads, `smem` bytes of
// dynamic shared memory each) that the card runs at once; 0 if the query
// fails
template <typename Kernel>
int active_clusters(Kernel kernel, int S, int threads, int smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  return n;
}

// the largest cluster size S <= min(8, most) for which `clusters` clusters
// of `kernel` run in one wave; 1 if none does. The answers are kept per
// kernel, so the query runs once per size.
template <typename Kernel>
int cluster_size_for(Kernel kernel, int64_t clusters, int64_t most, int threads, int smem,
                     int (&cache)[9]) {
  for (int S = 8; S > 1; --S) {
    if (S > most) continue;
    if (cache[S] < 0) cache[S] = active_clusters(kernel, S, threads, smem);
    if (clusters <= cache[S]) return S;
  }
  return 1;
}

int wgrad_split_count(int64_t tiles, int64_t slabs) {
  static int cache[9] = {-1, -1, -1, -1, -1, -1, -1, -1, -1};
  if (allow_gemm_smem(wgrad_wgmma_kernel) != cudaSuccess) return 1;
  return cluster_size_for(wgrad_wgmma_kernel, tiles, slabs, kGemmThreads, kGemmSmem, cache);
}

int wgrad_bf16(const void* a, const void* d, void* dw, int64_t B, int64_t H, int64_t W,
               int64_t Ci, int64_t Co, cudaStream_t stream) {
  const int64_t Q = B * (H + 4) * (W + 4);
  if (Ci % 64 || Co % kBM || Q + 2 * (W + 4) + 64 >= (1LL << 31)) return cudaErrorInvalidValue;
  if (Q == 0 || Ci == 0 || Co == 0) return last_error();
  const int64_t ci_tiles = (Ci + kBN - 1) / kBN, tiles = ci_tiles * (Co / kBM);
  const int64_t slabs = (Q + 63) / 64;
  CUtensorMap map_d, map_a;
  if (!make_map(&map_d, kBf16, d, Co, Q, 64, 64) || !make_map(&map_a, kBf16, a, Ci, Q, 64, 64))
    return cudaErrorInvalidValue;
  const cudaError_t attr = allow_gemm_smem(wgrad_wgmma_kernel);
  if (attr != cudaSuccess) return attr;
  const int S = wgrad_split_count(9 * tiles, slabs);
  return launch_clustered(wgrad_wgmma_kernel, dim3(S, static_cast<unsigned>(tiles), 9),
                          dim3(kGemmThreads), dim3(S, 1, 1), kGemmSmem, stream, map_d, map_a,
                          static_cast<float*>(dw), static_cast<int>(W + 4), static_cast<int>(Ci),
                          static_cast<int>(Co), static_cast<int>(ci_tiles),
                          static_cast<int>(slabs));
}

int wgrad_f32(const void* a, const void* d, void* dw, int64_t B, int64_t H, int64_t W, int64_t Ci,
              int64_t Co, cudaStream_t stream) {
  if (Ci % kTileN || Co % kTileM || Ci / kTileN >= 65536 || Co / kTileM >= 65536)
    return cudaErrorInvalidValue;
  WgradArgs p{static_cast<const float*>(a), static_cast<const float*>(d), static_cast<float*>(dw),
              static_cast<int>(H), static_cast<int>(W), static_cast<int>(Ci),
              static_cast<int>(Co), B * H * W};
  dim3 grid(static_cast<unsigned>(Ci / kTileN), static_cast<unsigned>(Co / kTileM), 9);
  if (Ci > 0 && Co > 0) wgrad_f32_kernel<<<grid, kThreads, 0, stream>>>(p);
  return last_error();
}

template <typename T>
int wgrad(const void* a, const void* d, void* dw, int64_t B, int64_t H, int64_t W, int64_t Ci,
          int64_t Co, void* stream) {
  if constexpr (kIsBf16<T>)
    return wgrad_bf16(a, d, dw, B, H, W, Ci, Co, static_cast<cudaStream_t>(stream));
  else
    return wgrad_f32(a, d, dw, B, H, W, Ci, Co, static_cast<cudaStream_t>(stream));
}

// blocks of a cluster that split each sample's pixels: as many as fill the
// card in one wave (at most 8, each with a pixel per warp at least)
template <typename Kernel>
unsigned pixel_splits(Kernel kernel, int64_t clusters, int64_t hw, int (&cache)[9]) {
  return static_cast<unsigned>(
      cluster_size_for(kernel, clusters, hw / kRedWarps, kRedThreads, 0, cache));
}

template <typename T>
int stats(const void* h, void* mean, void* rstd, int64_t B, int64_t HW, int64_t C, float eps,
          void* stream) {
  constexpr int V = mt::Vec<T>::kElems;
  if (C % V || B >= 65536) return cudaErrorInvalidValue;
  if (B == 0 || C == 0) return last_error();
  static int cache[9] = {-1, -1, -1, -1, -1, -1, -1, -1, -1};
  const unsigned gx = static_cast<unsigned>((C + 32 * V - 1) / (32 * V));
  const unsigned P = pixel_splits(stats_kernel<T>, static_cast<int64_t>(gx) * B, HW, cache);
  return launch_clustered(stats_kernel<T>, dim3(gx, static_cast<unsigned>(B), P),
                          dim3(kRedThreads), dim3(1, 1, P), 0, static_cast<cudaStream_t>(stream),
                          static_cast<const T*>(h), static_cast<float*>(mean),
                          static_cast<float*>(rstd), static_cast<int>(HW), static_cast<int>(C),
                          eps);
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
    static int cache[9] = {-1, -1, -1, -1, -1, -1, -1, -1, -1};
    const unsigned gx = static_cast<unsigned>((C + 32 * V - 1) / (32 * V));
    const unsigned P = pixel_splits(norm_bwd_sums_kernel<T>, static_cast<int64_t>(gx) * B, H * W,
                                    cache);
    return launch_clustered(norm_bwd_sums_kernel<T>, dim3(gx, static_cast<unsigned>(B), P),
                            dim3(kRedThreads), dim3(1, 1, P), 0, st, p);
  }
  if (B * (H + 4) >= (1LL << 31)) return cudaErrorInvalidValue;
  norm_bwd_apply_kernel<T><<<static_cast<unsigned>(B * (H + 4)), dim3(32, 8), 0, st>>>(p);
  return last_error();
}

template <typename T>
int residual(const void* x, const void* h, const void* mean, const void* rstd, const void* gamma,
             const void* beta, void* out, int64_t B, int64_t HW, int64_t C, void* stream) {
  if (C % mt::Vec<T>::kElems || B >= 65536 || (HW + kTileP - 1) / kTileP >= (1LL << 31))
    return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>((HW + kTileP - 1) / kTileP), static_cast<unsigned>(B),
            static_cast<unsigned>((C + kTileC - 1) / kTileC));
  if (B > 0 && HW > 0 && C > 0)
    residual_nchw_kernel<T><<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<T*>(out), static_cast<int>(HW),
        static_cast<int>(C));
  return last_error();
}

template <typename T>
int dx(const void* g, const void* P, void* out, int64_t B, int64_t H, int64_t W, int64_t C,
       int reflect, void* stream) {
  if (C % mt::Vec<T>::kElems || H < 2 || W < 2 || (W + kTileP - 1) / kTileP > 65535 ||
      B * H >= (1LL << 31))
    return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((W + kTileP - 1) / kTileP),
            static_cast<unsigned>((C + kTileC - 1) / kTileC));
  if (B > 0 && C > 0)
    dx_nchw_kernel<T><<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(g), static_cast<const T*>(P), static_cast<T*>(out),
        static_cast<int>(H), static_cast<int>(W), static_cast<int>(C), reflect);
  return last_error();
}

}  // namespace

// Every tensor is contiguous NHWC in T (bf16 or f32) unless said otherwise;
// statistics, norm sums and gamma/beta are (B, C) f32; every pointer is
// 16-byte aligned. Each entry point returns cudaGetLastError().
#define MT_RB_ENTRY_POINTS(SUFFIX, T)                                                          \
  /* src (B, H, W, C), or NCHW (B, C, H, W) with nchw -> dst (B, H+2+2 ring, W+2+2 ring, */  \
  /* C); with mean != null (NHWC src only), relu?(norm(src)) first; ring 1 sets the       */  \
  /* padded src in a zero ring (the wgrad's input)                                        */  \
  extern "C" int mt_rb_pad_##SUFFIX(const void* src, void* dst, const void* mean,             \
                                    const void* rstd, const void* gamma, const void* beta,    \
                                    int relu, int64_t B, int64_t H, int64_t W, int64_t C,     \
                                    int reflect, int ring, int nchw, void* stream) {          \
    return pad<T>(src, dst, mean, rstd, gamma, beta, relu, B, H, W, C, reflect, ring, nchw,   \
                  stream);                                                                    \
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
  /* out = x + norm(h): x, out NCHW (B, C, HW), h NHWC (B, HW, C) */                          \
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
  /* a (B, H+4, W+4, Ci) ringed, d (B, H+4, W+4, Co) -> dw (Co, Ci, 3, 3) f32 */             \
  extern "C" int mt_rb_wgrad_##SUFFIX(const void* a, const void* d, void* dw, int64_t B,     \
                                      int64_t H, int64_t W, int64_t Ci, int64_t Co,           \
                                      void* stream) {                                         \
    return wgrad<T>(a, d, dw, B, H, W, Ci, Co, stream);                                       \
  }                                                                                           \
  /* out = g + pad adjoint of P (B, H+2, W+2, C): g, out NCHW (B, C, H, W) */                \
  extern "C" int mt_rb_dx_##SUFFIX(const void* g, const void* P, void* out, int64_t B,       \
                                   int64_t H, int64_t W, int64_t C, int reflect,              \
                                   void* stream) {                                            \
    return dx<T>(g, P, out, B, H, W, C, reflect, stream);                                     \
  }

MT_RB_ENTRY_POINTS(bf16, bf16)
MT_RB_ENTRY_POINTS(f32, float)

// src NCHW (B, C, H, W) -> dst NHWC (B, H, W, C), bf16
extern "C" int mt_rb_nhwc_bf16(const void* src, void* dst, int64_t B, int64_t C, int64_t H,
                               int64_t W, void* stream) {
  return nhwc<bf16>(src, dst, B, C, H, W, stream);
}
extern "C" int mt_rb_nhwc_f32(const void* src, void* dst, int64_t B, int64_t C, int64_t H,
                              int64_t W, void* stream) {
  return nhwc<float>(src, dst, B, C, H, W, stream);
}

// the cluster size the bf16 wgrad chooses at this shape
extern "C" int mt_rb_wgrad_splits(int64_t B, int64_t H, int64_t W, int64_t Ci, int64_t Co) {
  const int64_t tiles = 9 * ((Ci + kBN - 1) / kBN) * (Co / kBM);
  return wgrad_split_count(tiles, (B * (H + 4) * (W + 4) + 63) / 64);
}
