// One "mix" of BaseModel's decoder block (models/blocks.py DecResnetBlock),
// in NCHW bf16:
//
//   y = relu(Wb . relu(Wa_h . IN(x) + v) + bb)   [+ r]
//
// IN(x) = bf16((x - mean) * rstd) per (sample, channel), from statistics the
// wrapper takes from the moments kernel; Wa = [Wa_h | Wa_z] is the first 1x1
// conv's weight split where the block concatenates its style chunk after x,
// and v = Wa_z . bf16(z) + ba is that chunk's part of the first conv, the
// same at every pixel, computed once per sample by the wrapper
// (ops/kernels/dec_mix.py); Wb, bb the second 1x1 conv; r the block's input,
// added in the block's second mix.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA. On
// the card the composed chain (norm apply, style concat, two cuBLAS 1x1
// convs, two relus, the residual add) made about ten elementwise passes over
// (B, 256..512, H, W) maps around the two GEMMs; here the 512-channel hidden
// map never leaves the SM and x, r and y cross device memory once each.
//
// Bound: operations. At (64, 256, 64, 64) with 512 hidden channels one mix
// is 2 x 262,144 pixels x (256 x 512 + 512 x 256) = 137 GFLOP, 0.139 ms at
// the 989 TFLOP/s bf16 dense peak; x, r and y are 403 MB, 0.120 ms at
// 3.35 TB/s.
//
// Design. A block takes 128 pixels of one sample; pixels are GEMM rows (M).
// Two warpgroups each own 64 of the pixels; thread 0 also issues the TMA
// loads. It loads x's tile once (2 x 4 boxes of 64 pixels x 64 channels, the
// 128-byte swizzle, MN-major for wgmma), then streams the weights through a
// ring of four 32 KB slabs: for each chunk of 64 hidden channels, Wa_h's
// 64 x 256 rows (GEMM 1's B) and Wb's 256 x 64 columns (GEMM 2's B), both
// K-major. Each warpgroup
//   1. normalizes its half of x's tile in shared memory, in place (f32
//      subtract and multiply, no FMA, rounded to bf16, as ops/norms.py does);
//   2. per chunk: GEMM 1, wgmma m64n64k16 with A and B from shared memory
//      (K = 256), into 32 f32 registers; adds v, rounds to bf16 and applies
//      relu; the result is, register for register, the A fragment of the
//      next 64 of GEMM 2's K (FlashAttention-3's trick: the accumulator's
//      layout of m64n16 is the A operand's), so GEMM 2, four wgmma
//      m64n256k16 with A from registers, accumulates it straight into the
//      64 x 256 output in 128 registers;
//   3. adds bb, rounds, applies relu, stages the tile in its half of x's
//      tile (free once its last GEMM 1 is done) as 256 rows of 64 pixels
//      with 16-byte chunks swizzled by the row, and writes NCHW with 16-byte
//      stores, each row 128 contiguous bytes, r's 16 loads a thread at once.
// The hidden map stays in registers rather than in shared memory: staging a
// chunk there would cost a store and a read of 8 KB per warpgroup per chunk
// and a barrier, and the registers hold it (about 190 a thread, in the build
// log; no spills).
//
// What bounds it here is L2, not the tensor cores: each block re-reads all
// of Wa_h and Wb (512 KB), 1 GB of L2 traffic a mix. With the wgmmas cut
// out the launch still takes about 0.35 ms at the serving shape, of which
// about 0.22 ms scales with the hidden width (the weights, about 4.6 TB/s
// out of L2) and 0.13 ms does not (x, y, the norm pass, each tile's first
// slabs). Two ways to cut the weights' traffic were measured slower: thread
// block clusters of 2 and 4 sharing each slab by TMA multicast (the ring's
// slots then wait for the slowest block of the cluster, and thread 0 issues
// only when it polls), and a producer warp of its own (a 288-thread block
// counts as three warpgroups for registers: 168 a thread, too few).
//
// Numerics: the bf16 operands of the composed route, f32 accumulation; the
// norm, the hidden map, each conv's output and the residual sum are rounded
// to bf16 where the composed route rounds them. Only the order of the sums
// differs (and v's sum over the style channels is taken apart).
//
// The wrapper pads H x W to a multiple of 8 pixels (TMA's 16-byte strides);
// pixels past it in a block's tile are read as zeros and never stored.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace mt::sm90;

using bf16 = __nv_bfloat16;

constexpr int kC = 256;           // channels of x, r and y
constexpr int kMaxHidden = 512;   // hidden channels whose v a block stages
constexpr int kTileP = 128;       // pixels a block
constexpr int kChunk = 64;        // hidden channels a GEMM 1 chunk (GEMM 2's K slab)
constexpr int kThreads = 256;     // two warpgroups; thread 0 also issues the loads
constexpr int kSlots = 4;         // weight slabs in flight
constexpr int kBox = 64 * 64 * 2;              // one 64 x 64 bf16 TMA box, 8 KB
constexpr int kHalfBytes = (kC / 64) * kBox;   // a warpgroup's 64 pixels x 256 channels
constexpr int kXBytes = 2 * kHalfBytes;
constexpr int kSlabBytes = 32 * 1024;          // Wa_h 64 x 256 or Wb 256 x 64: 4 boxes
constexpr int kParams = kMaxHidden + 3 * kC;   // v, mean, rstd, bb (f32)
constexpr int kSmem = 1024 + kXBytes + kSlots * kSlabBytes + kParams * 4 + (2 + 2 * kSlots) * 8;

// D (64 x 64 f32) = A (64 x 16) * B (16 x 64) (+ D if accumulate): A MN-major,
// B K-major, both bf16 from shared memory through their descriptors
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 256 f32) += A (64 x 16, bf16 pairs in four registers a, in the
// accumulator's row and column order) * B (16 x 256, K-major bf16 from shared
// memory)
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// v through an opaque move: what is computed from it stays inside the loop
// that asks for it instead of being hoisted into registers held across it
__device__ __forceinline__ uint64_t opaque(uint64_t v) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(v));
  return v;
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Block (pixel tile, sample). map_x: x as (P, C, B) in 64 x 64 boxes; map_wa:
// Wa_h (hidden, C) in 64 x 64 boxes; map_wb: Wb (C, hidden) in 64 x 256 boxes.
__global__ void __launch_bounds__(kThreads, 1)
    dec_mix_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_wa,
                   const __grid_constant__ CUtensorMap map_wb, const float* __restrict__ mean,
                   const float* __restrict__ rstd, const float* __restrict__ vec,
                   const float* __restrict__ bb, const bf16* __restrict__ r,
                   bf16* __restrict__ out, int P, int hidden) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  uint8_t* xs = smem_raw + (((base + 1023) & ~1023u) - base);
  uint8_t* slabs = xs + kXBytes;
  float* s_vec = reinterpret_cast<float*>(slabs + kSlots * kSlabBytes);
  float* s_mean = s_vec + kMaxHidden;
  float* s_rstd = s_mean + kC;
  float* s_bb = s_rstd + kC;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(s_bb + kC);
  uint64_t* full = x_full + 2;
  uint64_t* empty = full + kSlots;

  const int b = blockIdx.y, p0 = blockIdx.x * kTileP;
  const int slabs_total = 2 * (hidden / kChunk);
  for (int i = threadIdx.x; i < hidden; i += kThreads)
    s_vec[i] = vec[static_cast<int64_t>(b) * hidden + i];
  for (int i = threadIdx.x; i < kC; i += kThreads) {
    s_mean[i] = mean[b * kC + i];
    s_rstd[i] = rstd[b * kC + i];
    s_bb[i] = bb[i];
  }
  if (threadIdx.x == 0) {
    mbar_init(&x_full[0], 1);
    mbar_init(&x_full[1], 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  // The loads, issued by thread 0: a producer warp of its own would make the
  // block three warpgroups for the register file, 168 registers a thread,
  // and the accumulators need more. Slab k (2c: Wa_h's rows of chunk c;
  // 2c + 1: Wb's columns of chunk c, four 8 KB boxes each) goes into slot
  // k % kSlots once both warpgroups have released slab k - kSlots there.
  // issue() issues, in order, every slab whose slot is free, without
  // waiting; thread 0 calls it after each release and while it waits for a
  // slab, so no slab whose slot is free waits for it.
  int next = 0;
  auto issue = [&]() {
    while (next < slabs_total &&
           (next < kSlots ||
            mbar_try_wait(smem_u32(&empty[next % kSlots]), ((next / kSlots) & 1) ^ 1))) {
      const int slot = next % kSlots;
      mbar_expect_tx(&full[slot], kSlabBytes);
      uint8_t* dst = slabs + slot * kSlabBytes;
      const int n0 = (next / 2) * kChunk;
      // box q: Wa_h's channels 64 q .., or Wb's rows 64 q .. (the swizzle
      // repeats every 8 rows, so four boxes of 64 rows lie as one of 256)
      for (int q = 0; q < kSlabBytes / kBox; ++q) {
        if (next % 2 == 0)
          tma_load_2d(dst + q * kBox, &map_wa, &full[slot], 64 * q, n0);
        else
          tma_load_2d(dst + q * kBox, &map_wb, &full[slot], n0, 64 * q);
      }
      ++next;
    }
  };
  auto wait_slab = [&](int k) {
    uint64_t* bar = &full[k % kSlots];
    const uint32_t parity = (k / kSlots) & 1;
    if (threadIdx.x != 0) return mbar_wait(bar, parity);
    const uint64_t t0 = global_ns();
    while (!mbar_try_wait(smem_u32(bar), parity)) {
      issue();
      if (global_ns() - t0 > 2000000000ull) asm volatile("trap;\n");
    }
  };
  if (threadIdx.x == 0) {
    for (int h = 0; h < 2; ++h) {
      mbar_expect_tx(&x_full[h], kHalfBytes);
      for (int k = 0; k < kC / 64; ++k)
        tma_load_5d(xs + h * kHalfBytes + k * kBox, &map_x, &x_full[h], p0 + 64 * h, 64 * k, b,
                    0, 0);
    }
    issue();
  }

  // 1. IN(x) on this warpgroup's half, in place: row i / 8 of the half is
  // channel i / 8 (four boxes of 64 channels), whatever the swizzle did to
  // the order of its 16-byte chunks
  const int t = threadIdx.x % 128;
  uint8_t* xh = xs + wg * kHalfBytes;
  mbar_wait(&x_full[wg], 0);
  for (int i = t; i < kHalfBytes / 16; i += 128) {
    uint4* p = reinterpret_cast<uint4*>(xh + i * 16);
    const float m = s_mean[i / 8], rs = s_rstd[i / 8];
    float v[8];
    mt::Vec<bf16>::unpack(*p, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(__fsub_rn(v[e], m), rs);
    *p = mt::Vec<bf16>::pack(v);
  }
  fence_proxy_async();  // the generic writes before wgmma's async reads
  warpgroup_sync(wg);

  // 2. the chunks: accumulator 4j + 2h + e is row 16 warp + lane / 4 + 8 h,
  // column 8 j + 2 (lane % 4) + e of this warpgroup's 64 rows
  const int warp = t / 32, lane = t % 32;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // per chunk: GEMM 1, wait, the hidden chunk into registers, GEMM 2, wait.
  // Each warpgroup waits for its own products; the other one's keep the
  // tensor cores busy meanwhile. (Issuing the next GEMM 1 before the wait
  // would let it write registers that GEMM 2 may still be reading, and the
  // compiler then serializes every wgmma of the kernel.)
  float acc1[32] = {};
  uint32_t frag[16] = {};
  for (int s = 0; s < slabs_total; s += 2) {
    const int sa = s % kSlots, sb = (s + 1) % kSlots;
    const uint8_t* wa = slabs + sa * kSlabBytes;
    const uint8_t* wb = slabs + sb * kSlabBytes;
    wait_slab(s);
    fence_acc(acc1);
    wgmma_fence();
    // a descriptor's address field is the byte address over 16: offsets add
    const uint64_t da = opaque(smem_desc(xh, kBox, 1024)), db = smem_desc(wa, 16, 1024);
#pragma unroll
    for (int k = 0; k < kC / 16; ++k) {
      // A: 16 channel rows of 128 bytes a k16 step; B: 32 bytes along Wa_h's rows
      wgmma_m64n64k16_ss(acc1, da + (((k / 4) * kBox + (k % 4) * 2048) >> 4),
                         db + (((k / 4) * kBox + (k % 4) * 32) >> 4), k > 0);  // k 0 overwrites
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc1);
    if (t == 0) mbar_arrive(&empty[sa]);
    if (threadIdx.x == 0) issue();
    // + v, bf16, relu: frag 4 k + i is GEMM 2's A register i of k16 step k
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = (s / 2) * kChunk + 8 * j + 2 * (lane % 4);
      const float v0 = s_vec[n], v1 = s_vec[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        frag[2 * j + h] = mt::Vec<bf16>::pack2(fmaxf(__fadd_rn(acc1[4 * j + 2 * h], v0), 0.f),
                                               fmaxf(__fadd_rn(acc1[4 * j + 2 * h + 1], v1), 0.f));
    }
    wait_slab(s + 1);
    fence_regs(frag);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k) {
      const uint32_t a[4] = {frag[4 * k], frag[4 * k + 1], frag[4 * k + 2], frag[4 * k + 3]};
      wgmma_m64n256k16_rs(acc, a, smem_desc(wb, 16, 1024) + ((k * 32) >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_regs(frag);
    if (t == 0) mbar_arrive(&empty[sb]);
    if (threadIdx.x == 0) issue();
  }

  // 3. relu(bf16(acc + bb)) into this warpgroup's half of x's tile as
  // [channel][64 pixels], chunk q of row co at 16 (q ^ co % 8)
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = warp * 16 + lane / 4 + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = 8 * j + 2 * (lane % 4) + e;
        *reinterpret_cast<bf16*>(xh + co * 128 + ((px / 8) ^ (co % 8)) * 16 + (px % 8) * 2) =
            __float2bfloat16_rn(fmaxf(__fadd_rn(acc[4 * j + 2 * h + e], s_bb[co]), 0.f));
      }
    }
  }
  warpgroup_sync(wg);
  // then NCHW, a thread's 16 vectors (row t / 8 + 16 i, chunk t % 8) at
  // once: r's 16 loads in flight together
  const int q = t % 8, p = p0 + 64 * wg + 8 * q;
  constexpr int kVecs = kC * 8 / 128;
  const int64_t g0 = (static_cast<int64_t>(b) * kC + t / 8) * P + p, rows16 = 16LL * P;
  uint4 rv[kVecs];
  if (r != nullptr && p < P) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) rv[i] = *reinterpret_cast<const uint4*>(r + g0 + i * rows16);
  }
  if (p < P) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int co = t / 8 + 16 * i;
      float v[8];
      mt::Vec<bf16>::unpack(*reinterpret_cast<const uint4*>(xh + co * 128 + (q ^ (co % 8)) * 16),
                            v);
      if (r != nullptr) {
        float u[8];
        mt::Vec<bf16>::unpack(rv[i], u);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(u[e], v[e]);
      }
      *reinterpret_cast<uint4*>(out + g0 + i * rows16) = mt::Vec<bf16>::pack(v);
    }
  }
}

}  // namespace

// x, r, out (B, 256, P) bf16 with P % 8 == 0; mean, rstd (B, 256) f32; wa
// (hidden, 256) and wb (256, hidden) bf16; vec (B, hidden) f32; bb (256,) f32;
// r may be null. Returns cudaGetLastError() after the launch.
extern "C" int mt_dec_mix(const void* x, const void* mean, const void* rstd, const void* wa,
                          const void* vec, const void* wb, const void* bb, const void* r,
                          void* out, int64_t B, int64_t P, int64_t hidden, void* stream) {
  if (B < 0 || P < 0 || P % 8 || hidden <= 0 || hidden % kChunk || hidden > kMaxHidden ||
      B >= 65536 || P >= (1LL << 31) - kTileP)
    return cudaErrorInvalidValue;
  if (B == 0 || P == 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap map_x, map_wa, map_wb;
  const uint64_t plane = static_cast<uint64_t>(kC) * P * 2;
  const uint64_t dims[5] = {static_cast<uint64_t>(P), kC, static_cast<uint64_t>(B), 1, 1};
  const uint64_t strides[4] = {static_cast<uint64_t>(P) * 2, plane, plane * B, plane * B};
  const uint32_t box[5] = {64, 64, 1, 1, 1};
  if (!make_map_5d(&map_x, kBf16, x, dims, strides, box) ||
      !make_map(&map_wa, kBf16, wa, kC, hidden, 64, 64) ||
      !make_map(&map_wb, kBf16, wb, hidden, kC, 64, 64))
    return cudaErrorInvalidValue;
  const cudaError_t attr =
      cudaFuncSetAttribute(dec_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(static_cast<unsigned>((P + kTileP - 1) / kTileP), static_cast<unsigned>(B));
  dec_mix_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_wa, map_wb, static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const float*>(vec), static_cast<const float*>(bb), static_cast<const bf16*>(r),
      static_cast<bf16*>(out), static_cast<int>(P), static_cast<int>(hidden));
  return static_cast<int>(cudaGetLastError());
}
