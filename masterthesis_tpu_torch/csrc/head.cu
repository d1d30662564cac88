// The int8 decoder's last step: the deferred LayerNorm affine of the last
// upsample, relu, the 1x1 conv C -> Co, bias and tanh, in one pass.
// Optionally a per-image term t (B, Co) joins each pixel's f32 sum over C
// before it is rounded: the share of the 1x1 conv of channels that are the
// same at every pixel of an image (DecoderConcat's z, which the kernel
// takes as t = W_z z in place of a concat of z's planes).
//
// Replaces masterthesis_tpu/ops/pallas/conv_int8.py pallas_packed_head
// (:1429). The TPU kernel reads the lane-packed deconv output and computes a
// transposed product so that its stores are full-lane; the port's transposed
// conv writes NCHW, which this kernel reads as it is.
//
// Bound: bytes. At (8, 64, 256, 256) -> 3 it reads 67 MB of bf16 (134 MB of
// f32) and writes 3.1 MB (6.3 MB), against 0.1 G MACs: the least time is the
// bytes over the HBM rate. What keeps the card from it is latency: HBM needs
// tens of KB in flight per SM, and in bf16 the per-element work (unpack,
// affine, relu, rounding, Co FMAs) is as long as the wait, so a thread that
// loads, waits and then computes leaves the memory idle while it computes.
//
// So each thread takes one run, a 16-byte vector of pixels (8 bf16 or 4
// f32) of one sample, and streams its C channel planes through a ring of
// kStages stages in shared memory, kBatch planes a stage, with 16-byte
// cp.async copies: while it computes stage k, stages k + 1 .. k + kStages - 1
// are in flight, 2 x 4 x 16 = 128 bytes a thread. The registers bound the
// resident threads (ptxas's counts are in the build log): for Co <= 4, 72
// registers in bf16 let 3 blocks of 256 threads share a SM (96 KB in flight),
// 56 in f32 let 4 (128 KB); each block's ring takes 48 KB. A slot of
// the ring is written and read by its own thread only, so the ring needs no
// barrier. The Co sums stay in registers; each output plane's run goes out as
// one 16-byte streaming store. The affine and relu results, the sums and the
// bias adds are rounded to T two at a time (cvt.rn.bf16x2.f32).
//
// The grid is (blocks per sample, B), computed by the wrapper
// (ops/kernels/head.py head_tiling), one run per thread. Each block stages its
// sample's affine (a, b) and the weights (rounded to T) in shared memory
// while its first copies are in flight. Blocks that each cover several runs
// per thread (one resident wave) measured slower: blocks of unequal count per
// SM leave SMs idle at the end.
//
// Runs come in warp groups of 32 (32 x 16 bytes, one coalesced copy per
// plane). When hw is not a multiple of the vector (every plane but the first
// starts off a 16-byte boundary) or x is not 16-byte aligned, the wrapper
// picks the scalar variant of the same kernel: a warp group's lane l takes
// pixels l, l + 32, l + 64, ... of the group, one element per load (still
// coalesced across the warp), in batches of 16 elements in registers. Pixels
// at or past hw, in the last group of each plane, are neither loaded nor
// stored. Either way one launch covers every pixel.
//
// The sum over C runs in channel order with FMAs, another order than cuDNN's
// 1x1 conv. The affine is two rounded operations (no FMA contraction), as
// torch's x * a + b is. In bf16 the kernel rounds where the JAX package's
// CPU route does (blocks.py _packed_head off the TPU): the affine and relu to
// bf16, the weights and bias to bf16, the f32 sum over C to bf16, the bias
// add to bf16, and tanh of that to bf16. The term is added to the f32 sum
// after the last channel; without one the kernel adds 0, which leaves every
// sum as it was.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;  // resident blocks per SM: at most 128 registers a thread
constexpr int kStages = 3;     // ring stages per thread (vector variant)
constexpr int kBatch = 4;      // channel planes per stage: 16-byte copies
constexpr int kMaxOut = 8;

struct HeadArgs {
  const void* x;
  const float* pa;    // (B, C) scale
  const float* pb;    // (B, C) shift
  const float* w;     // (Co, C)
  const float* bias;  // (Co,) or null
  const float* term;  // (B, Co) or null
  void* out;
  int64_t hw;
  int64_t runs;  // runs per plane, whole warp groups
  int C;
  int Co;
  int relu;
  float alpha;
  int act_tanh;
};

// 16 bytes from global to shared memory, asynchronously; zeros when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies done but for the newest n groups
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// v rounded to T (the identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return mt::to_float(mt::from_float<T>(v));
}

// v rounded to T two at a time (the identity for f32)
template <typename T, int E>
__device__ __forceinline__ void round_pairs(float (&v)[E]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int j = 0; j < E; j += 2) {
      mt::Vec<T>::lo_hi(mt::Vec<T>::pack2(v[j], v[j + 1]), v[j], v[j + 1]);
    }
  }
}

// pixel e of scalar run r: the runs of a warp group interleave, so each load
// instruction reads 32 adjacent pixels (a vector run r is pixels r E + e)
template <int E>
__device__ __forceinline__ int64_t scalar_pixel(int64_t r, int e) {
  return (r & ~int64_t{31}) * E + e * 32 + (r & 31);
}

// One channel plane of a run into its Co sums: the affine, relu and the
// rounding to T, then the FMAs with the plane's weights
template <typename T, int kCo, int E>
__device__ __forceinline__ void add_plane(float (&v)[E], float2 ab, const float4* swc, int relu,
                                          float alpha, float (&acc)[kCo][E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    float t = __fadd_rn(__fmul_rn(v[e], ab.x), ab.y);
    if (relu) t = fmaxf(t, __fmul_rn(alpha, t));
    v[e] = t;
  }
  round_pairs<T>(v);
  float wc[kCo];
#pragma unroll
  for (int q = 0; q < kCo / 4; ++q) {
    const float4 w4 = swc[q];
    wc[4 * q] = w4.x;
    wc[4 * q + 1] = w4.y;
    wc[4 * q + 2] = w4.z;
    wc[4 * q + 3] = w4.w;
  }
#pragma unroll
  for (int o = 0; o < kCo; ++o) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[o][e] = fmaf(v[e], wc[o], acc[o][e]);
  }
}

// A run's Co sums out: the image's term added, rounded to T, the bias added
// and rounded, tanh; one 16-byte store per plane (vector), else one element
// per pixel below hw
template <typename T, int kCo, bool kVector, int E>
__device__ __forceinline__ void store_run(float (&acc)[kCo][E], const HeadArgs& p,
                                          const float (&bo)[kCo], const float (&to)[kCo], T* os,
                                          int64_t r) {
#pragma unroll
  for (int o = 0; o < kCo; ++o) {
    if (o < p.Co) {
      float y[E];
#pragma unroll
      for (int e = 0; e < E; ++e) y[e] = __fadd_rn(acc[o][e], to[o]);
      round_pairs<T>(y);
      if (p.bias != nullptr) {
#pragma unroll
        for (int e = 0; e < E; ++e) y[e] = __fadd_rn(y[e], bo[o]);
        round_pairs<T>(y);
      }
      if (p.act_tanh) {
#pragma unroll
        for (int e = 0; e < E; ++e) y[e] = tanhf(y[e]);
      }
      T* op = os + o * p.hw;
      if constexpr (kVector) {
        if (r * E < p.hw) __stcs(reinterpret_cast<uint4*>(op + r * E), mt::Vec<T>::pack(y));
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int64_t px = scalar_pixel<E>(r, e);
          if (px < p.hw) op[px] = mt::from_float<T>(y[e]);
        }
      }
    }
  }
}

template <typename T, int kCo, bool kVector>
__global__ void __launch_bounds__(kThreads, kMinBlocks) head_kernel(const HeadArgs p) {
  constexpr int E = mt::Vec<T>::kElems;
  // scalar variant: planes per batch of register loads, 16 elements
  constexpr int kB = kVector ? kBatch : 16 / E;
  extern __shared__ float4 smem[];
  // vector: the ring, [kStages][kBatch][kThreads] 16-byte slots, each
  // written and read by one thread only; then for both
  uint4* ring = reinterpret_cast<uint4*>(smem);
  float4* sw = smem + (kVector ? kStages * kBatch * kThreads : 0);  // [C][kCo / 4]: w[o][c]
  float2* sab = reinterpret_cast<float2*>(sw + p.C * (kCo / 4));    // [C]: (a, b)
  const int C = p.C;
  const int64_t hw = p.hw;
  const int b = blockIdx.y;
  const T* xs = static_cast<const T*>(p.x) + static_cast<int64_t>(b) * C * hw;
  T* os = static_cast<T*>(p.out) + static_cast<int64_t>(b) * p.Co * hw;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;  // the run
  const bool live = r < p.runs;
  const int batches = (C + kB - 1) / kB;

  // vector: batch k's copies into ring stage k % kStages (zeros past C or hw)
  auto copy = [&](int k) {
    const bool in = live && r * E < hw;
    const int stage = k % kStages;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = k * kBatch + u;
      const bool ok = in && c < C;
      cp_async16(ring + (stage * kBatch + u) * kThreads + threadIdx.x,
                 ok ? xs + c * hw + r * E : xs, ok);
    }
    cp_async_commit();
  };
  // scalar: batch k's register loads
  T raw[kB][E];
  auto load = [&](int k) {
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int c = k * kB + u;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int64_t px = scalar_pixel<E>(r, e);
        raw[u][e] = (live && c < C && px < hw) ? xs[c * hw + px] : mt::from_float<T>(0.f);
      }
    }
  };

  // the first loads are in flight while the block stages the affine and weights
  if constexpr (kVector) {
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) copy(k);
  } else {
    load(0);
  }
  for (int i = threadIdx.x; i < C; i += kThreads) {
    const int64_t bc = static_cast<int64_t>(b) * C + i;
    sab[i] = make_float2(p.pa[bc], p.pb[bc]);
  }
  float* swf = reinterpret_cast<float*>(sw);
  for (int i = threadIdx.x; i < C * kCo; i += kThreads) {
    const int c = i / kCo, o = i % kCo;
    swf[i] = o < p.Co ? round_to<T>(p.w[static_cast<int64_t>(o) * C + c]) : 0.f;
  }
  float bo[kCo];
#pragma unroll
  for (int o = 0; o < kCo; ++o) {
    bo[o] = (p.bias != nullptr && o < p.Co) ? round_to<T>(p.bias[o]) : 0.f;
  }
  float to[kCo];
#pragma unroll
  for (int o = 0; o < kCo; ++o) {
    to[o] = (p.term != nullptr && o < p.Co) ? p.term[static_cast<int64_t>(b) * p.Co + o] : 0.f;
  }
  __syncthreads();

  float acc[kCo][E];
#pragma unroll
  for (int o = 0; o < kCo; ++o) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[o][e] = 0.f;
  }
  for (int k = 0; k < batches; ++k) {
    const int c0 = k * kB;
    if constexpr (kVector) {
      cp_async_wait<kStages - 2>();  // batch k's copies have landed
      copy(k + kStages - 1);         // into the stage batch k - 1 freed
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (c0 + u < C) {
          float v[E];
          mt::Vec<T>::unpack(ring[((k % kStages) * kBatch + u) * kThreads + threadIdx.x], v);
          add_plane<T, kCo>(v, sab[c0 + u], sw + (c0 + u) * (kCo / 4), p.relu, p.alpha, acc);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (c0 + u < C) {
          float v[E];
#pragma unroll
          for (int e = 0; e < E; ++e) v[e] = mt::to_float(raw[u][e]);
          add_plane<T, kCo>(v, sab[c0 + u], sw + (c0 + u) * (kCo / 4), p.relu, p.alpha, acc);
        }
      }
      if (k + 1 < batches) load(k + 1);
    }
  }
  if constexpr (kVector) cp_async_wait<0>();  // no copy outlives the thread
  if (live) store_run<T, kCo, kVector>(acc, p, bo, to, os, r);
}

template <int kCo, bool kVector>
size_t smem_bytes(int64_t C) {
  return (kVector ? sizeof(uint4) * kStages * kBatch * kThreads : 0) +
         static_cast<size_t>(C) * (kCo * sizeof(float) + sizeof(float2));
}

template <typename T, int kCo, bool kVector>
int launch_as(const HeadArgs& a, int64_t B, int64_t blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes<kCo, kVector>(a.C);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(head_kernel<T, kCo, kVector>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  head_kernel<T, kCo, kVector><<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(B)),
                                 kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the variant for Co output channels (4 or 8 sums per pixel) and the loads
template <typename T>
int launch(const HeadArgs& a, int vector, int64_t B, int64_t blocks, cudaStream_t stream) {
  if (a.Co <= 4) {
    return vector ? launch_as<T, 4, true>(a, B, blocks, stream)
                  : launch_as<T, 4, false>(a, B, blocks, stream);
  }
  return vector ? launch_as<T, 8, true>(a, B, blocks, stream)
                : launch_as<T, 8, false>(a, B, blocks, stream);
}

}  // namespace

// x: (B, C, hw) f32, or bf16 with bf16; pa, pb: (B, C) f32; w: (Co, C) f32;
// bias: (Co,) f32 or null; term: (B, Co) f32 or null; out: (B, Co, hw) of x's
// type. Co <= 8. The tiling (ops/kernels/head.py head_tiling): runs per
// plane, blocks per sample (the grid is (blocks, B), one run per thread), and
// vector (1: hw a multiple of the 16-byte vector and x 16-byte aligned).
extern "C" int mt_head(const void* x, const void* pa, const void* pb, int relu, float alpha,
                       const void* w, const void* bias, const void* term, void* out, int64_t B,
                       int64_t C, int64_t hw, int64_t Co, int act_tanh, int bf16, int64_t runs,
                       int64_t blocks, int vector, void* stream) {
  if (Co > kMaxOut || B >= 65536 || blocks >= (1LL << 31) || blocks * kThreads < runs ||
      runs % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || hw == 0 || Co == 0) return static_cast<int>(cudaGetLastError());
  HeadArgs a{x, static_cast<const float*>(pa), static_cast<const float*>(pb),
             static_cast<const float*>(w), static_cast<const float*>(bias),
             static_cast<const float*>(term), out, hw, runs,
             static_cast<int>(C), static_cast<int>(Co), relu, alpha, act_tanh};
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, vector, B, blocks, s)
              : launch<float>(a, vector, B, blocks, s);
}
