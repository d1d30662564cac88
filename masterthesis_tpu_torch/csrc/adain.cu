// Adaptive instance norm forward: out = (1 + gamma) * (x - mean) * rsqrt(var + eps) + beta
// per (sample, channel) plane, with mean and the centered variance over H*W.
//
// Replaces masterthesis_tpu/ops/pallas/adain.py _pallas_adain_fwd (:80), whose
// arithmetic (:50-64) it keeps: f32 mean, then the centered sum((x - mean)^2),
// then scale = (1 + gamma) * rsqrt(var + eps), shift = beta - mean * scale and
// one write of x * scale + shift in x's dtype.
//
// Bound: bytes. The function reads x once and writes out once (plus two
// floats of gamma and beta per plane), at about 6 flops per element: the least
// time is those bytes over the HBM rate (3.35 TB/s on an H100 SXM).
//
// Design: one block per (b, c) plane, as the TPU kernel keeps one image in
// VMEM. The plane is staged in shared memory by the first pass (16 KB for a
// 64x64 f32 plane; the wrapper refuses planes above the 227 KB a block can
// hold), so the mean, the centered variance and the normalize-and-modulate
// write all read it on chip: device memory sees one read and one write, and
// the centered two-pass variance costs no extra traffic. Each thread re-reads
// only the shared-memory slots it wrote, so the passes need no barrier beyond
// the ones inside the block sums.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    adain_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ out, int64_t hw,
                 float eps) {
  using V = mt::Vec<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int64_t plane = blockIdx.x;
  const T* src = x + plane * hw;
  T* dst = out + plane * hw;
  const bool vec = mt::aligned16(src) && mt::aligned16(dst);
  const int64_t nvec = vec ? hw / V::kElems : 0;
  const int64_t tail = nvec * V::kElems;
  const uint4* src_v = reinterpret_cast<const uint4*>(src);
  uint4* tile_v = reinterpret_cast<uint4*>(tile);
  uint4* dst_v = reinterpret_cast<uint4*>(dst);

  // pass 1: device memory -> shared memory, sum
  float s = 0.f, unused = 0.f;
  for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 v = __ldg(src_v + i);
    tile_v[i] = v;
    float f[V::kElems];
    V::unpack(v, f);
#pragma unroll
    for (int e = 0; e < V::kElems; ++e) s += f[e];
  }
  for (int64_t i = tail + threadIdx.x; i < hw; i += kThreads) {
    const T v = src[i];
    tile[i] = v;
    s += mt::to_float(v);
  }
  mt::block_sum2<kThreads>(s, unused);
  const float inv_n = 1.f / static_cast<float>(hw);
  const float mean = s * inv_n;

  // pass 2: centered variance from shared memory
  float q = 0.f;
  unused = 0.f;
  for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
    float f[V::kElems];
    V::unpack(tile_v[i], f);
#pragma unroll
    for (int e = 0; e < V::kElems; ++e) {
      const float d = f[e] - mean;
      q = fmaf(d, d, q);
    }
  }
  for (int64_t i = tail + threadIdx.x; i < hw; i += kThreads) {
    const float d = mt::to_float(tile[i]) - mean;
    q = fmaf(d, d, q);
  }
  mt::block_sum2<kThreads>(q, unused);
  const float var = q * inv_n;
  const float scale = (1.f + gamma[plane]) * rsqrtf(var + eps);
  const float shift = beta[plane] - mean * scale;

  // pass 3: normalize, modulate, one write in x's dtype
  for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
    float f[V::kElems];
    V::unpack(tile_v[i], f);
#pragma unroll
    for (int e = 0; e < V::kElems; ++e) f[e] = fmaf(f[e], scale, shift);
    dst_v[i] = V::pack(f);
  }
  for (int64_t i = tail + threadIdx.x; i < hw; i += kThreads) {
    dst[i] = mt::from_float<T>(fmaf(mt::to_float(tile[i]), scale, shift));
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out,
           int64_t planes, int64_t hw, float eps, void* stream) {
  const size_t smem = static_cast<size_t>(hw) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      adain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes > 0) {
    adain_kernel<T><<<static_cast<unsigned>(planes), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<T*>(out), hw, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// AdaIN with given statistics: out = x * scale + shift, scale = (1 + gamma) * rstd,
// shift = beta - mean * scale, per (sample, channel) plane. The spatially
// sharded forward (parallel/spatial.py) takes its statistics from the moments
// kernel's local sums all-reduced over the ranks that share an image; this is
// the apply, the third pass above without the first two. It replaces no TPU
// kernel of its own: it is the write of _pallas_adain_fwd (adain.py:50-64) with
// the statistics of the whole image, which no rank holds.
//
// Bound: bytes, one read of x and one write of out. Each product and sum is
// rounded on its own (__fmul_rn, __fadd_rn: no contraction into an fma), in
// the order of the plain version's tensor ops, so the two agree bit for bit.
//
// Design: a plane's scale and shift are computed once per block; the blocks of
// a plane stride over its 16-byte vectors, so a short plane (a shard holds a
// few rows) still fills the card through the (planes, chunks) grid.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    adain_stats_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                       const float* __restrict__ rstd, const float* __restrict__ gamma,
                       const float* __restrict__ beta, T* __restrict__ out, int64_t hw) {
  using V = mt::Vec<T>;
  const int64_t plane = blockIdx.x;
  const float scale = __fmul_rn(__fadd_rn(1.f, gamma[plane]), rstd[plane]);
  const float shift = __fsub_rn(beta[plane], __fmul_rn(mean[plane], scale));
  const T* src = x + plane * hw;
  T* dst = out + plane * hw;
  const bool vec = mt::aligned16(src) && mt::aligned16(dst);
  const int64_t nvec = vec ? hw / V::kElems : 0;
  const int64_t tail = nvec * V::kElems;
  const int64_t step = static_cast<int64_t>(gridDim.y) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  const uint4* src_v = reinterpret_cast<const uint4*>(src);
  uint4* dst_v = reinterpret_cast<uint4*>(dst);
  for (int64_t i = first; i < nvec; i += step) {
    float f[V::kElems];
    V::unpack(__ldg(src_v + i), f);
#pragma unroll
    for (int e = 0; e < V::kElems; ++e) f[e] = __fadd_rn(__fmul_rn(f[e], scale), shift);
    dst_v[i] = V::pack(f);
  }
  for (int64_t i = tail + first; i < hw; i += step) {
    dst[i] = mt::from_float<T>(__fadd_rn(__fmul_rn(mt::to_float(src[i]), scale), shift));
  }
}

template <typename T>
int launch_stats(const void* x, const void* mean, const void* rstd, const void* gamma,
                 const void* beta, void* out, int64_t planes, int64_t hw, void* stream) {
  if (planes > 0 && hw > 0) {
    // enough blocks per plane for each thread to take about four vectors
    const int64_t per_block = static_cast<int64_t>(kThreads) * mt::Vec<T>::kElems * 4;
    const int64_t chunks = (hw + per_block - 1) / per_block;
    const dim3 grid(static_cast<unsigned>(planes),
                    static_cast<unsigned>(chunks < 65535 ? chunks : 65535));
    adain_stats_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(mean),
        static_cast<const float*>(rstd), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<T*>(out), hw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (planes, hw) contiguous in one dtype; mean, rstd, gamma, beta:
// (planes,) f32. Returns the CUDA error of the launch (0 on success).
extern "C" int mt_adain_stats_f32(const void* x, const void* mean, const void* rstd,
                                  const void* gamma, const void* beta, void* out,
                                  int64_t planes, int64_t hw, void* stream) {
  return launch_stats<float>(x, mean, rstd, gamma, beta, out, planes, hw, stream);
}

extern "C" int mt_adain_stats_bf16(const void* x, const void* mean, const void* rstd,
                                   const void* gamma, const void* beta, void* out,
                                   int64_t planes, int64_t hw, void* stream) {
  return launch_stats<__nv_bfloat16>(x, mean, rstd, gamma, beta, out, planes, hw, stream);
}

// x, out: (planes, hw) contiguous in one dtype; gamma, beta: (planes,) f32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int mt_adain_f32(const void* x, const void* gamma, const void* beta, void* out,
                            int64_t planes, int64_t hw, float eps, void* stream) {
  return launch<float>(x, gamma, beta, out, planes, hw, eps, stream);
}

extern "C" int mt_adain_bf16(const void* x, const void* gamma, const void* beta, void* out,
                             int64_t planes, int64_t hw, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, out, planes, hw, eps, stream);
}
