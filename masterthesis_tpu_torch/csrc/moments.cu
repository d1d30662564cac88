// Per-(sample, channel) spatial sums: the statistics pass of instance norm
// and layer norm.
//
// Replaces masterthesis_tpu/ops/pallas/moments.py spatial_sums (:80) and its
// (S, B, C) layout variant spatial_sums_sbc (:157). Both give f32 sum(x) and
// sum(x*x) per (sample, channel); mean and the one-pass variance
// max(E[x^2] - mean^2, 0) are built from them in torch on the (B, C) result
// (ops/norms.py), and layer norm first sums over C.
//
// Bound: bytes. The pass reads every element once and writes two floats per
// plane, about 3 flops per element: far below the card's f32 rate, so the
// least time is the bytes read over the HBM rate (3.35 TB/s on an H100 SXM).
//
// Design: NCHW makes each (b, c) plane one contiguous run of H*W elements,
// so one block owns one plane. It streams the plane with 16-byte vector
// loads, kUnroll loads in flight per thread to cover HBM latency, converts to
// f32 and accumulates in f64 registers; a warp-shuffle and shared-memory tree
// then reduces the block, and the f64 totals are rounded once to f32. No
// atomics and no second pass: each plane's result is written once, in a fixed
// order, so it is the same from run to run. Summing in f64 makes the f32
// result the correctly rounded sum in all but vanishingly rare cases,
// whatever the order, so the plain version (f64 sums in torch) gives the same
// bits, and the int8 chain that quantizes with these statistics does not
// flip a value between the two. The f64 adds cost nothing here: the pass is
// bound by bytes by a wide margin. The
// TPU kernel's (S, B, C) view existed for XLA's conv-output layout; the
// port's convs write NCHW, which this kernel reads as it is.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moments_kernel(const T* __restrict__ x, float* __restrict__ sum,
                   float* __restrict__ sumsq, int64_t hw) {
  using V = mt::Vec<T>;
  const T* p = x + static_cast<int64_t>(blockIdx.x) * hw;
  double s = 0.0, q = 0.0;
  int64_t tail = 0;
  if (mt::aligned16(p)) {
    const uint4* pv = reinterpret_cast<const uint4*>(p);
    const int64_t nvec = hw / V::kElems;
    int64_t i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(pv + i + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float f[V::kElems];
        V::unpack(v[u], f);
#pragma unroll
        for (int e = 0; e < V::kElems; ++e) {
          const double d = f[e];
          s += d;
          q = fma(d, d, q);
        }
      }
    }
    for (; i < nvec; i += kThreads) {
      float f[V::kElems];
      V::unpack(__ldg(pv + i), f);
#pragma unroll
      for (int e = 0; e < V::kElems; ++e) {
        const double d = f[e];
        s += d;
        q = fma(d, d, q);
      }
    }
    tail = nvec * V::kElems;
  }
  // elements the vector loop did not take: a ragged end, or a whole plane
  // that does not start on a 16-byte boundary
  for (int64_t i = tail + threadIdx.x; i < hw; i += kThreads) {
    const double d = mt::to_float(p[i]);
    s += d;
    q = fma(d, d, q);
  }
  mt::block_sum2<kThreads>(s, q);
  if (threadIdx.x == 0) {
    sum[blockIdx.x] = __double2float_rn(s);
    sumsq[blockIdx.x] = __double2float_rn(q);
  }
}

template <typename T>
int launch(const void* x, void* sum, void* sumsq, int64_t planes, int64_t hw,
           void* stream) {
  if (planes > 0) {
    moments_kernel<T><<<static_cast<unsigned>(planes), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<float*>(sum),
        static_cast<float*>(sumsq), hw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (planes, hw) contiguous; sum, sumsq: (planes,) f32. Returns the CUDA
// error of the launch (0 on success).
extern "C" int mt_moments_f32(const void* x, void* sum, void* sumsq, int64_t planes,
                              int64_t hw, void* stream) {
  return launch<float>(x, sum, sumsq, planes, hw, stream);
}

extern "C" int mt_moments_bf16(const void* x, void* sum, void* sumsq, int64_t planes,
                               int64_t hw, void* stream) {
  return launch<__nv_bfloat16>(x, sum, sumsq, planes, hw, stream);
}
