// The int8 decoder's last step: the deferred LayerNorm affine of the last
// upsample, relu, the 1x1 conv C -> Co, bias and tanh, in one pass.
//
// Replaces masterthesis_tpu/ops/pallas/conv_int8.py pallas_packed_head
// (:1429). The TPU kernel reads the lane-packed deconv output and computes a
// transposed product so that its stores are full-lane; the port's transposed
// conv writes NCHW, so one thread takes one pixel of one image: it walks the
// C channel planes (coalesced across the block), keeps the Co sums in
// registers, and writes Co planes.
//
// Bound: bytes. At the flagship shape it reads 134 MB of f32 and writes
// 6.3 MB, against 0.1 G MACs: the least time is the bytes over the HBM rate.
// The affine is two rounded operations, as torch's x * a + b is; the sum over
// C runs in channel order with FMAs, another order than cuDNN's 1x1 conv.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 8;

__global__ void __launch_bounds__(kThreads)
    head_kernel(const float* __restrict__ x, const float* __restrict__ pa,
                const float* __restrict__ pb, int relu, float alpha,
                const float* __restrict__ w, const float* __restrict__ bias,
                float* __restrict__ out, int C, int64_t hw, int Co, int act_tanh) {
  extern __shared__ float smem[];  // a[C], b[C], w[Co * C]
  float* sa = smem;
  float* sb = smem + C;
  float* sw = smem + 2 * C;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < C; i += kThreads) {
    sa[i] = pa[static_cast<int64_t>(b) * C + i];
    sb[i] = pb[static_cast<int64_t>(b) * C + i];
  }
  for (int i = threadIdx.x; i < Co * C; i += kThreads) sw[i] = w[i];
  __syncthreads();
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= hw) return;
  float acc[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) acc[o] = 0.f;
  const float* xp = x + static_cast<int64_t>(b) * C * hw + p;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float v = __fadd_rn(__fmul_rn(__ldg(xp + c * hw), sa[c]), sb[c]);
    if (relu) v = fmaxf(v, __fmul_rn(alpha, v));
#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      if (o < Co) acc[o] = fmaf(v, sw[o * C + c], acc[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    if (o < Co) {
      float r = acc[o];
      if (bias != nullptr) r += bias[o];
      if (act_tanh) r = tanhf(r);
      out[(static_cast<int64_t>(b) * Co + o) * hw + p] = r;
    }
  }
}

}  // namespace

// x: (B, C, hw) f32; pa, pb: (B, C) f32; w: (Co, C) f32; bias: (Co,) f32 or
// null; out: (B, Co, hw) f32. Co <= 8.
extern "C" int mt_head(const void* x, const void* pa, const void* pb, int relu, float alpha,
                       const void* w, const void* bias, void* out, int64_t B, int64_t C,
                       int64_t hw, int64_t Co, int act_tanh, void* stream) {
  if (Co > kMaxOut || B >= 65536) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(2 * C + Co * C) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (hw + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  if (B > 0 && hw > 0) {
    head_kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(B)), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(pa),
        static_cast<const float*>(pb), relu, alpha, static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), static_cast<int>(C), hw,
        static_cast<int>(Co), act_tanh);
  }
  return static_cast<int>(cudaGetLastError());
}
