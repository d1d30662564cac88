// Helpers shared by the port's CUDA kernels: 16-byte vector unpacking for
// f32 and bf16, and block-wide sums. Every kernel library is built from one
// .cu file that includes this header, with a plain C interface loaded through
// ctypes (masterthesis_tpu_torch/ops/kernels/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mt {

constexpr int kWarp = 32;

// Elements of type T in one 16-byte vector, and their conversion to f32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32 bits.
// f32 -> bf16 rounds to nearest even, as torch's .to(torch.bfloat16) does.
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void lo_hi(uint32_t u, float& lo, float& hi) {
    lo = __uint_as_float(u << 16);
    hi = __uint_as_float(u & 0xffff0000u);
  }
  __device__ __forceinline__ static void unpack(const uint4& v, float (&f)[8]) {
    lo_hi(v.x, f[0], f[1]);
    lo_hi(v.y, f[2], f[3]);
    lo_hi(v.z, f[4], f[5]);
    lo_hi(v.w, f[6], f[7]);
  }
  __device__ __forceinline__ static uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of a and of b (float or double) over the block; every thread gets both
// totals. Safe to call repeatedly: the trailing barrier keeps the next call
// from overwriting the scratch before every thread has read it.
template <int kThreads, typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b) {
  static_assert(kThreads % kWarp == 0 && kThreads <= 1024, "block size");
  constexpr int kWarps = kThreads / kWarp;
  __shared__ T part_a[kWarps], part_b[kWarps];
  __shared__ T total_a, total_b;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    part_a[warp] = a;
    part_b[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    T ta = lane < kWarps ? part_a[lane] : T(0);
    T tb = lane < kWarps ? part_b[lane] : T(0);
    ta = warp_sum(ta);
    tb = warp_sum(tb);
    if (lane == 0) {
      total_a = ta;
      total_b = tb;
    }
  }
  __syncthreads();
  a = total_a;
  b = total_b;
  __syncthreads();
}

}  // namespace mt

extern "C" const char* mt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
