// Hopper (sm_90a) primitives shared by the port's TMA + wgmma kernels
// (resblock_bf16.cu, int8_conv.cu): shared-memory addresses, mbarriers, TMA
// loads, wgmma descriptors and fences, thread block clusters, and on the host
// the TMA descriptors, encoded per call through the driver's
// cuTensorMapEncodeTiled (found at run time: no -lcuda at build).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mt::sm90 {

// ---------------------------------------------------------------------------
// Hopper primitives: shared-memory addresses, mbarriers, TMA, wgmma, clusters
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// returns once the phase of the given parity has completed; a wait of more
// than 2 s can only be a broken pipeline, so it traps (the launch fails)
// rather than hold the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity))
    if (global_ns() - t0 > 2000000000ull) asm volatile("trap;\n");
}

// one 2-D box of the tensor map at (inner, outer) element coordinates into
// shared memory; completion is counted in bytes on the mbarrier
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// the same for a 3-D box at (inner, middle, outer)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int inner, int middle, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(middle),
      "r"(outer)
      : "memory");
}

// the same for a 5-D box at (c0 .. c4), c0 innermost
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// a 5-D box of shared memory into the tensor map's array at (c0 .. c4), c0
// innermost, as a bulk async-group of this thread (elements past a dim are
// not written); the shared memory's generic-proxy writes must be fenced
// (fence_proxy_async) and visible to this thread first
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA) reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// closes this thread's bulk async-group and waits until its TMA stores have
// read their shared memory (their writes to global memory go on)
__device__ __forceinline__ void tma_store_drain_reads() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. lbo / sbo in bytes:
// K-major, sbo is the stride of 8-row groups (lbo unused); MN-major, lbo is
// the stride of 64-element MN blocks and sbo that of 8-row K groups.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// the same for K-major tiles of 64-byte rows with the 64-byte swizzle (8-row
// groups 512 bytes apart)
__device__ __forceinline__ uint64_t smem_desc_64b(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator registers across the async ops
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// every thread of every block of the cluster; orders shared-memory writes
// before it with reads of any block's shared memory after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}
// the address of the same shared variable in the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ double ld_cluster_f64(uint32_t addr) {
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];\n" : "=d"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_cluster_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// TMA descriptors come from the driver's cuTensorMapEncodeTiled, found at
// run time through the runtime's entry-point query (no -lcuda at build)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the element types the maps take: (TMA type, bytes)
struct Elem {
  CUtensorMapDataType type;
  uint32_t bytes;
};
constexpr Elem kBf16{CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2};
constexpr Elem kInt8{CU_TENSOR_MAP_DATA_TYPE_UINT8, 1};
constexpr Elem kF32{CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4};

// a row-major (rows, inner) matrix of `elem`, read in (box_rows, box_inner)
// boxes with the 128-byte swizzle (box_inner x elem.bytes = 128); out-of-bounds
// elements read as zeros
inline bool make_map(CUtensorMap* map, Elem elem, const void* base, uint64_t inner, uint64_t rows,
                     uint32_t box_inner, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {inner * elem.bytes};
  const cuuint32_t box[2] = {box_inner, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, elem.type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a row-major (outer, middle, inner) array, read in (box_outer, 1, box_inner)
// boxes, which land in shared memory as box_outer rows of box_inner elements
// (box_inner x elem.bytes = the swizzle's width)
inline bool make_map_3d(CUtensorMap* map, Elem elem, const void* base, uint64_t inner,
                        uint64_t middle, uint64_t outer, uint32_t box_inner, uint32_t box_outer,
                        CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {inner, middle, outer};
  const cuuint64_t strides[2] = {inner * elem.bytes, inner * middle * elem.bytes};
  const cuuint32_t box[3] = {box_inner, 1, box_outer};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, elem.type, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 5-D array (dims[0] innermost, strides in bytes of dims 1-4) read in
// boxes of box[0..4] elements, which land in shared memory as
// box[4] x box[3] x box[2] x box[1] rows of box[0] elements
inline bool make_map_5d(CUtensorMap* map, Elem elem, const void* base, const uint64_t (&dims)[5],
                        const uint64_t (&strides)[4], const uint32_t (&box)[5],
                        CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t d[5] = {dims[0], dims[1], dims[2], dims[3], dims[4]};
  const cuuint64_t s[4] = {strides[0], strides[1], strides[2], strides[3]};
  const cuuint32_t bx[5] = {box[0], box[1], box[2], box[3], box[4]};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return fn(map, elem.type, 5, const_cast<void*>(base), d, s, bx, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace mt::sm90
