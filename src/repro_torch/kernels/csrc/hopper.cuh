// Hopper (sm_90a) machinery shared by the GEMMs (dense_matmul.cu: bf16, and
// f32 as 3xTF32), the bf16 attention kernel (flash_attention.cu), the
// block-sparse FC (sparse_fc.cu, bf16 and 3xTF32 f32) and the SSD cell
// (ssd_intra.cu, 3xTF32): TMA tensor maps on the host; mbarrier rings, TMA
// loads, wgmma descriptors and products, named and cluster barriers, loads
// from another CTA's shared memory, setmaxnreg and the 3xTF32 split on the
// device.  Each device helper is one PTX
// instruction (or a loop around one, or the pair a barrier needs), named in
// the line above it.
//
// The layout rules that every tile in shared memory follows
// ----------------------------------------------------------
// A tile is loaded by TMA with the 128-byte swizzle: each row of the box is
// 128 bytes (64 bf16, or 32 f32), and the 16-byte chunk c of row r is stored
// at chunk c ^ (r % 8).  TMA takes r from bits 7-9 of the shared-memory
// address, and wgmma undoes the swizzle the same way, so:
//
// * every tile starts on a 1024-byte boundary (8 rows of 128 bytes): the
//   pattern then starts at row 0 and the descriptor's base offset (bits
//   49-51) stays 0;
// * an operand wider than one 128-byte row along its contiguous axis is
//   stored as several 128-byte-wide chunks, one TMA box each, each a tile
//   of its own.
//
// The wgmma descriptor (desc_sw128) holds the start address, a leading
// byte offset (LBO) and a stride byte offset (SBO), each in 16-byte units,
// and the layout (1 = 128-byte swizzle).  It says nothing of the element
// type: one k-step is 32 bytes of K in both types (k16 for bf16, k8 for
// tf32), so a K-major tile's rules are the same for 2- and 4-byte elements.
// For one k-step:
//
// * K-major operand (rows along M or N, the 128 bytes of a row along K):
//   SBO = 1024, the step from one group of 8 rows to the next; LBO is not
//   used with this swizzle (16).  k-step i of a 128-byte chunk starts at
//   the chunk + 32 i bytes, i < 4 (16 bf16 or 8 f32 a step): bits 7-9 stay
//   0, so the base offset stays 0 too.
// * MN-major operand (rows along K, the 64 values of a row along M or N;
//   the transpose bit set, which only 16-bit types allow): SBO = 1024, the
//   step from 8 K-rows to the next 8; LBO = the byte distance from one
//   64-column chunk of M or N to the next.  k-step i starts at the tile +
//   16 x 128 i = 2048 i bytes.
//
// tf32 (wgmma .tf32): both operands K-major from shared memory, each
// element an f32 word of which the product takes the sign, the exponent and
// the upper 10 mantissa bits.  What becomes of the lower 13 (dropped or
// rounded) is not relied on here: the 3xTF32 kernels hand wgmma only words
// whose lower 13 bits are 0 (split_tf32 below).  A row of 128 bytes is 32
// f32, four k-steps of 8.  There is no transpose bit, so an operand stored
// MN-major cannot be read: x (N, K) and a weight block (bm, bk), both
// row-major, are K-major as stored, but w (K, N) of a dense product is not,
// and dense_matmul.cu writes its tf32 parts out K-major as it splits it.
//
// A tensor map is built on the host for each launch and passed by value as
// a `const __grid_constant__ CUtensorMap` kernel parameter.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums; nothing is linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (so
// nothing links against libcuda); null if the driver does not have it.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a contiguous, row-major bf16 (or, with `type`, f32) array
// of `rank` (2 or 3) dimensions, dims[0] the contiguous one (so dims are
// innermost first), read in boxes of box[0] x box[1] (x box[2]) elements
// with the 128-byte swizzle; box[0] x the element size is 128 bytes (one
// swizzle row).  Elements of a box outside the array are filled with zeros.
// The base must be 16-byte aligned and dims[0] x the element size a
// multiple of 16 (16-byte row strides).  Returns 0, or a cudaError_t.
static int make_tensor_map(CUtensorMap* map, const void* base, int rank,
                           const uint64_t* dims, const uint32_t* box,
                           CUtensorMapDataType type =
                               CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t gbox[3], estride[3] = {1, 1, 1};
  uint64_t bytes = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    gbox[i] = box[i];
    if (i > 0) gstride[i - 1] = bytes;
    bytes *= dims[i];
  }
  CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), gdim,
                  gstride, gbox, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// device: shared-memory addresses and mbarriers
// ---------------------------------------------------------------------------

// cvta.to.shared: the 32-bit shared-memory address of a generic pointer
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// mbarrier.init.shared::cta.b64: a phase completes after `count` arrivals
// (and the transaction bytes announced by arrive_expect_tx)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// fence.mbarrier_init.release.cluster: the inits are visible to TMA
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// mbarrier.arrive.expect_tx.shared::cta.b64: arrive, and expect `bytes`
// more from TMA copies before this phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// mbarrier.arrive.shared::cta.b64: one arrival
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// mbarrier.try_wait.parity.shared::cta.b64 in a loop: wait until the phase
// of parity `parity` has completed (a fresh barrier is in phase 0, so a
// wait on parity 1 returns at once)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bar.sync id, count: the `count` threads (a multiple of 32) that name
// barrier `id` (1-15; 0 is __syncthreads) wait for each other
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// device: TMA loads and the async-proxy fence
// ---------------------------------------------------------------------------

// cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes:
// the box of `map` at element coordinates (c0, c1), innermost first, into
// shared memory at `dst`; its bytes complete on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes:
// as tma_load_2d, at coordinates (c0, c1, c2)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// fence.proxy.async.shared::cta: order this thread's ordinary writes to
// shared memory before later TMA or wgmma accesses of it (a tile written
// only by TMA needs no such fence; the 3xTF32 block-sparse FC writes its
// split operands back and fences them)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// The wgmma matrix descriptor of a 128-byte-swizzled tile at shared address
// `addr`, with leading and stride byte offsets `lbo` and `sbo` (the rules
// are at the top of this file):
//   bits  0-13 addr >> 4,  16-29 lbo >> 4,  32-45 sbo >> 4,
//   bits 49-51 base offset 0,  62-63 layout 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// wgmma.fence.sync.aligned: registers written before it (accumulators, A
// fragments) are seen by the wgmma issued after it
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// wgmma.commit_group.sync.aligned: the wgmma issued so far form one group
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wgmma.wait_group.sync.aligned N: wait until at most N groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// An empty asm on each register: the compiler may not move reads or
// writes of `d` across the wgmma fence, commit or wait beside it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// setmaxnreg.dec.sync.aligned.u32: the warpgroup gives up registers, down
// to R a thread
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// setmaxnreg.inc.sync.aligned.u32: the warpgroup takes registers, up to R
// a thread (it waits until others have given enough up)
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16, A and B from shared
// memory: d (64 x 128, f32) = A (64 x 16) B (16 x 128) + (scale_d ? d : 0),
// B read K-major (TRANS_B = 0) or MN-major (TRANS_B = 1).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16, A from registers
// (four 32-bit registers of bf16 pairs a thread, laid out as 16 columns of
// the f32 accumulator) and B from shared memory, read K-major (TRANS_B = 0)
// or MN-major (TRANS_B = 1): d (64 x 64, f32) = A B + (scale_d ? d : 0).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

// wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16, A from registers
// (four 32-bit registers of bf16 pairs a thread, laid out as 16 columns of
// the f32 accumulator) and B from shared memory, read K-major (TRANS_B = 0)
// or MN-major (TRANS_B = 1): d (64 x 128, f32) = A B + (scale_d ? d : 0).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

// wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32, A and B from shared
// memory, both K-major (tf32 has no transpose bit): d (64 x 128, f32) =
// A (64 x 8) B (8 x 128) + (scale_d ? d : 0), each f32 element of A and B
// read as tf32 (the rules at the top of this file).
__device__ __forceinline__ void wgmma_m64n128k8_tf32_ss(float (&d)[64],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32, A and B from shared
// memory, both K-major: d (64 x 64, f32) = A (64 x 8) B (8 x 64) +
// (scale_d ? d : 0), each f32 element read as tf32 (ssd_intra.cu: the SSD
// cell's 64 x 64 tiles of G, y and S).
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float (&d)[32],
                                                      uint64_t desc_a,
                                                      uint64_t desc_b,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// device: thread block clusters
// ---------------------------------------------------------------------------

// barrier.cluster.arrive + barrier.cluster.wait (release, then acquire):
// every thread of every CTA of the cluster waits for all the others, and
// what each wrote to shared memory before is seen by reads after it from any
// CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" :::
                   "memory");
}

// mapa.shared::cluster.u32 + ld.shared::cluster.v4.f32: the four f32 at
// shared address `addr` (a CTA-local address, the same in every CTA of the
// kernel) of the cluster's CTA `rank`
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr,
                                                uint32_t rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// device: the 3xTF32 split (sparse_fc.cu, dense_matmul.cu, ssd_intra.cu)
// ---------------------------------------------------------------------------

// a rounded to tf32 (11 significant bits, ties away from zero): its lower
// 13 mantissa bits rounded off into the bits above and cleared
__device__ __forceinline__ float tf32_rn(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xFFFFE000u);
}

// The two tf32 parts of the four words a: hi = tf32(a), lo = tf32(a - hi)
__device__ __forceinline__ void split_tf32(const float4& a, float4& hi,
                                           float4& lo) {
  hi = make_float4(tf32_rn(a.x), tf32_rn(a.y), tf32_rn(a.z), tf32_rn(a.w));
  lo = make_float4(tf32_rn(a.x - hi.x), tf32_rn(a.y - hi.y),
                   tf32_rn(a.z - hi.z), tf32_rn(a.w - hi.w));
}

// Split the four words at raw[i]: hi = tf32(a) back in place, lo =
// tf32(a - hi) to lo[i]
__device__ __forceinline__ void split_tf32(float4* raw, float4* lo, int i) {
  float4 h, l;
  split_tf32(raw[i], h, l);
  lo[i] = l;
  raw[i] = h;
}

}  // namespace hopper
