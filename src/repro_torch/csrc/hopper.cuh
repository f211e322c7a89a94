// Hopper building blocks of the tensor-core attention kernels
// (flash_attention_tc.cu, flash_backward_tc.cu, flash_prefill_paged_tc.cu)
// and the bulk-copy decode kernel (flash_decode_bulk.cu): TMA tile loads
// and 1-D bulk copies completed on mbarriers, wgmma shared-memory
// descriptors, and the wgmma instructions the kernels issue, with their
// operand lists spelled out.
//
// Tiles are bf16, staged by TMA with CU_TENSOR_MAP_SWIZZLE_128B in panels
// of 64 columns (128 bytes a row, rows contiguous) whose bases are 1024-byte
// aligned. One panel serves wgmma both ways:
//   K-major (the reduction runs along the row): a k16 step starts 32 bytes
//     further along the row; 8-row groups are 1024 bytes apart (SBO).
//   MN-major (the reduction runs down the rows; the transpose bit): a k16
//     step starts 16 rows (2048 bytes) further down; the next 64 columns are
//     the next panel (LBO = the panel's size), the next 8 rows 1024 bytes on
//     (SBO).
#pragma once

#include <cuda.h>             // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ---- shared memory, mbarriers, TMA ----------------------------------------

__device__ __forceinline__ uint32_t hop_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to the 1024-byte alignment of the
// 128-byte swizzle (launches allocate 1024 bytes of slack for it).
__device__ __forceinline__ uint8_t* hop_align1024(uint8_t* p) {
  const uint32_t a = hop_smem(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void hop_mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(hop_smem(bar)), "r"(count) : "memory");
}

// Make barrier initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void hop_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void hop_mbar_expect_tx(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(hop_smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void hop_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(hop_smem(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity `phase`. A wait
// of seconds can only be a lost transfer or a wrong arrival count: trap, so
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void hop_mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t addr = hop_smem(bar);
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(phase) : "memory");
    if (done) return;
    if (spin == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 33))
      __trap();
  }
}

// One box of a 3-D tensor map, coordinates (column, row, head), into
// shared memory; completes `bytes` of the barrier's transaction count.
__device__ __forceinline__ void hop_tma_load(void* dst, const CUtensorMap* map,
                                             uint64_t* bar, int col, int row,
                                             int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(hop_smem(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(row), "r"(head), "r"(hop_smem(bar))
      : "memory");
}

// One box of a 4-D tensor map, coordinates (column, row, head, block), into
// shared memory; completes the box's bytes of the barrier's transaction
// count (out-of-range coordinates deliver zeros and count all the same).
__device__ __forceinline__ void hop_tma_load_4d(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int col,
                                                int row, int head,
                                                int block) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(hop_smem(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(row), "r"(head), "r"(block), "r"(hop_smem(bar))
      : "memory");
}

// A 1-D bulk copy of `bytes` contiguous bytes (a multiple of 16, both ends
// 16-byte aligned) from device memory into shared memory, no tensor map;
// completes `bytes` of the barrier's transaction count. The lines are
// marked evict-first in L2: a stream read once.
__device__ __forceinline__ void hop_bulk_load(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], pol;\n}"
      :: "r"(hop_smem(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(hop_smem(bar))
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled tile: start address, leading and stride
// byte offsets in 16-byte units, layout 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t hop_desc(const void* p, uint32_t lbo,
                                             uint32_t sbo) {
  return static_cast<uint64_t>((hop_smem(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Register rebalancing between warpgroups: the producer gives registers
// back, the consumers take them (a warpgroup executes it together).
template <int R>
__device__ __forceinline__ void hop_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void hop_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(R));
}

__device__ __forceinline__ void hop_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void hop_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void hop_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Pin registers that an in-flight wgmma reads or writes: the compiler may
// neither move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void hop_fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int K>
__device__ __forceinline__ void hop_fence_regs(uint32_t (&r)[3][K][4]) {
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        asm volatile("" : "+r"(r[t][i][j]) :: "memory");
}

// Split f32 x into three bf16 terms: hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid), each difference exact in f32. Each term takes 8
// of x's 24 significant bits, so hi + mid + lo equals x exactly for
// |x| >= 2^-110 (within 2^-134, half bf16's smallest subnormal, below): a
// product of x with a bf16 value is three exact products. The pair hi + lo
// alone leaves up to 2^-16 |x|, which shows where a few such products
// cancel. Pairs (x0, x1) are neighbouring columns, packed as the A fragment
// of a register-A wgmma.
__device__ __forceinline__ void hop_split3(float x0, float x1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - __low2float(m),
                                                 r1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A score-layout f32 tile x (an m64 x n(16K) accumulator fragment) as the
// three bf16 A operands of K k16 steps: f[t][k] is term t of step k.
template <int K>
__device__ __forceinline__ void hop_split_frags(const float (&x)[8 * K],
                                                uint32_t (&f)[3][K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      hop_split3(x[8 * k + 2 * r], x[8 * k + 2 * r + 1], f[0][k][r],
                 f[1][k][r], f[2][k][r]);
}

// The accumulator fragment of an m64nN f32 wgmma: thread t of warp w of the
// warpgroup holds, for each 8-column chunk j, d[4j], d[4j+1] at row
// 16w + t/4, columns 8j + 2(t%4) + {0, 1}, and d[4j+2], d[4j+3] at row
// 16w + t/4 + 8. A k16 step of a register A takes the pairs d[8k .. 8k+7]
// of that layout, so a score tile becomes the next product's A in place.
template <int N>
struct HopMma;

template <>
struct HopMma<32> {
  // d (m64 x n32) += A·B, A and B K-major bf16 tiles in shared memory;
  // scale_d == 0 overwrites d.
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15},"
        " %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct HopMma<64> {
  // d (m64 x n64) += A·B, A and B K-major bf16 tiles in shared memory;
  // scale_d == 0 overwrites d.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }

  // d (m64 x n64) += A·B, A a bf16 fragment in registers (the layout of
  // the f32 accumulator's pairs), B an MN-major bf16 tile in shared memory;
  // scale_d == 0 overwrites d.
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct HopMma<128> {
  // d (m64 x n128) += A·B, A a bf16 fragment in registers (the layout of
  // the f32 accumulator's pairs), B an MN-major bf16 tile in shared memory;
  // scale_d == 0 overwrites d.
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};
// ---- host: tensor maps ------------------------------------------------------

typedef CUresult (*HopEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime (no
// -lcuda at link time).
static HopEncodeTiled hop_encoder() {
  static HopEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<HopEncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a contiguous bf16 tensor (heads, rows, D), read in boxes of
// 64 columns x box_rows rows of one head with the 128-byte swizzle. Rows
// past `rows` and columns past D are zero-filled, so ragged tiles and head
// dims below 64 reach the tensor cores padded with zeros.
static cudaError_t hop_map_rows(CUtensorMap* map, const void* base,
                                int heads, int rows, int D, int box_rows) {
  const HopEncodeTiled encode = hop_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map of a contiguous bf16 paged pool (blocks, heads, BS, D), read in
// boxes of 64 columns x BS rows of one (block, head) with the 128-byte
// swizzle: one pool block of one head per box. Columns past D and blocks
// past `blocks` are zero-filled.
static cudaError_t hop_map_pool(CUtensorMap* map, const void* base,
                                int blocks, int heads, int BS, int D) {
  const HopEncodeTiled encode = hop_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(BS),
      static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(blocks)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * BS, row * BS * heads};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(BS), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
