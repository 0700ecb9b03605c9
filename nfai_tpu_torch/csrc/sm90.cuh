// Device and host pieces that K1 (q4_matmul.cu), K6 (q8_matmul.cu), K11
// (dense_matmul.cu), K12 (q8v3_matmul.cu), K4 (prefill_attention.cu),
// K2 / K7 (decode_attn.cuh: cp.async rings, ldmatrix, movmatrix, the
// cluster launch), K5 (fused_mlp.cu: cp.async rings and ldmatrix at
// decode, K1's tiles and 4-bit decode above) and K8 / K9 (grouped_matmul.cu:
// the same at decode, K1's and K6's tiles and epilogue above) share: the tensor-core GEMV's mma.sync and operand shuffles, the wgmma
// tiles' mbarrier ring, TMA copies (2-D, and 3-D for K4's K/V tiles) and
// register-A (K1, K6, K12; K4's P with an MN-major B) and shared-memory-A
// (K11, K4's Q K^T) wgmma, the GEMV's
// launch rule (K slices by the SM count), and the tiles' K split, launch
// rule and epilogue (K6, K11 and K12). kernels.py hashes
// every header of csrc/ into each library's name, so an edit here rebuilds
// them all.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ void bf16x8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t lop3_and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;  // (a & b) | c: the LUT of f(0xF0, 0xCC, 0xAA) is 0xEA
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr uint32_t BF16X2_ONE = 0x3F803F80u;

__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Lane t of a quad holds the 16 bytes (words 0..3) of block t of a row;
// afterwards it holds word t of blocks 0..3: a 4 x 4 transpose in two
// rounds of shuffles (swap the off-diagonal 2 x 2 blocks, then inside them)
__device__ __forceinline__ void quad_transpose(const uint4& v, int t, uint32_t (&w)[4]) {
  uint32_t a0 = v.x, a1 = v.y, a2 = v.z, a3 = v.w;
  const bool hi = t & 2, od = t & 1;
  uint32_t s0 = __shfl_xor_sync(0xffffffffu, hi ? a0 : a2, 2);
  uint32_t s1 = __shfl_xor_sync(0xffffffffu, hi ? a1 : a3, 2);
  if (hi) { a0 = s0; a1 = s1; } else { a2 = s0; a3 = s1; }
  s0 = __shfl_xor_sync(0xffffffffu, od ? a0 : a1, 1);
  s1 = __shfl_xor_sync(0xffffffffu, od ? a2 : a3, 1);
  if (od) { a0 = s0; a2 = s1; } else { a1 = s0; a3 = s1; }
  w[0] = a0; w[1] = a1; w[2] = a2; w[3] = a3;
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// 16 bytes, or 16 zero bytes where !ok (no byte of src is read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest N of this thread's cp.async groups has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices: lanes 8m..8m+7 give the 16-byte rows of matrix
// m; lane (g, t) receives bytes 4t..4t+3 of row g of each (K5's code words)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p))
               : "memory");
}

// four 8 x 8 bf16 matrices, transposed: lanes 8m..8m+7 give the 16-byte rows
// of matrix m; lane (g, t) receives rows 2t and 2t + 1 of column g of each
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p))
               : "memory");
}

// an 8 x 8 bf16 matrix in the mma fragment layout (lane (g, t): row g,
// columns 2t and 2t + 1) → its transpose in the same layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// ---------------------------------------------------------------------------

constexpr int GV_WARPS = 8;  // warps a GEMV block, 16 weight rows each

// the current device's SM count, read once (132 on an H100 SXM)
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (!cached) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

// K slices a block for M <= 8 (each warp 16 rows): the fewest that give
// every SM a block, each slice keeping at least 256 codes (measured on K1:
// fewer, longer slices stream better once the card is covered)
int gemv_ks(int K, int N, int sms) {
  int ks = 1;
  while (ks < GV_WARPS && (N + (GV_WARPS / ks) * 16 - 1) / ((GV_WARPS / ks) * 16) < sms &&
         K / (2 * ks) >= 256)
    ks *= 2;
  return ks;
}

// ---------------------------------------------------------------------------
// the wgmma tiles: mbarriers, TMA, register-A wgmma

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// the copies this thread issued so far arrive on `bar` when they land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const int n = ok ? 4 : 0;  // 0 source bytes: zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major operand tile with 128-byte rows under the
// 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (uint64_t(1024 >> 4) << 32) | (1ull << 62);
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
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void pin(uint32_t (&a)[4], uint64_t& d) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+l"(d)::"memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
}

// the register-A form: A (64 rows) in registers, B under a descriptor,
// K-major (TB = 0) or MN-major (TB = 1: wgmma's transpose-B, N contiguous
// in shared memory, as K4's V tile)
template <int BM, int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[BM / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (BM == 16) wgmma_rs_n16<TB>(d, a, desc);
  else if constexpr (BM == 32) wgmma_rs_n32<TB>(d, a, desc);
  else if constexpr (BM == 64) wgmma_rs_n64<TB>(d, a, desc);
  else if constexpr (BM == 128) wgmma_rs_n128<TB>(d, a, desc);
  else wgmma_rs_n256<TB>(d, a, desc);
}

// the code at bit p of w (a nibble) → 128 + code as f32, exactly
template <int P>
__device__ __forceinline__ float nib128(uint32_t w) {
  const uint32_t v = P <= 16 ? (w << (16 - P)) : (w >> (P - 16));
  return __uint_as_float((v & 0x000F0000u) | 0x43000000u);
}

// The 4-bit register-A decode (K1's tiles, K5's): the A fragment of one
// k16 step (half H of a 32-block) for rows g (w0, s0, c0)
// and g + 8 (w1, s1, c1): bf16(s * q - m) = bf16(s * (128 + q) + c), c = -(m + 128 s).
// w holds bytes 2t, 2t+1, 2t+8, 2t+9 of the block: k = 2t, 2t+1 | 2t+8, 2t+9.
template <int H>
__device__ __forceinline__ void decode_a(uint32_t w0, uint32_t w1, float s0, float c0, float s1,
                                         float c1, uint32_t (&a)[4]) {
  constexpr int p = 4 * H;
  __nv_bfloat162 v;
  v = __floats2bfloat162_rn(fmaf(s0, nib128<p>(w0), c0), fmaf(s0, nib128<p + 8>(w0), c0));
  a[0] = *reinterpret_cast<uint32_t*>(&v);
  v = __floats2bfloat162_rn(fmaf(s1, nib128<p>(w1), c1), fmaf(s1, nib128<p + 8>(w1), c1));
  a[1] = *reinterpret_cast<uint32_t*>(&v);
  v = __floats2bfloat162_rn(fmaf(s0, nib128<p + 16>(w0), c0), fmaf(s0, nib128<p + 24>(w0), c0));
  a[2] = *reinterpret_cast<uint32_t*>(&v);
  v = __floats2bfloat162_rn(fmaf(s1, nib128<p + 16>(w1), c1), fmaf(s1, nib128<p + 24>(w1), c1));
  a[3] = *reinterpret_cast<uint32_t*>(&v);
}

// the shared-memory-A (SS) form: A and B both K-major tiles in shared memory
// under descriptors (K11, whose weight needs no decode; K4's Q K^T)
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BM>
__device__ __forceinline__ void wgmma_ss(float (&d)[BM / 2], uint64_t da, uint64_t db) {
  if constexpr (BM == 16) wgmma_ss_n16(d, da, db);
  else if constexpr (BM == 32) wgmma_ss_n32(d, da, db);
  else if constexpr (BM == 64) wgmma_ss_n64(d, da, db);
  else if constexpr (BM == 128) wgmma_ss_n128(d, da, db);
  else wgmma_ss_n256(d, da, db);
}

// wgmma descriptor of an MN-major operand under the 128-byte swizzle (K4's
// V tile as B: K = keys, N = d): rows of 128 bytes along N (64 bf16), the
// 8-row K groups 1024 bytes apart (the stride byte offset), the 64-wide N
// blocks `lbo` bytes apart (the leading byte offset; for a K-major tile
// under this swizzle the leading offset is unused)
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p, uint32_t lbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t((lbo & 0x3FFFF) >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (1ull << 62);
}

// a TMA map of a row-major tensor of 2 or 3 dimensions, dims[0] the
// contiguous one: boxes of box[0] x box[1] (x box[2]), elements past the
// edges read as zero
cudaError_t tensor_map_nd(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* p, int rank,
                          const uint64_t* dims, const uint32_t* box, CUtensorMapSwizzle swz) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &q);
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || !encode)
      return err != cudaSuccess ? err : cudaErrorNotSupported;
  }
  cuuint64_t gdims[3], strides[2];
  cuuint32_t gbox[3];
  const cuuint32_t one[3] = {1, 1, 1};
  cuuint64_t stride = static_cast<cuuint64_t>(elem);
  for (int i = 0; i < rank; ++i) {
    gdims[i] = dims[i];
    gbox[i] = box[i];
    if (i > 0) strides[i - 1] = stride;
    stride *= dims[i];
  }
  const CUresult r = encode(map, type, rank, const_cast<void*>(p), gdims, strides, gbox, one,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a 2-D TMA map of a row-major [rows, cols] tensor: boxes of box_cols x
// box_rows, elements past the edges read as zero
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* p,
                       int rows, int cols, int box_cols, int box_rows, CUtensorMapSwizzle swz) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint32_t box[2] = {static_cast<uint32_t>(box_cols), static_cast<uint32_t>(box_rows)};
  return tensor_map_nd(map, type, elem, p, 2, dims, box, swz);
}

// the tiles' split: the K split doubles the blocks and halves each one's
// stages; it pays where the row split's grid is short of three waves of one
// block an SM and splitting saves half a wave (measured on K1: faster at 24
// to 64 blocks, 192 and 320, slower at 128 and 256)
bool tiles_k_split(int blocks, int sms) {
  const int waves = (blocks + sms - 1) / sms, waves_split = (2 * blocks + sms - 1) / sms;
  return blocks <= 3 * sms && waves_split <= 2 * waves - 1;
}


// ---------------------------------------------------------------------------
// the tiles of K6, K11 and K12: y^T = W x^T on 128 weight rows a block (64 with
// the two-group K split), two consumer warpgroups and one producer warp

constexpr int T8_ROWS = 128;                // weight rows a block without the two-group split
constexpr int T8_THREADS = 2 * 128 + 32;    // two consumer warpgroups, one producer warp
constexpr int T8_OUT_PITCH = T8_ROWS + 8;   // bf16 a row of the y tile in shared memory

// the K split across a cluster of blocks (1, 2, 4 or 8 of them, each with
// its share of K, their partial sums met in distributed shared memory):
// doubled while that cuts the waves of blocks on the SMs by a fifth, each
// slice keeping at least `least` codes
int cluster_split(int blocks, int K, int sms, int least) {
  const auto waves = [&](int c) { return float((blocks * c + sms - 1) / sms) / c; };
  int c = 1;
  while (c < 8 && K / (2 * c) >= least && waves(2 * c) <= 0.8f * waves(c)) c *= 2;
  return c;
}

// a kernel launched in clusters of `cluster` blocks along x
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), dim3 grid, int threads, int smem, int cluster,
                             cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The split of a tile width BM: where the row tiles leave SMs idle, K is
// split: at widths up to 64 across a cluster of blocks (`cluster_split`);
// at 128 and 256, whose partial sums are four and eight times larger, first
// between the two groups of a block of 64 rows (`tiles_k_split`, measured
// faster at 128 than a cluster of 128-row blocks), then across a cluster
// of such blocks.
// Calls launch(KS, CL, ks) with KS and CL as std::bool_constant.
template <int BM, typename Launch>
cudaError_t tile_split(int M, int K, int N, Launch&& launch) {
  using Y = std::true_type;
  using No = std::false_type;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int blocks = (N + T8_ROWS - 1) / T8_ROWS * ((M + BM - 1) / BM);
  if constexpr (BM >= 128) {
    if (tiles_k_split(blocks, sms)) {  // 1024 codes a slice: K6's wv at M = 256 ran
      const int ks = cluster_split(2 * blocks, K, sms, 1024);  // slower with 8 slices of 256
      return ks > 1 ? launch(Y{}, Y{}, ks) : launch(Y{}, No{}, 1);
    }
    return launch(No{}, No{}, 1);
  } else {
    const int ks = cluster_split(blocks, K, sms, 256);
    return ks > 1 ? launch(No{}, Y{}, ks) : launch(No{}, No{}, 1);
  }
}

// The tiles' epilogue, by every thread of the block (the producer warp of a
// block without a cluster has left). D fragment: acc[4i + e] = weight row
// r0 (+8 for e >= 2), x row 8i + 2t (+1 for odd e) of the tile. With KS the
// two groups hold sums of the same 64 rows (group 1's are added to group
// 0's); without CL the D tile is transposed through shared memory into
// rows of y, else the slices' sums are met in distributed shared memory.
template <int BM, bool KS, bool CL>
__device__ __forceinline__ void tile_epilogue(float (&acc)[BM / 2], unsigned char* tsm, int r0, int n0,
                                              int m0, int M, int N, __nv_bfloat16* __restrict__ y) {
  namespace cg = cooperative_groups;
  constexpr int RB = KS ? 64 : T8_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2, t = lane & 3;
  if constexpr (!CL) {  // through shared memory into rows of y
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(tsm);  // [BM][T8_OUT_PITCH]
    if (warp < 8) {
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both groups are done with the stages
      if constexpr (KS) {  // group 1's sums, in its fragment order, onto group 0's
        float* part = reinterpret_cast<float*>(tsm + BM * T8_OUT_PITCH * 2);
        float* mine = part + (warp & 3) * (BM / 2) * 32 + lane;
        if (wg == 1) {
#pragma unroll
          for (int i = 0; i < BM / 2; ++i) mine[i * 32] = acc[i];
        }
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        if (wg == 0) {
#pragma unroll
          for (int i = 0; i < BM / 2; ++i) acc[i] += mine[i * 32];
        }
      }
      if (!KS || wg == 0) {
#pragma unroll
        for (int i = 0; i < BM / 8; ++i) {
          const int m = 8 * i + 2 * t;
          out[m * T8_OUT_PITCH + r0] = __float2bfloat16(acc[4 * i]);
          out[(m + 1) * T8_OUT_PITCH + r0] = __float2bfloat16(acc[4 * i + 1]);
          out[m * T8_OUT_PITCH + r0 + 8] = __float2bfloat16(acc[4 * i + 2]);
          out[(m + 1) * T8_OUT_PITCH + r0 + 8] = __float2bfloat16(acc[4 * i + 3]);
        }
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      const bool vec = (N & 7) == 0 && n0 + RB <= N;
      for (int e = tid; e < BM * (RB / 8); e += 256) {  // 16 bytes (8 columns) a thread
        const int m = e / (RB / 8), c = 8 * (e % (RB / 8));
        if (m0 + m >= M) continue;
        const __nv_bfloat16* src = out + m * T8_OUT_PITCH + c;
        __nv_bfloat16* dst = y + (size_t)(m0 + m) * N + n0 + c;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int j = 0; j < 8 && n0 + c + j < N; ++j) dst[j] = src[j];
        }
      }
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    const int ks = cluster.num_blocks(), slice = cluster.block_rank();
    // the slices' sums, each thread's in its fragment order, met in
    // distributed shared memory: slice s adds the s-th share of the block's
    // sums over the slices in order, every slice's float4 in flight at once
    constexpr int WARPS = KS ? 4 : 8;  // the warps that hold the block's sums
    float* part = reinterpret_cast<float*>(tsm);  // [WARPS][BM / 2][32 lanes]
    cluster.sync();  // every block of the cluster is done with its stages
    if (KS && warp < 8) {  // group 1's sums, in its fragment order, onto group 0's
      float* mine = part + (WARPS + (warp & 3)) * (BM / 2) * 32 + lane;
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) mine[i * 32] = acc[i];
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) acc[i] += mine[i * 32];
      }
    }
    if (warp < WARPS) {
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) part[(warp * (BM / 2) + i) * 32 + lane] = acc[i];
    }
    cluster.sync();
    const float4* parts[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      parts[k] = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, k < ks ? k : 0));
    const int f4 = WARPS * 4 * BM / ks;
    for (int f = slice * f4 + tid; f < (slice + 1) * f4; f += T8_THREADS) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < ks) v[k] = parts[k][f];
      float sum[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
      for (int k = 1; k < 8; ++k) {
        if (k < ks) {
          sum[0] += v[k].x;
          sum[1] += v[k].y;
          sum[2] += v[k].z;
          sum[3] += v[k].w;
        }
      }
      // entries 4f..4f+3: warp w, fragment entry i, lanes (g, t = 0..3)
      const int e = 4 * f, w = e / (16 * BM), i = (e >> 5) % (BM / 2), g0 = (e & 31) >> 2;
      const int n = n0 + 64 * (w >> 2) + 16 * (w & 3) + g0 + 8 * ((i >> 1) & 1);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + 8 * (i >> 2) + 2 * c + (i & 1);
        if (m < M && n < N) y[(size_t)m * N + n] = __float2bfloat16(sum[c]);
      }
    }
    cluster.sync();  // no block leaves while another reads its sums
  }
}

}  // namespace
