// K6: 8-bit dequant-matmul, y[M, N] = x[M, K] @ W^T with
//     W[n, k] = scales[n, k/g] * q[n, k] (- mins[n, k/g])   (bf16 in/out, f32 math),
//     g = 16 or 32, mins optional.
//
// Replaces the Pallas kernels nfai_tpu/ops/qmatmul.py::_q8_matmul (2-D:
// 8-bit LM heads, tied Q6_K tables, Q8_0 prefill projections; mins
// subtracted outside the kernel) and ::_q8_matmul_layered (layer-stacked:
// Q8_0 layers, Q6_K attn_v/ffn_down of Q4_K_M files; mins inside). Both
// compute the same function; here the mins are folded into the dequantized
// weight for both, and a layer of a stack is a pointer offset, so one kernel
// serves both entry points (the wrapper passes the layer's view).
//
// Weight layout (nfai_tpu_torch/ops/qtensor.py, Q8Tensor), N-major like GGUF:
//   qs     int8 [N, K] (Q6_K's q-32, Q8_0's q, Q5_K/Q2_K's unsigned values);
//   scales float [N, K/g], mins float [N, K/g] or null.
//
// What bounds it on an H100: decode (M <= 8) streams 1 byte of q plus
// 4/g (or 8/g with mins) bytes of scales per weight: 1.25 B/weight for Q6_K,
// 1.125 for Q8_0; M = 1 is bound by HBM bytes, M = 8 does (3 + 2M) f32 ops
// per weight and sits near the CUDA-core limit. Prefill (M > 8) is bound by
// operations. The scale product is f32 (int8 times a bf16 scale would round
// the scale to 8 bits first).
//
// Design, as K1: M <= 8 takes a GEMV: one warp per output column, each lane
// decodes one 32-element chunk (two 16-byte loads) per step and multiplies
// it against up to 8 rows of x read through the read-only cache. M > 8 takes
// a tiled kernel: 64x64 output tiles, the 64x32 weight tile dequantized into
// shared memory as bf16 (f32 scale product, then one rounding) and both
// operands through tensor cores (WMMA 16x16x16 bf16, f32 accumulate).
// wgmma, TMA and a pipelined producer are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void bf16x8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void i8x16(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xFFu));
}

constexpr int GEMV_WARPS = 8;

template <int MR>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
q8_gemv_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
               const int8_t* __restrict__ qs, const float* __restrict__ sc,
               const float* __restrict__ mn, __nv_bfloat16* __restrict__ y,
               int N, int gshift) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  if (n >= N) return;
  const int nc = K >> 5;  // 32-element chunks per row
  const int ng = K >> gshift;
  const uint4* qrow = reinterpret_cast<const uint4*>(qs + (size_t)n * K);
  const float* srow = sc + (size_t)n * ng;
  const float* mrow = mn ? mn + (size_t)n * ng : nullptr;
  float acc[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m] = 0.f;

  for (int c = lane; c < nc; c += 32) {
    const uint4 q2[2] = {__ldg(qrow + 2 * c), __ldg(qrow + 2 * c + 1)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // h = 0: elements 0..15 of the chunk, 1: 16..31
      const int gi = (c * 32 + 16 * h) >> gshift;
      const float s = __ldg(srow + gi), mi = mrow ? -__ldg(mrow + gi) : 0.f;
      float w[16];
      i8x16(q2[h], w);
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = fmaf(s, w[i], mi);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        if (m < M) {
          const uint4* xr = reinterpret_cast<const uint4*>(
              x + (size_t)m * K + (size_t)c * 32 + h * 16);
          float xf[16];
          bf16x8(__ldg(xr), xf);
          bf16x8(__ldg(xr + 1), xf + 8);
          float a = acc[m];
#pragma unroll
          for (int i = 0; i < 16; ++i) a = fmaf(xf[i], w[i], a);
          acc[m] = a;
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    float a = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0 && m < M) y[(size_t)m * N + n] = __float2bfloat16(a);
  }
}

constexpr int TM = 64, TN = 64, TK = 32, LDS = TK + 8, LDC = TN + 4;

__global__ void __launch_bounds__(128)
q8_mma_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
              const int8_t* __restrict__ qs, const float* __restrict__ sc,
              const float* __restrict__ mn, __nv_bfloat16* __restrict__ y,
              int N, int gshift) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 xs[TM * LDS];  // A tile, row-major
  __shared__ __align__(32) __nv_bfloat16 ws[TN * LDS];  // W tile [n][k] = B col-major
  __shared__ __align__(32) float cs[TM * LDC];          // epilogue staging
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int nc = K >> 5, ng = K >> gshift;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int kc = 0; kc < nc; ++kc) {
    {  // x tile: 64 rows x 32 bf16; two threads per row, 16 elements each
      const int r = tid >> 1, c = (tid & 1) * 16;
      uint4 a = make_uint4(0, 0, 0, 0), b = a;
      if (m0 + r < M) {
        const uint4* src = reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * K + (size_t)kc * 32 + c);
        a = __ldg(src);
        b = __ldg(src + 1);
      }
      *reinterpret_cast<uint4*>(&xs[r * LDS + c]) = a;
      *reinterpret_cast<uint4*>(&xs[r * LDS + c + 8]) = b;
    }
    {  // weight tile: 16 int8 per thread, two threads per column
      const int c = tid >> 1, h = tid & 1;
      const size_t row = (size_t)(n0 + c);
      const uint4 q4 = __ldg(reinterpret_cast<const uint4*>(qs + row * K + (size_t)kc * 32 + 16 * h));
      const int gi = (kc * 32 + 16 * h) >> gshift;
      const float s = __ldg(sc + row * ng + gi), mi = mn ? -__ldg(mn + row * ng + gi) : 0.f;
      float w[16];
      i8x16(q4, w);
#pragma unroll
      for (int i = 0; i < 16; ++i) ws[c * LDS + h * 16 + i] = __float2bfloat16(fmaf(s, w[i], mi));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &xs[(wm + 16 * i) * LDS + kk], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &ws[(wn + 16 * j) * LDS + kk], LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&cs[(wm + 16 * i) * LDC + wn + 16 * j], acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < TM * TN; e += 128) {
    const int r = e / TN, c = e % TN;
    if (m0 + r < M) y[(size_t)(m0 + r) * N + n0 + c] = __float2bfloat16(cs[r * LDC + c]);
  }
}

}  // namespace

// x [M, K] bf16, qs [N, K] int8, scales/mins [N, K/group] f32 (mins may be
// null), y [M, N] bf16; group 16 or 32. Needs K % 32 == 0; the tiled path
// (M > 8) also needs N % 64 == 0.
extern "C" int nfai_q8_matmul(const void* x, const void* qs, const void* sc,
                              const void* mn, void* y, int M, int K, int N,
                              int group, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto q = static_cast<const int8_t*>(qs);
  auto s = static_cast<const float*>(sc);
  auto m = static_cast<const float*>(mn);
  auto yb = static_cast<__nv_bfloat16*>(y);
  if (group != 16 && group != 32) return static_cast<int>(cudaErrorInvalidValue);
  const int gshift = group == 16 ? 4 : 5;
  if (M <= 8) {
    dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS), block(GEMV_WARPS * 32);
    if (M == 1)
      q8_gemv_kernel<1><<<grid, block, 0, st>>>(xb, M, K, q, s, m, yb, N, gshift);
    else if (M == 2)
      q8_gemv_kernel<2><<<grid, block, 0, st>>>(xb, M, K, q, s, m, yb, N, gshift);
    else if (M <= 4)
      q8_gemv_kernel<4><<<grid, block, 0, st>>>(xb, M, K, q, s, m, yb, N, gshift);
    else
      q8_gemv_kernel<8><<<grid, block, 0, st>>>(xb, M, K, q, s, m, yb, N, gshift);
  } else {
    dim3 grid(N / TN, (M + TM - 1) / TM), block(128);
    q8_mma_kernel<<<grid, block, 0, st>>>(xb, M, K, q, s, m, yb, N, gshift);
  }
  return static_cast<int>(cudaGetLastError());
}
