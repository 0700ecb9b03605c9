// K8 / K9: grouped (MoE expert) dequant-matmul over group-aligned rows,
//
//   y[i*tm + t, :] = x[i*tm + t, :] @ W[block_group[i]]^T   for t < block_rows[i],
//   y = 0 on the other rows of block i (bf16 in/out, f32 math),
//
// W a stack of E expert weights in the port's containers
// (nfai_tpu_torch/ops/qtensor.py), N-major like GGUF:
//   K8 (4-bit): qs uint8 [E, N, K/2] (32-block b of row n is bytes
//       [16b, 16b+16); byte j holds element 32b+j low, 32b+16+j high),
//       scales/mins f32 [E, N, K/32]: W[e, n, k] = s * q - m;
//   K9 (8-bit): qs int8 [E, N, K], scales f32 [E, N, K/g], mins f32 or null,
//       g = 16 or 32: W[e, n, k] = s * q (- m).
//
// Replaces nfai_tpu/ops/qmatmul.py::_grouped_call via _qmatmul_grouped_q4
// (_q4g_kernel, K8) and _qmatmul_grouped_q8 (_q8g_kernel, K9). The TPU
// kernels walk the row blocks on a sequential grid and prefetch
// block_group as scalars into the weight BlockSpecs, so a run of blocks of
// one expert keeps its weight tiles in VMEM. Here blocks run in parallel in
// no order: each block loads its own group id and its own tiles, and
// nothing carries over between blocks. block_rows[i] (the real rows of
// block i, the rest being padding) lets a block skip its padding rows; the
// empty blocks past the last expert's padded rows (block_rows 0, their
// group clipped to expert E-1 as in the JAX layout) only write zeros and
// never read expert E-1's weights again.
//
// What bounds it on an H100: decode (tm = 8, one or two real rows per block)
// streams each hit expert's weights once per row block: 0.75 B/weight for
// K8, 1 B + 4/g (8/g with mins) for K9, so HBM bytes bound it (batch 1 of a
// Qwen3-30B-A3B layer: 8 experts x 3 matrices x 768 x 2048 weights). Prefill
// (tm = 32 or 128) does 2 * rows * K * N flops against one read of the hit
// experts: a 256-token chunk (2048 rows, every expert hit) is still bound by
// bytes there; operations take over from about 14k rows (1.7k tokens).
//
// Design: tm = 8 takes a GEMV like K1's M <= 8 path: one warp per output
// column of the block's expert, each lane decodes one 32-element chunk per
// step and multiplies it against the block's real rows of x (read through
// the read-only cache). tm % 32 == 0 takes a tiled kernel like K1's: 32x64
// output tiles inside one row block, the 64x32 weight tile of the block's
// expert dequantized into shared memory as bf16 (f32 scale product, then
// one rounding), both operands through tensor cores (WMMA 16x16x16 bf16,
// f32 accumulate); a tile wholly in the block's padding writes zeros
// without loading weights. Keeping an expert's tiles resident across its
// blocks (a persistent kernel over the blocks of one expert), wgmma and TMA
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float nib(uint32_t v) {
  // v in [0, 15] -> exactly (float)v
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

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

// The expert weight as the kernels read it: 16 consecutive dequantized
// values of row n (expert-local, 0..N-1 offset by the expert) starting at
// k = 32 * chunk + 16 * h.
struct Q4Stack {
  const uint8_t* qs;
  const float* sc;
  const float* mn;
  __device__ __forceinline__ void load16(size_t row, int K, int chunk, int h, float* w) const {
    const size_t blk = row * (K >> 5) + chunk;
    const uint4 w4 = __ldg(reinterpret_cast<const uint4*>(qs) + blk);
    const float s = __ldg(sc + blk), mi = -__ldg(mn + blk);
    const uint32_t wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      w[i] = fmaf(s, nib((wv[i >> 2] >> (8 * (i & 3) + 4 * h)) & 0xFu), mi);
  }
};

struct Q8Stack {
  const int8_t* qs;
  const float* sc;
  const float* mn;  // may be null
  int gshift;       // log2 of the scale group (4 or 5)
  __device__ __forceinline__ void load16(size_t row, int K, int chunk, int h, float* w) const {
    const int k0 = chunk * 32 + 16 * h;
    const uint4 q4 = __ldg(reinterpret_cast<const uint4*>(qs + row * K + k0));
    const size_t gi = row * (K >> gshift) + (k0 >> gshift);
    const float s = __ldg(sc + gi), mi = mn ? -__ldg(mn + gi) : 0.f;
    i8x16(q4, w);
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = fmaf(s, w[i], mi);
  }
};

__device__ __forceinline__ int real_rows(const int* block_rows, int blk, int tm) {
  const int r = __ldg(block_rows + blk);
  return r < 0 ? 0 : (r > tm ? tm : r);
}

constexpr int GEMV_WARPS = 8, GEMV_TM = 8;

// tm = 8: grid (ceil(N / 8), M / 8); warp w of block (bx, i) owns column
// n = 8 bx + w of row block i. At most 64 registers, so that four blocks
// (32 warps) stay resident per SM: the loop waits on its weight loads.
template <class W>
__global__ void __launch_bounds__(GEMV_WARPS * 32, 4)
grouped_gemv_kernel(const __nv_bfloat16* __restrict__ x, int K, W w,
                    const int* __restrict__ block_group, const int* __restrict__ block_rows,
                    __nv_bfloat16* __restrict__ y, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp, blk = blockIdx.y;
  if (n >= N) return;
  const int g = block_group[blk];
  // moe_group_layout gives no negative id; testing for one lets the compiler
  // keep the block's expert and row count in uniform registers (without the
  // test chip_smoke.py's K8/K9 decode cases ran 7-10% slower on an H100)
  const int rows = g < 0 ? 0 : real_rows(block_rows, blk, GEMV_TM);
  __nv_bfloat16* yb = y + (size_t)blk * GEMV_TM * N + n;
  if (lane >= rows && lane < GEMV_TM) yb[(size_t)lane * N] = __float2bfloat16(0.f);
  if (rows == 0) return;
  const size_t row = (size_t)g * N + n;  // the expert's row n
  const __nv_bfloat16* xb = x + (size_t)blk * GEMV_TM * K;
  float acc[GEMV_TM];
#pragma unroll
  for (int m = 0; m < GEMV_TM; ++m) acc[m] = 0.f;

  for (int c = lane; c < (K >> 5); c += 32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // h = 0: elements 0..15 of the chunk, 1: 16..31
      float wv[16];
      w.load16(row, K, c, h, wv);
#pragma unroll
      for (int m = 0; m < GEMV_TM; ++m) {
        if (m < rows) {
          const uint4* xr = reinterpret_cast<const uint4*>(xb + (size_t)m * K + (size_t)c * 32 + h * 16);
          float xf[16];
          bf16x8(__ldg(xr), xf);
          bf16x8(__ldg(xr + 1), xf + 8);
          float a = acc[m];
#pragma unroll
          for (int i = 0; i < 16; ++i) a = fmaf(xf[i], wv[i], a);
          acc[m] = a;
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < GEMV_TM; ++m) {
    if (m < rows) {
      float a = acc[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) yb[(size_t)m * N] = __float2bfloat16(a);
    }
  }
}

constexpr int TM = 32, TN = 64, TK = 32, LDS = TK + 8, LDC = TN + 4;

// tm % 32 == 0: grid (N / 64, M / 32); the 32-row tile lies in row block
// m0 / tm. Four warps, each a 16x32 quarter of the 32x64 tile.
template <class W>
__global__ void __launch_bounds__(128)
grouped_mma_kernel(const __nv_bfloat16* __restrict__ x, int K, W w,
                   const int* __restrict__ block_group, const int* __restrict__ block_rows,
                   __nv_bfloat16* __restrict__ y, int N, int tm) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 xs[TM * LDS];  // A tile, row-major
  __shared__ __align__(32) __nv_bfloat16 ws[TN * LDS];  // W tile [n][k] = B col-major
  __shared__ __align__(32) float cs[TM * LDC];          // epilogue staging
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int blk = m0 / tm;
  const int g = __ldg(block_group + blk);
  int rows = real_rows(block_rows, blk, tm) - (m0 - blk * tm);
  rows = rows < 0 ? 0 : (rows > TM ? TM : rows);
  if (rows == 0) {  // padding or an empty block: zeros, no weight read
    for (int e = tid; e < TM * TN; e += 128)
      y[(size_t)(m0 + e / TN) * N + n0 + e % TN] = __float2bfloat16(0.f);
    return;
  }
  const size_t erow = (size_t)g * N + n0;  // the expert's row n0
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int kc = 0; kc < (K >> 5); ++kc) {
    {  // x tile: 32 rows x 32 bf16; four threads per row, 8 elements each
      const int r = tid >> 2, c = (tid & 3) * 8;
      uint4 a = make_uint4(0, 0, 0, 0);
      if (r < rows)
        a = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + (size_t)kc * 32 + c));
      *reinterpret_cast<uint4*>(&xs[r * LDS + c]) = a;
    }
    {  // weight tile: two threads per column, 16 elements each
      const int c = tid >> 1, h = tid & 1;
      float wv[16];
      w.load16(erow + c, K, kc, h, wv);
#pragma unroll
      for (int i = 0; i < 16; ++i) ws[c * LDS + h * 16 + i] = __float2bfloat16(wv[i]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, &xs[wm * LDS + kk], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, &ws[(wn + 16 * j) * LDS + kk], LDS);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&cs[wm * LDC + wn + 16 * j], acc[j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < TM * TN; e += 128) {
    const int r = e / TN, c = e % TN;
    y[(size_t)(m0 + r) * N + n0 + c] = __float2bfloat16(r < rows ? cs[r * LDC + c] : 0.f);
  }
}

template <class W>
int launch(const void* x, W w, const void* block_group, const void* block_rows, void* y,
           int M, int K, int N, int tm, cudaStream_t st) {
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto bg = static_cast<const int*>(block_group);
  auto br = static_cast<const int*>(block_rows);
  auto yb = static_cast<__nv_bfloat16*>(y);
  if (K % 32 != 0 || tm <= 0 || M % tm != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tm == GEMV_TM) {
    dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS, M / tm), block(GEMV_WARPS * 32);
    grouped_gemv_kernel<W><<<grid, block, 0, st>>>(xb, K, w, bg, br, yb, N);
  } else if (tm % TM == 0 && N % TN == 0) {
    dim3 grid(N / TN, M / TM), block(128);
    grouped_mma_kernel<W><<<grid, block, 0, st>>>(xb, K, w, bg, br, yb, N, tm);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] bf16 (M % tm == 0), block_group [M/tm] int32 (an expert id),
// block_rows [M/tm] int32 (the real rows of each block), y [M, N] bf16.
// tm = 8 (GEMV) or a multiple of 32 (tiled, N % 64 == 0); K % 32 == 0.
// K8: qs [E, N, K/2] uint8, scales/mins [E, N, K/32] f32.
extern "C" int nfai_grouped_q4(const void* x, const void* qs, const void* sc, const void* mn,
                               const void* block_group, const void* block_rows, void* y,
                               int M, int K, int N, int tm, void* stream) {
  const Q4Stack w{static_cast<const uint8_t*>(qs), static_cast<const float*>(sc),
                  static_cast<const float*>(mn)};
  return launch(x, w, block_group, block_rows, y, M, K, N, tm, static_cast<cudaStream_t>(stream));
}

// K9: qs [E, N, K] int8, scales/mins [E, N, K/group] f32 (mins may be null),
// group 16 or 32.
extern "C" int nfai_grouped_q8(const void* x, const void* qs, const void* sc, const void* mn,
                               const void* block_group, const void* block_rows, void* y,
                               int M, int K, int N, int tm, int group, void* stream) {
  if (group != 16 && group != 32) return static_cast<int>(cudaErrorInvalidValue);
  const Q8Stack w{static_cast<const int8_t*>(qs), static_cast<const float*>(sc),
                  static_cast<const float*>(mn), group == 16 ? 4 : 5};
  return launch(x, w, block_group, block_rows, y, M, K, N, tm, static_cast<cudaStream_t>(stream));
}
