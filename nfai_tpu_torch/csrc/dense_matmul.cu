// K11: dense layer-stacked matmul, y[M, N] = x[M, K] @ w[layer]^T
//      (bf16 in and out, f32 accumulation).
//
// Replaces the Pallas kernel nfai_tpu/ops/qmatmul.py::_dense_matmul_layered
// (body _densel_kernel): x [B, K] times layer `layer` of a dense weight stack,
// read in place from the stacked buffer; the layer comes in as a scalar and
// nothing is sliced or copied. The JAX wrapper falls back to XLA's
// x @ w[layer] for shapes its tiles do not divide; that is the same
// function, so this kernel takes every M, K and N and masks the tails.
//
// Weight layout (nfai_tpu_torch/models/llama.py): w [L, N, K] bf16, GGUF's
// own row order and the layout of the quantized containers, so a GEMV reads
// K-contiguous rows and loading needs no transpose (the JAX stack is
// [L, K, N]; params_from_jax transposes). The layer is a pointer offset.
//
// What bounds it on an H100: decode (M <= 8) reads 2 bytes per weight and
// does 2M flops on it, far below the 295 flops a byte at which the tensor
// cores become the limit: it is bound by bytes (wo 2048 x 2048 at M = 8:
// 8.4 MB, 0.0025 ms at 3.35 TB/s). Prefill chunks (M = 128..2048) are bound
// by operations (M = 1024: 0.0087 ms on the same weight).
//
// Design. 2 <= M <= 8: a GEMV on tensor cores. A warp owns 8 output rows and a
// slice of K; each lane reads 16 bytes (8 weights) of one row and the same 8
// x values a load, and feeds them to mma.sync m16n8k16 (x as A, rows 8-15
// zero; the weights as B) with K permuted inside each 32-deep step: the
// dot product does not care about the order of K, so every 16-byte load
// is used where it lands and no shuffle or shared memory is needed. With
// the multiply-adds off the CUDA cores, a lane keeps 4 loads of each
// operand in flight and the kernel is left with the bytes; M = 2 and
// M = 8 cost the same. A block of 8 warps splits K into `ks` slices
// (chosen on the host so that each warp streams at least 4 steps), so a
// 2048-row wo gives 256 blocks. The ks partial sums meet in shared memory
// and one thread adds them in slice order: no atomics, the same bits on
// every launch. Weights are read with the streaming hint (read once), x
// through the read-only cache.
// M = 1: the same split on CUDA cores, a warp over 4 rows, each lane
// streaming 16-byte loads of them (faster there: no idle tensor-core
// rows, 512 contiguous bytes of a row a warp load).
// M > 8: 64 x 128 output tiles on bf16 tensor cores (WMMA 16x16x16, f32
// accumulate), 8 warps of 32 x 32; a 3-stage cp.async pipeline of 64-deep
// x and weight tiles in dynamic shared memory (zero-filled past M, N and
// K), so two tiles' loads are in flight while the third is multiplied.
// No split-K: each output is summed by one warp in K order. wgmma and TMA
// are later work.
// K % 8 != 0, or a base pointer not 16-byte aligned, takes the CUDA-core
// GEMV and the tiles with 2-byte loads (VEC = false).
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

// one load unit: 8 consecutive bf16 (VEC) or one
template <bool VEC>
__device__ __forceinline__ void load_unit(const __nv_bfloat16* p, float* f) {
  if constexpr (VEC) {
    bf16x8(__ldg(reinterpret_cast<const uint4*>(p)), f);
  } else {
    f[0] = __uint_as_float(
        static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
  }
}

constexpr int GEMV_WARPS = 8, GEMV_R = 4;

// CUDA cores, for M = 1 with 16-byte loads (VEC) and every M <= 8 where
// they do not apply: a warp owns GEMV_R rows and a K slice, lanes stride K
// a load unit at a time, x is reused from registers across the rows; warp
// shuffles, then the ks slices summed in slice order in shared memory.
template <int MR, bool VEC>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
dense_gemv_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                  const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y,
                  int N, int ks) {
  constexpr int E = VEC ? 8 : 1;
  __shared__ float part[GEMV_WARPS][MR][GEMV_R];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slice = warp % ks, group = warp / ks;
  const int rows_per_block = (GEMV_WARPS / ks) * GEMV_R;
  const int n0 = blockIdx.x * rows_per_block + group * GEMV_R;
  const int units = K / E;
  const int per = (units + ks - 1) / ks;
  const int u_lo = slice * per, u_hi = min(units, u_lo + per);
  const __nv_bfloat16* wr[GEMV_R];
  bool live[GEMV_R];
#pragma unroll
  for (int r = 0; r < GEMV_R; ++r) {
    live[r] = n0 + r < N;
    wr[r] = w + (size_t)(live[r] ? n0 + r : 0) * K;
  }
  float acc[MR][GEMV_R];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int r = 0; r < GEMV_R; ++r) acc[m][r] = 0.f;

#pragma unroll 2
  for (int u = u_lo + lane; u < u_hi; u += 32) {
    float wf[GEMV_R][E];
#pragma unroll
    for (int r = 0; r < GEMV_R; ++r) {
      if (live[r]) {
        load_unit<VEC>(wr[r] + (size_t)u * E, wf[r]);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) wf[r][i] = 0.f;
      }
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m < M) {
        float xf[E];
        load_unit<VEC>(x + (size_t)m * K + (size_t)u * E, xf);
#pragma unroll
        for (int r = 0; r < GEMV_R; ++r) {
          float a = acc[m][r];
#pragma unroll
          for (int i = 0; i < E; ++i) a = fmaf(xf[i], wf[r][i], a);
          acc[m][r] = a;
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int r = 0; r < GEMV_R; ++r) {
      float a = acc[m][r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) part[warp][m][r] = a;
    }
  __syncthreads();
  // one thread per (row group, row, m): the ks slices summed in slice order
  const int outs = (GEMV_WARPS / ks) * GEMV_R * MR;
  for (int t = threadIdx.x; t < outs; t += blockDim.x) {
    const int m = t % MR, r = (t / MR) % GEMV_R, g = t / (MR * GEMV_R);
    const int n = blockIdx.x * rows_per_block + g * GEMV_R + r;
    if (m < M && n < N) {
      float s = 0.f;
      for (int k = 0; k < ks; ++k) s += part[g * ks + k][m][r];
      y[(size_t)m * N + n] = __float2bfloat16(s);
    }
  }
}

__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  // A rows 8-15 (a1, a3) are zero: only M <= 8 rows exist
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

constexpr int SK_WARPS = 8, SK_U = 4;  // warps a block; 32-deep steps a load batch

// M <= 8, K % 8 == 0, 16-byte aligned x and w. Lane (g, t) = (lane / 4,
// lane % 4) loads weight row n0 + g and x row g at K offset 32 s + 8 t; in
// mma step 2 s + h its words 2h, 2h + 1 are the logical k slots (2t, 2t+1)
// and (2t+8, 2t+9) of A and of B alike, so each product pairs an x value
// with the weight at the same K. C's (row g, cols 2t, 2t+1) are
// y[g][n0 + 2t], y[g][n0 + 2t + 1].
__global__ void __launch_bounds__(SK_WARPS * 32)
dense_gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                      const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y,
                      int N, int ks) {
  __shared__ float part[SK_WARPS][8][8];  // [warp][m][n]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slice = warp % ks, group = warp / ks;
  const int rows_per_block = (SK_WARPS / ks) * 8;
  const int n0 = blockIdx.x * rows_per_block + group * 8;
  const int steps = (K + 31) / 32;
  const int per = (steps + ks - 1) / ks;
  const int s_lo = slice * per, s_hi = min(steps, s_lo + per);
  const bool wrow = n0 + g < N, xrow = g < M;
  const uint4* wp = reinterpret_cast<const uint4*>(w + (size_t)(wrow ? n0 + g : 0) * K + t * 8);
  const uint4* xp = reinterpret_cast<const uint4*>(x + (size_t)(xrow ? g : 0) * K + t * 8);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = s_lo; s0 < s_hi; s0 += SK_U) {
    uint4 wv[SK_U], xv[SK_U];
#pragma unroll
    for (int u = 0; u < SK_U; ++u) {
      const int s = s0 + u;
      const bool ok = s < s_hi && s * 32 + t * 8 < K;
      wv[u] = ok && wrow ? __ldcs(wp + (size_t)s * 4) : zero;  // 32 bf16 = 4 uint4 a step
      xv[u] = ok && xrow ? __ldg(xp + (size_t)s * 4) : zero;
    }
#pragma unroll
    for (int u = 0; u < SK_U; ++u) {
      mma_16816(c, xv[u].x, xv[u].y, wv[u].x, wv[u].y);
      mma_16816(c, xv[u].z, xv[u].w, wv[u].z, wv[u].w);
    }
  }
  part[warp][g][2 * t] = c[0];
  part[warp][g][2 * t + 1] = c[1];
  __syncthreads();
  const int outs = (SK_WARPS / ks) * 64;
  for (int e = threadIdx.x; e < outs; e += blockDim.x) {
    const int grp = e >> 6, m = (e >> 3) & 7, nn = e & 7;
    const int n = blockIdx.x * rows_per_block + grp * 8 + nn;
    if (m < M && n < N) {
      float sum = 0.f;
      for (int k = 0; k < ks; ++k) sum += part[grp * ks + k][m][nn];
      y[(size_t)m * N + n] = __float2bfloat16(sum);
    }
  }
}

constexpr int TM = 64, TN = 128, TK = 64, LDS = TK + 8, LDC = TN + 4, STAGES = 3;
constexpr int WM = 32, WN = 32, FM = WM / 16, FN = WN / 16;  // 2 x 4 warps of WM x WN
constexpr int MMA_THREADS = 256;
constexpr int STAGE = (TM + TN) * LDS;  // bf16 elements of one stage (x tile, then w tile)
constexpr int STAGE_BYTES = STAGES * STAGE * 2;
constexpr int EPI_BYTES = TM * LDC * 4;
constexpr int SMEM_BYTES = STAGE_BYTES > EPI_BYTES ? STAGE_BYTES : EPI_BYTES;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_stages() {  // all but the STAGES - 2 newest groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// the 64 x 64 x tile and the 128 x 64 weight tile at depth k0 into one stage
template <bool VEC>
__device__ __forceinline__ void load_tiles(__nv_bfloat16* sx, __nv_bfloat16* sw,
                                           const __nv_bfloat16* __restrict__ x, int M,
                                           const __nv_bfloat16* __restrict__ w, int N,
                                           int K, int m0, int n0, int k0, int tid) {
  if constexpr (VEC) {  // K % 8 == 0: a 16-byte chunk lies wholly inside or past K
    constexpr int CH = TK / 8;  // 16-byte chunks a tile row
#pragma unroll
    for (int i = 0; i < TM * CH / MMA_THREADS; ++i) {
      const int e = tid + i * MMA_THREADS, r = e / CH, c = (e % CH) * 8;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(sx + r * LDS + c, ok ? x + (size_t)(m0 + r) * K + k0 + c : x, ok);
    }
#pragma unroll
    for (int i = 0; i < TN * CH / MMA_THREADS; ++i) {
      const int e = tid + i * MMA_THREADS, r = e / CH, c = (e % CH) * 8;
      const bool ok = n0 + r < N && k0 + c < K;
      cp_async16(sw + r * LDS + c, ok ? w + (size_t)(n0 + r) * K + k0 + c : w, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < TM * TK; e += MMA_THREADS) {
      const int r = e / TK, c = e % TK;
      sx[r * LDS + c] = (m0 + r < M && k0 + c < K) ? x[(size_t)(m0 + r) * K + k0 + c] : zero;
    }
    for (int e = tid; e < TN * TK; e += MMA_THREADS) {
      const int r = e / TK, c = e % TK;
      sw[r * LDS + c] = (n0 + r < N && k0 + c < K) ? w[(size_t)(n0 + r) * K + k0 + c] : zero;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(MMA_THREADS)
dense_mma_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                 const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y, int N) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
  const int nk = (K + TK - 1) / TK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      __nv_bfloat16* st = stage + s * STAGE;
      load_tiles<VEC>(st, st + TM * LDS, x, M, w, N, K, m0, n0, s * TK, tid);
    }
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait_stages();  // tile kb has landed (this thread's copies)
    __syncthreads();         // ... everyone's, and stage (kb - 1) % STAGES is free
    if (kb + STAGES - 1 < nk) {
      __nv_bfloat16* st = stage + ((kb + STAGES - 1) % STAGES) * STAGE;
      load_tiles<VEC>(st, st + TM * LDS, x, M, w, N, K, m0, n0, (kb + STAGES - 1) * TK, tid);
    }
    cp_async_commit();
    const __nv_bfloat16* xs = stage + (kb % STAGES) * STAGE;
    const __nv_bfloat16* ws = xs + TM * LDS;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], xs + (wm + 16 * i) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], ws + (wn + 16 * j) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __syncthreads();  // the stages become the epilogue's staging tile
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(cs + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < TM * TN; e += MMA_THREADS) {
    const int r = e / TN, c = e % TN;
    if (m0 + r < M && n0 + c < N)
      y[(size_t)(m0 + r) * N + n0 + c] = __float2bfloat16(cs[r * LDC + c]);
  }
}

template <bool VEC>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y, int M,
                   int K, int N, cudaStream_t st) {
  if (M <= 8 && M > 1 && VEC) {
    // K slices a row group: each warp streams at least 4 32-deep steps
    const int steps = (K + 31) / 32;
    int ks = 1;
    while (ks < SK_WARPS && steps / (2 * ks) >= 4) ks *= 2;
    const int rows_per_block = (SK_WARPS / ks) * 8;
    dim3 grid((N + rows_per_block - 1) / rows_per_block), block(SK_WARPS * 32);
    dense_gemv_mma_kernel<<<grid, block, 0, st>>>(x, M, K, w, y, N, ks);
  } else if (M <= 8) {
    // K slices a row group: at least 128 load units (4 a lane) each
    const int units = VEC ? K / 8 : K;
    int ks = 1;
    while (ks < GEMV_WARPS && units / (2 * ks) >= 128) ks *= 2;
    const int rows_per_block = (GEMV_WARPS / ks) * GEMV_R;
    dim3 grid((N + rows_per_block - 1) / rows_per_block), block(GEMV_WARPS * 32);
    if (M == 1)  // with VEC, the only M this branch sees
      dense_gemv_kernel<1, VEC><<<grid, block, 0, st>>>(x, M, K, w, y, N, ks);
    else if constexpr (!VEC) {
      if (M == 2)
        dense_gemv_kernel<2, false><<<grid, block, 0, st>>>(x, M, K, w, y, N, ks);
      else if (M <= 4)
        dense_gemv_kernel<4, false><<<grid, block, 0, st>>>(x, M, K, w, y, N, ks);
      else
        dense_gemv_kernel<8, false><<<grid, block, 0, st>>>(x, M, K, w, y, N, ks);
    }
  } else {
    static bool sized = false;  // one per instantiation: above 48 KB needs the opt-in
    if (!sized) {
      const cudaError_t err = cudaFuncSetAttribute(
          dense_mma_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (err != cudaSuccess) return err;
      sized = true;
    }
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM), block(MMA_THREADS);
    dense_mma_kernel<VEC><<<grid, block, SMEM_BYTES, st>>>(x, M, K, w, y, N);
  }
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, w [L, N, K] bf16 (the stack; layer `layer` is used), y
// [M, N] bf16. vec != 0 promises K % 8 == 0 and 16-byte aligned x and w.
extern "C" int nfai_dense_matmul(const void* x, const void* w, void* y, int M, int K, int N,
                                 int layer, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wl = static_cast<const __nv_bfloat16*>(w) + (size_t)layer * N * K;
  auto yb = static_cast<__nv_bfloat16*>(y);
  return static_cast<int>(vec ? launch<true>(xb, wl, yb, M, K, N, st)
                              : launch<false>(xb, wl, yb, M, K, N, st));
}
