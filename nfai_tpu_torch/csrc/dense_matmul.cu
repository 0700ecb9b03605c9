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
// M > 8: wgmma tiles computing y^T = W x^T (the skeleton of K6's and K12's
// tiles in sm90.cuh), so the weight rows are the 64-row A operand and M is
// wgmma's N width: 16, 32, 64 or 128, the least that holds M; larger M
// takes several tiles, 256 wide where there are enough of them to fill the
// SMs, else 128 wide (`tiles`). The weight needs no decode, so both
// operands stay in shared memory (the SS form): one producer warp's lane 0
// brings 64-deep boxes of 128 weight rows and of BM x rows by TMA under
// the 128-byte swizzle into a ring of stages under mbarriers (4 at widths
// up to 64, up to 8 at 128 and 256), and each of two consumer warpgroups
// (64 weight rows each) waits for a stage, issues its four m64nBMk16
// products from two descriptors (32 bytes further a k16 step, inside the
// swizzle atom), commits, and releases the stage before once that batch's
// products have completed: one batch stays in flight while the next
// stage's wait runs. TMA zero-fills past M, N and K. Where the row tiles
// leave SMs idle, K is split in a fixed order (sm90.cuh's `tile_split`):
// at widths up to 64 across a cluster of blocks whose partial sums meet in
// distributed shared memory, at 128 and 256 first between the two groups
// of a 64-row block, then across a cluster. No atomics: the same bits on
// every launch. A grid of more than one wave runs the m tiles of a row
// tile next to each other, so the weight leaves HBM once. What bounds the
// tiles: the tensor cores at M >= 256 on wide N; at small N or small M the
// bytes of the weight, which the K split spreads over the SMs.
// K % 8 != 0, or a base pointer not 16-byte aligned (TMA needs 16-byte
// strides and addresses): the CUDA-core GEMV with 2-byte loads, and above
// M = 8 64 x 128 tiles on WMMA 16x16x16 fed by 2-byte loads.
#include <cooperative_groups.h>
#include <mma.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

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
      mma_16816(c, xv[u].x, 0u, xv[u].y, 0u, wv[u].x, wv[u].y);  // A rows 8-15 zero
      mma_16816(c, xv[u].z, 0u, xv[u].w, 0u, wv[u].z, wv[u].w);
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

// M > 8 where TMA cannot take the operands (K % 8 != 0 or a base pointer
// not 16-byte aligned): 64 x 128 output tiles on WMMA 16x16x16 fragments, 8
// warps of 32 x 32, 64-deep x and weight tiles loaded 2 bytes a thread
// (zero past M, N and K)
constexpr int TM = 64, TN = 128, TK = 64, LDS = TK + 8, LDC = TN + 4;
constexpr int WM = 32, WN = 32, FM = WM / 16, FN = WN / 16;  // 2 x 4 warps of WM x WN
constexpr int MMA_THREADS = 256;
constexpr int TILE_BYTES = (TM + TN) * LDS * 2;  // the x tile, then the weight tile
constexpr int EPI_BYTES = TM * LDC * 4;
constexpr int MMA_SMEM = TILE_BYTES > EPI_BYTES ? TILE_BYTES : EPI_BYTES;

__global__ void __launch_bounds__(MMA_THREADS)
dense_mma_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                 const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y, int N) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[MMA_SMEM];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + TM * LDS;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TM * TK; e += MMA_THREADS) {
      const int r = e / TK, c = e % TK;
      xs[r * LDS + c] = (m0 + r < M && k0 + c < K) ? x[(size_t)(m0 + r) * K + k0 + c] : zero;
    }
    for (int e = tid; e < TN * TK; e += MMA_THREADS) {
      const int r = e / TK, c = e % TK;
      ws[r * LDS + c] = (n0 + r < N && k0 + c < K) ? w[(size_t)(n0 + r) * K + k0 + c] : zero;
    }
    __syncthreads();
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
    __syncthreads();  // the tiles are free for the next step (and the epilogue)
  }
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

// ---------------------------------------------------------------------------
// M > 8, K % 8 == 0, 16-byte aligned x and w: wgmma tiles, y^T = W x^T

// Stages of the ring, each one 64-deep TMA box (128 bytes a row) of each
// operand: 4 at widths up to 64, as many as fit (at most 8) at 128 and 256
// (measured: with 6 the cluster-split rows at M = 24-64, wo and down, took
// 24-32% longer than with 4, with 3 the others up to 12% longer; with 4 at
// 128 and 256 down at M = 1024 took 34% longer; 128-deep stages, 3 of them,
// up to 1.7x longer)
constexpr int DW_NARROW_STAGES = 4, DW_MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;   // 227 KB a block

// a stage: the weight box (RB rows of 128 bytes), then x's (BM rows)
template <int BM, int RB>
struct DenseShape {
  static constexpr int X_OFF = RB * 128;
  static constexpr int STAGE = X_OFF + BM * 128;  // a multiple of 1024
  static constexpr int FIT = (SMEM_MAX - 2048) / STAGE;
  static constexpr int MOST = BM <= 64 ? DW_NARROW_STAGES : DW_MAX_STAGES;
  static constexpr int STAGES = FIT < MOST ? FIT : MOST;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
  // a group releases a stage after it issued the next one (two later with
  // the two-group split); tile_epilogue stages its y tile (and the
  // two-group or cluster partial sums) in the ring
  static_assert(STAGES >= 3 && STAGES * STAGE >= 528 * BM, "the ring is too small");
};

// Block (row tile, slice; m tile): 128 weight rows (64 with KS) times BM
// rows of x over the slice's stages; with CL a cluster holds the tile's
// slices. With m_fast the m tiles vary fastest along x, so a grid of more
// than one wave reads each row tile's weight for all the m tiles at about
// the same time and HBM streams it once, not once an m tile (measured:
// gate_up 2048 x 16384 at M = 1024 0.1233 -> 0.1058 ms; a grid of one wave
// ran up to 5% slower that way)
template <int BM, bool KS, bool CL>
__global__ void __launch_bounds__(T8_THREADS, 1)
dense_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                   int M, int K, __nv_bfloat16* __restrict__ y, int N, bool m_fast) {
  constexpr int RB = KS ? 64 : T8_ROWS;  // weight rows a block
  using S = DenseShape<BM, RB>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char tsm_raw[];
  unsigned char* tsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tsm_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int ks = CL ? cg::this_cluster().num_blocks() : 1;
  const int slice = CL ? cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int xt = blockIdx.x / ks;  // the slices of a tile are neighbours along x
  const int n0 = (m_fast ? blockIdx.y : xt) * RB, m0 = (m_fast ? xt : blockIdx.y) * BM;
  const int kt_n = (K + 63) / 64;  // stages over all of K
  const int kt0 = slice * kt_n / ks, kt_end = (slice + 1) * kt_n / ks;  // the slice's stages
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);              // the producer's expect_tx
      mbar_init(&empty[s], KS ? 4 : 8);    // every consumer warp that reads the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warp >> 2;
  const int r0 = (KS ? 0 : 64 * wg) + 16 * (warp & 3) + (lane >> 2);  // this lane's rows r0, r0 + 8
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  if (warp == 8) {  // the producer warp: both operands by TMA from lane 0
    for (int kt = kt0; kt < kt_end; ++kt) {
      const int i = kt - kt0, s = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      unsigned char* st = tsm + s * S::STAGE;
      if (lane == 0) {
        mbar_expect_tx(&full[s], S::STAGE);
        tma_load_2d(st, &wmap, kt * 64, n0, &full[s]);
        tma_load_2d(st + S::X_OFF, &xmap, kt * 64, m0, &full[s]);
      }
    }
    if constexpr (!CL) return;
  } else {
    // consumers: with KS both groups own the block's 64 rows and take
    // alternate stages (their sums meet at the end, group 0's first); else
    // group wg owns rows 64 wg .. 64 wg + 63 and takes every stage
    const int a_off = KS ? 0 : wg * 64 * 128;
    int held = -1;  // the stage whose products may still run
    fence_regs(acc);
    for (int kt = kt0 + (KS ? wg : 0); kt < kt_end; kt += KS ? 2 : 1) {
      const int i = kt - kt0, s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* st = tsm + s * S::STAGE;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_ss<BM>(acc, sw128_desc(st + a_off + 32 * j), sw128_desc(st + S::X_OFF + 32 * j));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products have completed: it is free
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = s;
    }
    wgmma_wait<0>();  // the last stage is not released: nothing more is loaded
    fence_regs(acc);
  }
  tile_epilogue<BM, KS, CL>(acc, tsm, r0, n0, m0, M, N, y);
}

template <int BM, bool KS, bool CL>
cudaError_t launch_tiles(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y, int M,
                         int K, int N, int ks, cudaStream_t st) {
  constexpr int RB = KS ? 64 : T8_ROWS;
  constexpr int SMEM = DenseShape<BM, RB>::SMEM;
  static bool sized = false;  // one per instantiation: above 48 KB needs the opt-in
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_wgmma_kernel<BM, KS, CL>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  CUtensorMap xm, wm;
  cudaError_t err = tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, 64, BM,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, N, K, 64, RB,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int row_tiles = (N + RB - 1) / RB, m_tiles = (M + BM - 1) / BM;
  const bool m_fast = row_tiles * m_tiles * ks > sms;  // more than one wave of blocks
  const dim3 grid = m_fast ? dim3(m_tiles * ks, row_tiles) : dim3(row_tiles * ks, m_tiles);
  if (CL)
    return launch_clustered(dense_wgmma_kernel<BM, KS, CL>, grid, T8_THREADS, SMEM, ks, st, xm, wm,
                            M, K, y, N, m_fast);
  dense_wgmma_kernel<BM, KS, CL><<<grid, T8_THREADS, SMEM, st>>>(xm, wm, M, K, y, N, m_fast);
  return cudaGetLastError();
}

// a tile width and its K split by `tile_split`
template <int BM>
cudaError_t launch_width(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y, int M,
                         int K, int N, cudaStream_t st) {
  return tile_split<BM>(M, K, N, [&](auto ks_split, auto cl, int ks) {
    return launch_tiles<BM, decltype(ks_split)::value, decltype(cl)::value>(x, w, y, M, K, N, ks, st);
  });
}

// The tile width: the least of 16, 32, 64 and 128 that holds M. Above 128
// rows, 256-wide tiles where their two-group split would fill 7/8 of the
// SMs, else 128-wide ones (measured: 256 is 1.6x faster on gate_up 2048 x
// 16384 at M = 256 and 1024, 128 is 1.25-1.6x faster on down, wo and wqkv
// (N = 2048-3072) at M = 256 and on Gemma-3-1B's wq (N = 1024) at 1024)
cudaError_t tiles(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y, int M, int K,
                  int N, cudaStream_t st) {
  if (M <= 16) return launch_width<16>(x, w, y, M, K, N, st);
  if (M <= 32) return launch_width<32>(x, w, y, M, K, N, st);
  if (M <= 64) return launch_width<64>(x, w, y, M, K, N, st);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles256 = (N + T8_ROWS - 1) / T8_ROWS * ((M + 255) / 256);
  if (M > 128 && 2 * tiles256 >= sms - sms / 8) return launch_width<256>(x, w, y, M, K, N, st);
  return launch_width<128>(x, w, y, M, K, N, st);
}

// K % 8 == 0 and 16-byte aligned x and w
cudaError_t launch_vec(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y, int M,
                       int K, int N, cudaStream_t st) {
  if (M > 8) return tiles(x, w, y, M, K, N, st);
  if (M > 1) {
    // K slices a row group: each warp streams at least 4 32-deep steps
    const int steps = (K + 31) / 32;
    int ks = 1;
    while (ks < SK_WARPS && steps / (2 * ks) >= 4) ks *= 2;
    const int rows_per_block = (SK_WARPS / ks) * 8;
    dense_gemv_mma_kernel<<<(N + rows_per_block - 1) / rows_per_block, SK_WARPS * 32, 0, st>>>(
        x, M, K, w, y, N, ks);
  } else {
    // K slices a row group: at least 128 load units (4 a lane) each
    int ks = 1;
    while (ks < GEMV_WARPS && K / 8 / (2 * ks) >= 128) ks *= 2;
    const int rows_per_block = (GEMV_WARPS / ks) * GEMV_R;
    dense_gemv_kernel<1, true><<<(N + rows_per_block - 1) / rows_per_block, GEMV_WARPS * 32, 0, st>>>(
        x, M, K, w, y, N, ks);
  }
  return cudaGetLastError();
}

// K % 8 != 0 or an unaligned pointer: 2-byte loads
cudaError_t launch_unaligned(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y,
                             int M, int K, int N, cudaStream_t st) {
  if (M > 8) {
    dense_mma_kernel<<<dim3((N + TN - 1) / TN, (M + TM - 1) / TM), MMA_THREADS, 0, st>>>(x, M, K, w,
                                                                                       y, N);
    return cudaGetLastError();
  }
  int ks = 1;  // K slices a row group: at least 128 load units (4 a lane) each
  while (ks < GEMV_WARPS && K / (2 * ks) >= 128) ks *= 2;
  const int rows_per_block = (GEMV_WARPS / ks) * GEMV_R;
  const dim3 grid((N + rows_per_block - 1) / rows_per_block), block(GEMV_WARPS * 32);
  if (M == 1)
    dense_gemv_kernel<1, false><<<grid, block, 0, st>>>(x, M, K, w, y, N, ks);
  else if (M == 2)
    dense_gemv_kernel<2, false><<<grid, block, 0, st>>>(x, M, K, w, y, N, ks);
  else if (M <= 4)
    dense_gemv_kernel<4, false><<<grid, block, 0, st>>>(x, M, K, w, y, N, ks);
  else
    dense_gemv_kernel<8, false><<<grid, block, 0, st>>>(x, M, K, w, y, N, ks);
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
  return static_cast<int>(vec ? launch_vec(xb, wl, yb, M, K, N, st)
                              : launch_unaligned(xb, wl, yb, M, K, N, st));
}
