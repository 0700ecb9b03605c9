// K1: 4-bit affine dequant-matmul, y[M, N] = x[M, K] @ W^T with
//     W[n, k] = scales[n, k/32] * q[n, k] - mins[n, k/32]   (bf16 in/out, f32 math).
//
// Replaces the Pallas kernels nfai_tpu/ops/qmatmul.py::_q4v3_matmul (2-D,
// LM head and prefill projections, mins subtracted outside the kernel) and
// ::_q4v3_matmul_layered (layer-stacked, decode wqkv/wo/gate_up/down, mins
// inside). On a GPU a layer of the stacked container is a pointer offset, so
// one kernel serves both: the wrapper passes the layer's view.
//
// Weight layout (nfai_tpu_torch/ops/qtensor.py), N-major like GGUF itself:
//   qs     uint8 [N, K/2]: 32-block b of row n is bytes [16b, 16b+16); byte j
//          holds element 32b+j in its low nibble and 32b+16+j in its high one
//          (the Q4_0 block order, so Q4_0/Q4_1 payloads copy verbatim);
//   scales float [N, K/32], mins float [N, K/32] (f32: W equals ggml's own
//          dequantization bit for bit).
//
// What bounds it on an H100 (3.35 TB/s, 989 TF/s bf16): decode (M <= 8)
// streams 0.75 bytes per weight (0.5 of nibbles + 8 bytes of f32 scale and
// min per 32) and does 2M flops on it, far below the 295 flops a byte
// where the tensor cores become the limit: bytes (the head, 2048 x 128256:
// 0.059 ms). Prefill rows (M = 16..1024) reach the operations bound from
// M ~ 256 on; below it they are bound by bytes too.
//
// M = 1: a GEMV on CUDA cores, one warp per output row, each lane decoding
// whole 32-blocks (one 16-byte load each) with the 2^23 magic-number trick
// (no I2F); measured faster than the tensor-core GEMV at M = 1 on every
// shape of the path but one (gate_up, within 3%).
//
// 2 <= M <= 8: a GEMV on tensor cores, mma.sync m16n8k16 with the weight as
// A (16 rows a warp) and x as B (its 8 columns are the M rows). Lane (g, t)
// holds word t (bytes 4t..4t+3) of a 32-block of rows g and g + 8: codes
// 4t..4t+3 of the low half in the low nibbles, of the high half in the
// high ones. The K order inside a product is free, so slots (2t, 2t+1)
// take codes (4t, 4t+2) and slots (2t+8, 2t+9) codes (4t+1, 4t+3): nibbles
// at bits 0-3 and 16-19 become a bf16x2 of exact integers by one lop3
// (0x4300 | q = 128 + q) and one packed subtract of 128; x is loaded in the
// same permutation (two prmt). A block's two halves sum into one partial,
// scaled by the block's f32 scale; its min times the block's x sum (a
// product against ones) is subtracted: W enters exactly as s q - m in f32,
// only the order of the sums differs from the plain version. A lane loads
// 16 bytes (a whole block) of each row and a quad transposes its four blocks
// with four shuffles (6% faster on the head than 4-byte loads of word t).
// x is staged per chunk of 4096 codes in shared memory by cp.async; each
// warp prefetches its next four blocks (codes, scales, mins) while it
// multiplies the current ones. A block of 8 warps splits K into ks slices,
// the fewest that give every SM a block; the slices meet in shared memory
// and one thread adds them in slice order: no atomics, the same bits on
// every launch.
//
// M > 8: wgmma tiles computing y^T = W x^T, so the weight is the 64-row A
// operand and M is wgmma's N width: 16, 32, 64 or 128 (the least that
// holds M; larger M takes several 128-wide tiles), which the prefill
// buckets fill without waste. Two consumer warpgroups and one producer
// warp. Per 128-code stage the producer's lane 0 brings every operand by
// TMA into a ring of 4-6 stages under mbarriers: x as two 64-code boxes
// under the 128-byte swizzle (wgmma's B), the codes (64 bytes a row), the
// scales and the mins (4 f32 a row; where the scale rows are not 16-byte
// strided, K % 128 != 0, the warp copies them by cp.async instead). A
// consumer thread decodes its rows' codes in registers straight into the
// wgmma A fragment as bf16(s q - m) (one rounding of an f32 fma on 128 + q,
// bit operations for the nibble), the RS form m64nBMk16 with x from shared
// memory, four products a half-stage. A half's A registers are read while
// its products run, so a group waits for them before it decodes the next
// half; the other group's products fill the tensor cores meanwhile. Where
// the row split (each group 64 of the block's 128 weight rows) would leave
// part of a wave of SMs idle, the K split takes over: both groups
// own the block's 64 rows and take alternate stages, and group 1's sums are
// added to group 0's in shared memory, in that order. Every output is summed
// in a fixed order: the same bits on every launch. The D tile is transposed
// through shared memory into rows of y. What bounds it today is the
// decode: ~3 integer and f32 operations a code on the CUDA cores, which the
// products of the other group overlap only in part (PERF.md).
#include "sm90.cuh"

namespace {

__device__ __forceinline__ float nib(uint32_t v) {
  // v in [0, 15] -> exactly (float)v
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

// ---------------------------------------------------------------------------
// M = 1: the CUDA-core GEMV

constexpr int M1_WARPS = 8;

__global__ void __launch_bounds__(M1_WARPS * 32)
q4_gemv_m1_kernel(const __nv_bfloat16* __restrict__ x, int K, const uint8_t* __restrict__ qs,
                  const float* __restrict__ sc, const float* __restrict__ mn,
                  __nv_bfloat16* __restrict__ y, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * M1_WARPS + warp;
  if (n >= N) return;
  const int nb = K >> 5;
  const uint4* qcol = reinterpret_cast<const uint4*>(qs + (size_t)n * (K >> 1));
  const float* scol = sc + (size_t)n * nb;
  const float* mcol = mn + (size_t)n * nb;
  float acc = 0.f;
#pragma unroll 2
  for (int b = lane; b < nb; b += 32) {  // lane: whole 32-blocks, one 16-byte load each
    const uint4 w4 = __ldg(qcol + b);
    const float s = __ldg(scol + b), mi = -__ldg(mcol + b);
    const uint32_t wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // h = 0: elements 0..15, h = 1: 16..31
      const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)b * 32 + h * 16);
      float xf[16];
      bf16x8(__ldg(xr), xf);
      bf16x8(__ldg(xr + 1), xf + 8);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        acc = fmaf(xf[i], fmaf(s, nib((wv[i >> 2] >> (8 * (i & 3) + 4 * h)) & 0xFu), mi), acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) y[n] = __float2bfloat16(acc);
}

// ---------------------------------------------------------------------------
// M <= 8: the tensor-core GEMV

constexpr uint32_t NIB_MASK = 0x000F000Fu, HDR_128 = 0x43004300u;  // bf16x2 (128, 128)
constexpr int GV_CB = 128;  // 32-blocks of x a chunk in shared memory

// the nibbles at bits 0-3 and 16-19 of w → the bf16x2 of the two codes,
// exact: 0x4300 | q is 128 + q, and (128 + q) - 128 rounds nothing
__device__ __forceinline__ uint32_t nib2(uint32_t w) {
  return bf16x2_sub(lop3_and_or(w, NIB_MASK, HDR_128), HDR_128);
}

// One 32-block of a row group: A from the lane's words of rows g and g + 8,
// B from the lane's x fragment; the block's partial scaled by its scale, its
// min times the block's x sum subtracted, in f32.
__device__ __forceinline__ void gemv_block(uint32_t w0, uint32_t w1, const uint4& xv, float s0,
                                           float s1, float m0, float m1, float (&acc)[4]) {
  float q[4] = {0.f, 0.f, 0.f, 0.f};  // x sums of columns 2t, 2t + 1 (every row the same)
  mma_16816(q, BF16X2_ONE, BF16X2_ONE, BF16X2_ONE, BF16X2_ONE, xv.x, xv.y);
  mma_16816(q, BF16X2_ONE, BF16X2_ONE, BF16X2_ONE, BF16X2_ONE, xv.z, xv.w);
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  // half 0 (low nibbles): slots 2t, 2t+1 <- codes 4t, 4t+2; 2t+8, 2t+9 <- 4t+1, 4t+3
  mma_16816(p, nib2(w0), nib2(w1), nib2(w0 >> 8), nib2(w1 >> 8), xv.x, xv.y);
  // half 1 (high nibbles), the same slots
  mma_16816(p, nib2(w0 >> 4), nib2(w1 >> 4), nib2(w0 >> 12), nib2(w1 >> 12), xv.z, xv.w);
  acc[0] = fmaf(-m0, q[0], fmaf(s0, p[0], acc[0]));
  acc[1] = fmaf(-m0, q[1], fmaf(s0, p[1], acc[1]));
  acc[2] = fmaf(-m1, q[0], fmaf(s1, p[2], acc[2]));
  acc[3] = fmaf(-m1, q[1], fmaf(s1, p[3], acc[3]));
}

// x fragment of block `bl` of the staged chunk: lane (g, t) reads codes
// 4t..4t+3 of both halves of x row g and orders them as its B slots
__device__ __forceinline__ uint4 x_frag(const unsigned char* xrow, int bl, int t, bool live) {
  if (!live) return make_uint4(0, 0, 0, 0);
  const uint2 u = *reinterpret_cast<const uint2*>(xrow + 64 * bl + 8 * t);
  const uint2 v = *reinterpret_cast<const uint2*>(xrow + 64 * bl + 32 + 8 * t);
  return make_uint4(prmt(u.x, u.y, 0x5410), prmt(u.x, u.y, 0x7632), prmt(v.x, v.y, 0x5410),
                    prmt(v.x, v.y, 0x7632));
}

// four blocks of rows g and g + 8: the 16 bytes of block b0 + t of each,
// and the four blocks' scales and mins of each
struct Group {
  uint4 q[2];
  float4 s[2], m[2];
};

__device__ __forceinline__ void load_group(Group& G, const uint8_t* const (&qrow)[2],
                                           const float* const (&srow)[2],
                                           const float* const (&mrow)[2], int b0, int t, bool vec) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    G.q[h] = __ldcs(reinterpret_cast<const uint4*>(qrow[h]) + b0 + t);
    if (vec) {
      G.s[h] = __ldg(reinterpret_cast<const float4*>(srow[h] + b0));
      G.m[h] = __ldg(reinterpret_cast<const float4*>(mrow[h] + b0));
    } else {
      G.s[h] = make_float4(__ldg(srow[h] + b0), __ldg(srow[h] + b0 + 1), __ldg(srow[h] + b0 + 2),
                           __ldg(srow[h] + b0 + 3));
      G.m[h] = make_float4(__ldg(mrow[h] + b0), __ldg(mrow[h] + b0 + 1), __ldg(mrow[h] + b0 + 2),
                           __ldg(mrow[h] + b0 + 3));
    }
  }
}

__global__ void __launch_bounds__(GV_WARPS * 32)
q4_gemv_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
               const uint8_t* __restrict__ qs, const float* __restrict__ sc,
               const float* __restrict__ mn, __nv_bfloat16* __restrict__ y, int N, int ks) {
  extern __shared__ __align__(16) unsigned char xsm[];  // [M][pitch]: x rows of a chunk
  __shared__ float part[GV_WARPS][16][8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slice = warp % ks, rg = warp / ks;
  const int rows_per_block = (GV_WARPS / ks) * 16;
  const int nrow0 = blockIdx.x * rows_per_block + rg * 16;
  const int nb = K >> 5;
  const bool vec = (nb & 3) == 0;  // scale rows 16-byte aligned: float4 loads of 4 blocks
  const uint8_t* qrow[2];
  const float* srow[2];
  const float* mrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = min(nrow0 + g + 8 * h, N - 1);  // rows past N: read, discarded
    qrow[h] = qs + (size_t)row * (K >> 1);
    srow[h] = sc + (size_t)row * nb;
    mrow[h] = mn + (size_t)row * nb;
  }
  const bool live = g < M;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int c0 = 0; c0 < nb; c0 += GV_CB) {
    const int cb = min(GV_CB, nb - c0), pitch = cb * 64 + 32;
    const int per = (((cb + ks - 1) / ks) + 3) & ~3;
    const int lo = min(cb, slice * per), hi = min(cb, lo + per);
    const int groups = (hi - lo) >> 2;
    Group A;
    if (groups > 0) load_group(A, qrow, srow, mrow, c0 + lo, t, vec);  // in flight while x lands
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < M * cb * 4; e += blockDim.x) {  // x rows < M: 16-byte copies
      const int r = e / (cb * 4), c = e % (cb * 4);
      cp_async16(xsm + r * pitch + 16 * c, x + (size_t)r * K + (size_t)c0 * 32 + 8 * c);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const unsigned char* xrow = xsm + (live ? g : 0) * pitch;
    for (int i = 0; i < groups; ++i) {
      Group B;
      if (i + 1 < groups) load_group(B, qrow, srow, mrow, c0 + lo + 4 * (i + 1), t, vec);
      uint32_t w[2][4];
      quad_transpose(A.q[0], t, w[0]);
      quad_transpose(A.q[1], t, w[1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        gemv_block(w[0][j], w[1][j], x_frag(xrow, lo + 4 * i + j, t, live), comp(A.s[0], j),
                   comp(A.s[1], j), comp(A.m[0], j), comp(A.m[1], j), acc);
      A = B;
    }
    for (int b = lo + 4 * groups; b < hi; ++b) {  // the last blocks of a slice: word t directly
      const int gb = c0 + b;
      const uint32_t w0 = __ldcs(reinterpret_cast<const uint32_t*>(qrow[0] + 16 * gb) + t);
      const uint32_t w1 = __ldcs(reinterpret_cast<const uint32_t*>(qrow[1] + 16 * gb) + t);
      gemv_block(w0, w1, x_frag(xrow, b, t, live), __ldg(srow[0] + gb), __ldg(srow[1] + gb),
                 __ldg(mrow[0] + gb), __ldg(mrow[1] + gb), acc);
    }
  }
  // C fragment: acc[0..1] row g (columns m = 2t, 2t+1), acc[2..3] row g + 8
  part[warp][g][2 * t] = acc[0];
  part[warp][g][2 * t + 1] = acc[1];
  part[warp][g + 8][2 * t] = acc[2];
  part[warp][g + 8][2 * t + 1] = acc[3];
  __syncthreads();
  for (int e = tid; e < M * rows_per_block; e += blockDim.x) {
    const int m = e / rows_per_block, rl = e % rows_per_block;
    const int n = blockIdx.x * rows_per_block + rl;
    if (n < N) {
      float sum = 0.f;
      for (int k = 0; k < ks; ++k) sum += part[(rl >> 4) * ks + k][rl & 15][m];
      y[(size_t)m * N + n] = __float2bfloat16(sum);
    }
  }
}

cudaError_t gemv(const __nv_bfloat16* x, const uint8_t* qs, const float* sc, const float* mn,
                 __nv_bfloat16* y, int M, int K, int N, cudaStream_t st) {
  static bool sized = false;  // above 48 KB of shared memory needs the opt-in
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        q4_gemv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 8 * (GV_CB * 64 + 32));
    if (err != cudaSuccess) return err;
    sized = true;
  }
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int ks = gemv_ks(K, N, sms), rows = (GV_WARPS / ks) * 16;
  const int smem = M * (min(K / 32, GV_CB) * 64 + 32);
  q4_gemv_kernel<<<(N + rows - 1) / rows, GV_WARPS * 32, smem, st>>>(x, M, K, qs, sc, mn, y, N, ks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// M > 8: wgmma tiles, y^T = W x^T

constexpr int TN = 128, TK = 128;   // weight rows a block (row split), codes a stage
constexpr int T_THREADS = 2 * 128 + 32;  // two consumer warpgroups, one producer warp

template <int BM>
struct TileShape {
  static constexpr int STAGES = BM == 128 ? 4 : 6;
  static constexpr int X_BYTES = BM * 128;       // one of the stage's two 64-code x tiles
  static constexpr int W_OFF = 2 * X_BYTES;      // codes: 128 rows of 64 bytes
  static constexpr int S_OFF = W_OFF + TN * 64;  // scales: 128 rows of 4 f32
  static constexpr int M_OFF = S_OFF + TN * 16;  // mins: the same
  static constexpr int STAGE = M_OFF + TN * 16;  // a multiple of 1024
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
  static constexpr int OUT_PITCH = TN + 8;            // bf16 a row of the y tile
  static constexpr int OUT_BYTES = BM * OUT_PITCH * 2;  // then the K split's sums
};

template <int BM, bool KS>
__global__ void __launch_bounds__(T_THREADS, 1)
q4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap smap, const __grid_constant__ CUtensorMap mmap,
                int M, int K, const float* __restrict__ sc, const float* __restrict__ mn,
                __nv_bfloat16* __restrict__ y, int N, bool scales_by_tma) {
  using S = TileShape<BM>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char tsm_raw[];
  unsigned char* tsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tsm_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int RB = KS ? 64 : TN;  // weight rows a block
  const int n0 = blockIdx.x * RB, m0 = blockIdx.y * BM;
  const int nb = K >> 5, kt_n = (K + TK - 1) / TK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], scales_by_tma ? 1 : 1 + 32);  // expect_tx (+ the lanes' copies)
      mbar_init(&empty[s], KS ? 1 : 2);  // one thread of each group that reads the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp: every operand by TMA from lane 0
    constexpr int TX = 2 * S::X_BYTES + RB * 64 + (2 * RB * 16);
    for (int kt = 0; kt < kt_n; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
      unsigned char* st = tsm + s * S::STAGE;
      if (lane == 0) {
        mbar_expect_tx(&full[s], scales_by_tma ? TX : TX - 2 * RB * 16);
        tma_load_2d(st, &xmap, kt * TK, m0, &full[s]);
        tma_load_2d(st + S::X_BYTES, &xmap, kt * TK + 64, m0, &full[s]);
        tma_load_2d(st + S::W_OFF, &qmap, kt * (TK / 2), n0, &full[s]);
        if (scales_by_tma) {
          tma_load_2d(st + S::S_OFF, &smap, kt * 4, n0, &full[s]);
          tma_load_2d(st + S::M_OFF, &mmap, kt * 4, n0, &full[s]);
        }
      }
      if (!scales_by_tma) {  // scale rows not 16-byte strided (K % 128 != 0): 4-byte copies
        for (int i = lane; i < RB * 8; i += 32) {
          const int r = i >> 3, j = i & 3, n = n0 + r, b = 4 * kt + j;
          const bool ok = n < N && b < nb;
          const float* src = (i & 4 ? mn : sc) + (size_t)(ok ? n : 0) * nb + (ok ? b : 0);
          cp_async4(st + (i & 4 ? S::M_OFF : S::S_OFF) + r * 16 + 4 * j, src, ok);
        }
        cp_async_arrive(&full[s]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives its thread
    return;
  }

  // consumers: with KS both groups own the tile's 64 rows and take
  // alternate stages (their sums meet at the end, group 0's first); else
  // group wg owns rows 64 wg .. 64 wg + 63 and takes every stage
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = (KS ? 0 : 64 * wg) + 16 * (warp & 3) + g;  // this lane's rows r0 and r0 + 8
  constexpr int STEP = KS ? 2 : 1;
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  // a stage is two halves of two 32-blocks, four k16 products each. A
  // half's A fragment lives in registers that its products read while they
  // run, so a group waits for them before it decodes the next half; the
  // other group's products keep the tensor cores busy meanwhile
  auto half = [&](const unsigned char* st, int hb, const float4 (&q)[4]) {
    uint32_t a[4][4];  // k16 step 2 jj + h: block 2 hb + jj, half h
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int jb = 2 * hb + jj;
      // the block's 16 bytes of rows r0 and r0 + 8 (a quad reads one chunk);
      // lane t keeps bytes 2t, 2t+1, 2t+8, 2t+9: k = 2t, 2t+1 | 2t+8, 2t+9
      const uint4 c0 = *reinterpret_cast<const uint4*>(st + S::W_OFF + r0 * 64 + 16 * jb);
      const uint4 c1 = *reinterpret_cast<const uint4*>(st + S::W_OFF + (r0 + 8) * 64 + 16 * jb);
      const uint32_t sel = (t & 1) ? 0x7632 : 0x5410;
      const uint32_t w0 = prmt(t & 2 ? c0.y : c0.x, t & 2 ? c0.w : c0.z, sel);
      const uint32_t w1 = prmt(t & 2 ? c1.y : c1.x, t & 2 ? c1.w : c1.z, sel);
      const float s0 = comp(q[0], jb), s1 = comp(q[1], jb);
      const float cc0 = -fmaf(128.f, s0, comp(q[2], jb)), cc1 = -fmaf(128.f, s1, comp(q[3], jb));
      decode_a<0>(w0, w1, s0, cc0, s1, cc1, a[2 * jj]);
      decode_a<1>(w0, w1, s0, cc0, s1, cc1, a[2 * jj + 1]);
    }
    uint64_t desc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      desc[j] = sw128_desc(st + hb * S::X_BYTES + 32 * j);
      pin(a[j], desc[j]);  // operands final before the fence: nothing sinks between products
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs<BM>(acc, a[j], desc[j]);
    wgmma_commit();
    wgmma_wait<0>();
  };
  for (int kt = KS ? wg : 0; kt < kt_n; kt += STEP) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* st = tsm + s * S::STAGE;
    const float4 q[4] = {  // the stage's four scales and mins of rows r0 and r0 + 8
        *reinterpret_cast<const float4*>(st + S::S_OFF + r0 * 16),
        *reinterpret_cast<const float4*>(st + S::S_OFF + (r0 + 8) * 16),
        *reinterpret_cast<const float4*>(st + S::M_OFF + r0 * 16),
        *reinterpret_cast<const float4*>(st + S::M_OFF + (r0 + 8) * 16)};
    half(st, 0, q);
    half(st, 1, q);
    // the group's products of this stage have completed, after every warp
    // of the group had read it: the stage is free
    if ((warp & 3) == 0 && lane == 0) mbar_arrive(&empty[s]);
  }
  fence_regs(acc);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both groups are done with the stages
  if constexpr (KS) {  // group 1's sums, in its fragment order, onto group 0's
    float* part = reinterpret_cast<float*>(tsm + S::OUT_BYTES);
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
  // D fragment: acc[4i + e] = row r0 (+8 for e >= 2), column m = 8i + 2t (+1 for odd e)
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(tsm);  // [BM][OUT_PITCH]
  if (!KS || wg == 0) {
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const int m = 8 * i + 2 * t;
      out[m * S::OUT_PITCH + r0] = __float2bfloat16(acc[4 * i]);
      out[(m + 1) * S::OUT_PITCH + r0] = __float2bfloat16(acc[4 * i + 1]);
      out[m * S::OUT_PITCH + r0 + 8] = __float2bfloat16(acc[4 * i + 2]);
      out[(m + 1) * S::OUT_PITCH + r0 + 8] = __float2bfloat16(acc[4 * i + 3]);
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const bool vec = (N & 7) == 0 && n0 + RB <= N;
  for (int e = tid; e < BM * (RB / 8); e += 256) {  // 16 bytes (8 columns) a thread
    const int m = e / (RB / 8), c = 8 * (e % (RB / 8));
    if (m0 + m >= M) continue;
    const __nv_bfloat16* src = out + m * S::OUT_PITCH + c;
    __nv_bfloat16* dst = y + (size_t)(m0 + m) * N + n0 + c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && n0 + c + j < N; ++j) dst[j] = src[j];
    }
  }
}

template <int BM, bool KS>
cudaError_t launch_tiles(const void* x, const uint8_t* qs, const float* sc, const float* mn,
                         __nv_bfloat16* y, int M, int K, int N, cudaStream_t st) {
  static bool sized = false;  // one per instantiation: above 48 KB needs the opt-in
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        q4_wgmma_kernel<BM, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, TileShape<BM>::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  constexpr int RB = KS ? 64 : TN;
  const int nb = K / 32;
  const bool scales_by_tma = nb % 4 == 0;  // TMA strides are multiples of 16 bytes
  CUtensorMap xm, qm, sm, mm;
  cudaError_t err = tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, 64, BM,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qs, N, K / 2, TK / 2, RB,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess && scales_by_tma)
    err = tensor_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sc, N, nb, 4, RB,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess && scales_by_tma)
    err = tensor_map(&mm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, mn, N, nb, 4, RB,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  if (!scales_by_tma) sm = mm = qm;  // unused
  dim3 grid((N + RB - 1) / RB, (M + BM - 1) / BM);
  q4_wgmma_kernel<BM, KS><<<grid, T_THREADS, TileShape<BM>::SMEM, st>>>(
      xm, qm, sm, mm, M, K, sc, mn, y, N, scales_by_tma);
  return cudaGetLastError();
}

// the tile width: the least of 16, 32, 64, 128 that holds M (larger M
// takes several 128-wide row tiles); the split by `tiles_k_split`
template <int BM>
cudaError_t launch_width(const void* x, const uint8_t* qs, const float* sc, const float* mn,
                         __nv_bfloat16* y, int M, int K, int N, cudaStream_t st) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  return tiles_k_split((N + TN - 1) / TN * ((M + BM - 1) / BM), sms)
             ? launch_tiles<BM, true>(x, qs, sc, mn, y, M, K, N, st)
             : launch_tiles<BM, false>(x, qs, sc, mn, y, M, K, N, st);
}

cudaError_t tiles(const void* x, const uint8_t* qs, const float* sc, const float* mn,
                  __nv_bfloat16* y, int M, int K, int N, cudaStream_t st) {
  if (M <= 16) return launch_width<16>(x, qs, sc, mn, y, M, K, N, st);
  if (M <= 32) return launch_width<32>(x, qs, sc, mn, y, M, K, N, st);
  if (M <= 64) return launch_width<64>(x, qs, sc, mn, y, M, K, N, st);
  return launch_width<128>(x, qs, sc, mn, y, M, K, N, st);
}

}  // namespace

// x [M, K] bf16, qs [N, K/2] u8, scales/mins [N, K/32] f32, y [M, N] bf16.
// Needs K % 32 == 0 and 16-byte aligned pointers; any M and N.
extern "C" int nfai_q4_matmul(const void* x, const void* qs, const void* sc,
                              const void* mn, void* y, int M, int K, int N,
                              void* stream) {
  if (K % 32 != 0 || M < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto q = static_cast<const uint8_t*>(qs);
  auto s = static_cast<const float*>(sc);
  auto m = static_cast<const float*>(mn);
  auto yb = static_cast<__nv_bfloat16*>(y);
  if (M == 1) {
    q4_gemv_m1_kernel<<<(N + M1_WARPS - 1) / M1_WARPS, M1_WARPS * 32, 0, st>>>(xb, K, q, s, m, yb, N);
    return static_cast<int>(cudaGetLastError());
  }
  if (M <= 8) return static_cast<int>(gemv(xb, q, s, m, yb, M, K, N, st));
  return static_cast<int>(tiles(x, q, s, m, yb, M, K, N, st));
}
