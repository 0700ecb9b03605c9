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
// What bounds it on an H100 (3.35 TB/s, 989 TF/s bf16): decode (M <= 8)
// streams 1 byte of code plus 4/g (8/g with mins) bytes of scale a weight,
// 1.25 B/weight for Q6_K and 1.125 for Q8_0, and does 2M flops on it: bytes
// (the tied Q6_K head, 2048 x 128256: 0.098 ms). Prefill rows (M = 16..1024)
// reach the operations bound from M ~ 256 on.
//
// M = 1: a GEMV on CUDA cores, one warp a row, each lane decoding whole
// 32-code chunks (two 16-byte loads in flight) by I2F and an f32 fma by the
// scale (the 2^23 magic number measured no faster), K slices at small N;
// without slices a warp writes its row and leaves, no block barrier.
//
// 2 <= M <= 8: a GEMV on tensor cores, mma.sync m16n8k16 with the weight as
// A (16 rows a warp) and x as B (its 8 columns are the M rows). Lane (g, t)
// holds word t (codes 4t..4t+3) of a 16-code block of rows g and g + 8. The
// K order inside a product is free, so slots (2t, 2t+1) take codes (4t,
// 4t+2) and slots (2t+8, 2t+9) codes (4t+1, 4t+3), and x is loaded in the
// same permutation (two prmt). The bytes at bits 0-7 and 16-23 of a word
// become a bf16x2 of the exact codes by two lop3 and one packed subtract:
// 0x4300 | (b & 0x7F) is 128 + (b & 0x7F), 0x4300 | (b & 0x80) is 128 or
// 256 (the sign bit's weight on top of 128), and their difference is the
// signed code. A block's product goes into a fresh f32 fragment, folded
// in by one fma with its group's f32 scale (a g32 group takes two blocks);
// with mins, the group's x sum (a product against ones) times the min is
// subtracted: W enters exactly as s q - m in f32. A lane loads 16 bytes
// (a whole block) of each row and a quad transposes its four blocks with
// four shuffles; x is staged in shared memory by cp.async, in chunks of up
// to 4096 codes and 40 KB; each warp prefetches its next four blocks
// (codes, scales, mins) while it multiplies the current ones. A block of 8 warps splits K
// into ks slices, the fewest that give every SM a block; the slices meet
// in shared memory and one thread adds them in slice order: no atomics,
// the same bits on every launch.
//
// M > 8: wgmma tiles computing y^T = W x^T, so the weight is the 64-row A
// operand and M is wgmma's N width: 16, 32, 64 or 128 (the least that
// holds M; larger M takes several 128-wide tiles). Two consumer warpgroups
// and one producer warp. Per 128-code stage the producer's lane 0 brings
// every operand by TMA into a ring of 4-6 stages under mbarriers: x as two
// 64-code boxes under the 128-byte swizzle (wgmma's B), the codes (128
// bytes a row, under the 128-byte swizzle too, so the eight rows a warp
// reads at once sit in different banks), the scales and the mins (8 or 4
// f32 a row; where the scale rows are not 16-byte strided or aligned, the
// warp copies them by cp.async instead). A consumer thread decodes its
// rows' codes in registers straight into the wgmma A fragment as
// bf16(s q - m): a prmt places the sign-flipped byte u = q + 128 in an f32
// 1 + u 2^-15, and one fma by 2^15 s plus -(32896 s + m) gives s q - m, one
// rounding to bf16 (the RS form m64nBMk16 with x from shared memory, four
// products a half-stage). A half's A registers are read while its products
// run, so a group waits for them before it decodes the next half; the other
// group's products fill the tensor cores meanwhile. Where the row tiles
// would leave SMs idle, K is split and the partial sums added in a fixed
// order: at widths 16-64 across a cluster of 2-8 blocks, whose sums meet in
// distributed shared memory; at width 128 first between the two groups of
// a block that then owns 64 rows (group 1's sums added to group 0's in
// shared memory), then across a cluster of such blocks. Without a split the
// D tile is transposed through shared memory into rows of y. What bounds
// the tiles: the consumers' decode (~3.5 operations a code on the CUDA
// cores) beside the products of the other group, and at small N and large
// M the re-reading of x by every row tile (PERF.md).
#include <cooperative_groups.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t FLIP = 0x80808080u;  // the sign bit of each byte

// ---------------------------------------------------------------------------
// M = 1: the CUDA-core GEMV

template <bool MINS>
__global__ void __launch_bounds__(GV_WARPS * 32)
q8_gemv_m1_kernel(const __nv_bfloat16* __restrict__ x, int K, const int8_t* __restrict__ qs,
                  const float* __restrict__ sc, const float* __restrict__ mn,
                  __nv_bfloat16* __restrict__ y, int N, int gshift, int lks) {
  __shared__ float part[GV_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ks = 1 << lks, rows = GV_WARPS >> lks, slice = warp & (ks - 1);  // ks slices: shifts
  const int n = blockIdx.x * rows + (warp >> lks);
  const int nc = K >> 5, per = (nc + ks - 1) >> lks;  // 32-code chunks: a row's, a slice's
  const int lo = min(nc, slice * per), hi = min(nc, lo + per);
  const int ng = K >> gshift;
  float acc = 0.f;
  if (n < N) {
    const uint4* qrow = reinterpret_cast<const uint4*>(qs + (size_t)n * K);
    const float* srow = sc + (size_t)n * ng;
    const float* mrow = MINS ? mn + (size_t)n * ng : nullptr;
    for (int c = lo + lane; c < hi; c += 32) {
      const uint4 q2[2] = {__ldg(qrow + 2 * c), __ldg(qrow + 2 * c + 1)};  // 32 bytes in flight
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // codes 16h .. 16h + 15 of the chunk
        const int gi = (32 * c + 16 * h) >> gshift;
        const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)c * 32 + 16 * h);
        float xf[16];
        bf16x8(__ldg(xr), xf);
        bf16x8(__ldg(xr + 1), xf + 8);
        const float s = __ldg(srow + gi), mi = MINS ? -__ldg(mrow + gi) : 0.f;
        const uint32_t w[4] = {q2[h].x, q2[h].y, q2[h].z, q2[h].w};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float v = static_cast<float>(static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xFFu));
          acc = fmaf(xf[i], fmaf(s, v, mi), acc);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (ks == 1) {  // no barrier: a warp that is done leaves
    if (lane == 0 && n < N) y[n] = __float2bfloat16(acc);
    return;
  }
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (threadIdx.x < rows) {
    const int r = threadIdx.x, nn = blockIdx.x * rows + r;
    if (nn < N) {
      float sum = 0.f;
      for (int k = 0; k < ks; ++k) sum += part[r * ks + k];
      y[nn] = __float2bfloat16(sum);
    }
  }
}

// K slices a block at M = 1 (a warp a row), as a power of two 2^lks: the
// fewest that give every SM a block, each slice keeping a chunk a lane
int m1_lks(int K, int N, int sms) {
  int lks = 0;
  while (lks < 3 && (N + (GV_WARPS >> lks) - 1) / (GV_WARPS >> lks) < sms && K / (64 << lks) >= 32)
    ++lks;
  return lks;
}

cudaError_t gemv_m1(const __nv_bfloat16* x, const int8_t* qs, const float* sc, const float* mn,
                    __nv_bfloat16* y, int K, int N, int gshift, cudaStream_t st) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int lks = m1_lks(K, N, sms), rows = GV_WARPS >> lks;
  const dim3 grid((N + rows - 1) / rows), block(GV_WARPS * 32);
  if (mn)
    q8_gemv_m1_kernel<true><<<grid, block, 0, st>>>(x, K, qs, sc, mn, y, N, gshift, lks);
  else
    q8_gemv_m1_kernel<false><<<grid, block, 0, st>>>(x, K, qs, sc, mn, y, N, gshift, lks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// M <= 8: the tensor-core GEMV

constexpr uint32_t LOW7 = 0x007F007Fu, SIGN = 0x00800080u, HDR_128 = 0x43004300u;
// x is staged in chunks of at most 256 16-code blocks and 40 KB of shared
// memory: with 66 KB a block, G's ffn_down (144 blocks) ran 1.2x slower at
// M = 8 than with 40 KB (measured)
constexpr int GV_CB = 256, GV_SMEM = 40 * 1024;

// the int8 codes at bits 0-7 and 16-23 of w → their bf16x2, exactly
__device__ __forceinline__ uint32_t i8x2(uint32_t w) {
  return bf16x2_sub(lop3_and_or(w, LOW7, HDR_128), lop3_and_or(w, SIGN, HDR_128));
}

// one 16-code block of rows g (w0) and g + 8 (w1) times the lane's x
// fragment (b0, b1), added to p
__device__ __forceinline__ void block16(float (&p)[4], uint32_t w0, uint32_t w1, uint32_t b0,
                                        uint32_t b1) {
  mma_16816(p, i8x2(w0), i8x2(w1), i8x2(w0 >> 8), i8x2(w1 >> 8), b0, b1);
}

// x fragment of block `bl` of the staged chunk: lane (g, t) reads codes
// 4t..4t+3 of x row g and orders them as its B slots
__device__ __forceinline__ uint2 x_frag(const unsigned char* xrow, int bl, int t, bool live) {
  if (!live) return make_uint2(0, 0);
  const uint2 u = *reinterpret_cast<const uint2*>(xrow + 32 * bl + 8 * t);
  return make_uint2(prmt(u.x, u.y, 0x5410), prmt(u.x, u.y, 0x7632));
}

// a group's fresh products folded into the rows' sums: p scaled by the
// group's scales of rows g (s0) and g + 8 (s1); with mins, the group's x
// sums q times the mins subtracted
template <bool MINS>
__device__ __forceinline__ void fold(float (&acc)[4], const float (&p)[4], const float (&q)[4],
                                     float s0, float s1, float m0, float m1) {
  acc[0] = fmaf(s0, p[0], acc[0]);
  acc[1] = fmaf(s0, p[1], acc[1]);
  acc[2] = fmaf(s1, p[2], acc[2]);
  acc[3] = fmaf(s1, p[3], acc[3]);
  if (MINS) {
    acc[0] = fmaf(-m0, q[0], acc[0]);
    acc[1] = fmaf(-m0, q[1], acc[1]);
    acc[2] = fmaf(-m1, q[0], acc[2]);
    acc[3] = fmaf(-m1, q[1], acc[3]);
  }
}

// four blocks of rows g and g + 8: the 16 bytes of block b0 + t of each,
// and the four blocks' scales and mins of each (g32: two groups, .x .y)
struct Group {
  uint4 q[2];
  float4 s[2], m[2];
};

template <bool G32>
__device__ __forceinline__ float4 load_scales(const float* p, bool vec) {
  if (G32) {
    const float2 v = vec ? __ldg(reinterpret_cast<const float2*>(p)) : make_float2(__ldg(p), __ldg(p + 1));
    return make_float4(v.x, v.y, 0.f, 0.f);
  }
  return vec ? __ldg(reinterpret_cast<const float4*>(p))
             : make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

template <bool G32, bool MINS>
__device__ __forceinline__ void load_group(Group& G, const int8_t* const (&qrow)[2],
                                           const float* const (&srow)[2],
                                           const float* const (&mrow)[2], int b0, int t, bool vec) {
  const int g0 = G32 ? b0 >> 1 : b0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    G.q[h] = __ldcs(reinterpret_cast<const uint4*>(qrow[h]) + b0 + t);
    G.s[h] = load_scales<G32>(srow[h] + g0, vec);
    if (MINS) G.m[h] = load_scales<G32>(mrow[h] + g0, vec);
  }
}

// Block: 8 warps over 16 weight rows each for one of ks slices of K (the
// block's 128 / ks rows); the slices meet in shared memory, added in order.
template <bool G32, bool MINS>
__global__ void __launch_bounds__(GV_WARPS * 32)
q8_gemv_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
               const int8_t* __restrict__ qs, const float* __restrict__ sc,
               const float* __restrict__ mn, __nv_bfloat16* __restrict__ y, int N, int ks,
               int cbm, bool vec) {
  extern __shared__ __align__(16) unsigned char xsm[];  // [M][pitch]: x rows of a chunk
  __shared__ float part[GV_WARPS][16][8];
  constexpr int BPG = G32 ? 2 : 1;  // blocks a scale group
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slice = warp % ks, rg = warp / ks;
  const int rows_per_block = (GV_WARPS / ks) * 16;
  const int nrow0 = blockIdx.x * rows_per_block + rg * 16;
  const int nb = K >> 4, ng = nb / BPG;
  const int8_t* qrow[2];
  const float* srow[2];
  const float* mrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = min(nrow0 + g + 8 * h, N - 1);  // rows past N: read, discarded
    qrow[h] = qs + (size_t)row * K;
    srow[h] = sc + (size_t)row * ng;
    mrow[h] = MINS ? mn + (size_t)row * ng : nullptr;
  }
  const bool live = g < M;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int c0 = 0; c0 < nb; c0 += cbm) {
    const int cb = min(cbm, nb - c0), pitch = cb * 32 + 32;
    const int per = (((cb + ks - 1) / ks) + 3) & ~3;
    const int lo = min(cb, slice * per), hi = min(cb, lo + per);
    const int groups = (hi - lo) >> 2;
    Group A;
    if (groups > 0) load_group<G32, MINS>(A, qrow, srow, mrow, c0 + lo, t, vec);  // in flight while x lands
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < M * cb * 2; e += blockDim.x) {  // x rows < M: 16-byte copies
      const int r = e / (cb * 2), c = e % (cb * 2);
      cp_async16(xsm + r * pitch + 16 * c, x + (size_t)r * K + (size_t)c0 * 16 + 8 * c);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const unsigned char* xrow = xsm + (live ? g : 0) * pitch;
    for (int i = 0; i < groups; ++i) {
      Group B;
      if (i + 1 < groups) load_group<G32, MINS>(B, qrow, srow, mrow, c0 + lo + 4 * (i + 1), t, vec);
      uint32_t w[2][4];
      quad_transpose(A.q[0], t, w[0]);
      quad_transpose(A.q[1], t, w[1]);
      float p[4], q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j % BPG == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = q[e] = 0.f;
        }
        const uint2 xv = x_frag(xrow, lo + 4 * i + j, t, live);
        block16(p, w[0][j], w[1][j], xv.x, xv.y);
        if (MINS) mma_16816(q, BF16X2_ONE, BF16X2_ONE, BF16X2_ONE, BF16X2_ONE, xv.x, xv.y);
        if (j % BPG == BPG - 1) {
          const int si = j / BPG;
          fold<MINS>(acc, p, q, comp(A.s[0], si), comp(A.s[1], si), MINS ? comp(A.m[0], si) : 0.f,
                     MINS ? comp(A.m[1], si) : 0.f);
        }
      }
      A = B;
    }
    // the last blocks of a slice (fewer than four): word t of each directly
    for (int b = lo + 4 * groups; b < hi; b += BPG) {
      float p[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BPG; ++j) {
        const int gb = c0 + b + j;
        const uint32_t w0 = __ldcs(reinterpret_cast<const uint32_t*>(qrow[0] + 16 * gb) + t);
        const uint32_t w1 = __ldcs(reinterpret_cast<const uint32_t*>(qrow[1] + 16 * gb) + t);
        const uint2 xv = x_frag(xrow, b + j, t, live);
        block16(p, w0, w1, xv.x, xv.y);
        if (MINS) mma_16816(q, BF16X2_ONE, BF16X2_ONE, BF16X2_ONE, BF16X2_ONE, xv.x, xv.y);
      }
      const int gi = (c0 + b) / BPG;
      fold<MINS>(acc, p, q, __ldg(srow[0] + gi), __ldg(srow[1] + gi),
                 MINS ? __ldg(mrow[0] + gi) : 0.f, MINS ? __ldg(mrow[1] + gi) : 0.f);
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

template <bool G32, bool MINS>
cudaError_t gemv_launch(const __nv_bfloat16* x, const int8_t* qs, const float* sc, const float* mn,
                        __nv_bfloat16* y, int M, int K, int N, cudaStream_t st) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int ks = gemv_ks(K, N, sms);
  const int rows = (GV_WARPS / ks) * 16;
  // a group of four blocks reads its scales (and mins) by one vector load
  // where every row of them is aligned to it
  const int per = G32 ? 2 : 4, ng = K / (16 * (G32 ? 2 : 1));
  const auto aligned = [&](const float* p) { return reinterpret_cast<uintptr_t>(p) % (4 * per) == 0; };
  const bool vec = ng % per == 0 && aligned(sc) && (!MINS || aligned(mn));
  const int cbm = min(GV_CB, (GV_SMEM / M - 32) / 32) & ~3;  // blocks of a chunk
  const int smem = M * (min(K / 16, cbm) * 32 + 32);
  q8_gemv_kernel<G32, MINS><<<(N + rows - 1) / rows, GV_WARPS * 32, smem, st>>>(
      x, M, K, qs, sc, mn, y, N, ks, cbm, vec);
  return cudaGetLastError();
}

cudaError_t gemv(const __nv_bfloat16* x, const int8_t* qs, const float* sc, const float* mn,
                 __nv_bfloat16* y, int M, int K, int N, int gshift, cudaStream_t st) {
  if (gshift == 5)
    return mn ? gemv_launch<true, true>(x, qs, sc, mn, y, M, K, N, st)
              : gemv_launch<true, false>(x, qs, sc, mn, y, M, K, N, st);
  return mn ? gemv_launch<false, true>(x, qs, sc, mn, y, M, K, N, st)
            : gemv_launch<false, false>(x, qs, sc, mn, y, M, K, N, st);
}

// ---------------------------------------------------------------------------
// M > 8: wgmma tiles, y^T = W x^T

constexpr int TN = T8_ROWS, TK = 128;  // weight rows a block, codes a stage
constexpr int T_THREADS = T8_THREADS;  // two consumer warpgroups, one producer warp
constexpr int SMEM_MAX = 232448;       // 227 KB a block

template <int BM>
struct TileShape {
  static constexpr int X_BYTES = BM * 128;        // one of the stage's two 64-code x tiles
  static constexpr int W_OFF = 2 * X_BYTES;       // codes: 128 rows of 128 bytes
  static constexpr int S_OFF = W_OFF + TN * 128;  // scales: 128 rows of up to 8 f32
  static constexpr int M_OFF = S_OFF + TN * 32;   // mins: the same
  static constexpr int STAGE = M_OFF + TN * 32;   // a multiple of 1024
  static constexpr int STAGES = (SMEM_MAX - 2048) / STAGE < 6 ? (SMEM_MAX - 2048) / STAGE : 6;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
};

// byte i of w (sign-flipped, u = q + 128) as the f32 1 + u 2^-15: bytes
// (0x00, u, 0x80, 0x3F)
__device__ __forceinline__ float u_f32(uint32_t w, uint32_t sel) {
  return __uint_as_float(prmt(w, 0x3F800000u, sel));
}

// Block (row tile, slice; m tile): 128 weight rows (64 with KS) times BM
// rows of x over the slice's stages; with CL a cluster holds the row tile's
// slices (a kernel without CL has no cluster code at all: measured faster)
template <int BM, bool KS, bool CL>
__global__ void __launch_bounds__(T_THREADS, 1)
q8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap smap, const __grid_constant__ CUtensorMap mmap,
                int M, int K, const float* __restrict__ sc, const float* __restrict__ mn,
                __nv_bfloat16* __restrict__ y, int N, int gshift, bool scales_by_tma) {
  using S = TileShape<BM>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char tsm_raw[];
  unsigned char* tsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tsm_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int ks = CL ? cg::this_cluster().num_blocks() : 1;
  const int slice = CL ? cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int RB = KS ? 64 : TN;  // weight rows a block
  const int n0 = blockIdx.x / ks * RB, m0 = blockIdx.y * BM;
  const int ng = K >> gshift, spg = TK >> gshift, kt_n = (K + TK - 1) / TK;  // spg: scales a row a stage
  const int kt0 = slice * kt_n / ks, kt_end = (slice + 1) * kt_n / ks;  // the slice's stages
  const bool mins = mn != nullptr;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], scales_by_tma ? 1 : 1 + 32);  // expect_tx (+ the lanes' copies)
      mbar_init(&empty[s], KS ? 1 : 2);  // one thread of each group that reads the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = (KS ? 0 : 64 * wg) + 16 * (warp & 3) + g;  // this lane's rows r0 and r0 + 8
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  if (warp == 8) {  // the producer warp: every operand by TMA from lane 0
    const int sbytes = RB * spg * 4 * (mins ? 2 : 1);
    const int tx = 2 * S::X_BYTES + RB * TK + (scales_by_tma ? sbytes : 0);
    for (int kt = kt0; kt < kt_end; ++kt) {
      const int i = kt - kt0, s = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      unsigned char* st = tsm + s * S::STAGE;
      if (lane == 0) {
        mbar_expect_tx(&full[s], tx);
        tma_load_2d(st, &xmap, kt * TK, m0, &full[s]);
        tma_load_2d(st + S::X_BYTES, &xmap, kt * TK + 64, m0, &full[s]);
        tma_load_2d(st + S::W_OFF, &qmap, kt * TK, n0, &full[s]);
        if (scales_by_tma) {
          tma_load_2d(st + S::S_OFF, &smap, kt * spg, n0, &full[s]);
          if (mins) tma_load_2d(st + S::M_OFF, &mmap, kt * spg, n0, &full[s]);
        }
      }
      if (!scales_by_tma) {  // scale rows not 16-byte strided or aligned: 4-byte copies
        const int per = RB * spg;
        for (int e = lane; e < per * (mins ? 2 : 1); e += 32) {
          const int which = e >= per, f = e - which * per, r = f / spg, j = f % spg;
          const int n = n0 + r, gi = kt * spg + j;
          const bool ok = n < N && gi < ng;
          const float* src = (which ? mn : sc) + (ok ? (size_t)n * ng + gi : 0);
          cp_async4(st + (which ? S::M_OFF : S::S_OFF) + r * spg * 4 + 4 * j, src, ok);
        }
        cp_async_arrive(&full[s]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives its thread
    if constexpr (!CL) return;
  } else {
    // consumers: with KS both groups own the tile's 64 rows and take
    // alternate stages (their sums meet at the end, group 0's first); else
    // group wg owns rows 64 wg .. 64 wg + 63 and takes every stage
    const int gs = gshift - 4;  // a scale group is 1 << gs k16 steps
    // lane t's A slots are codes 2t, 2t+1 (word t/2 of a 16-code chunk) and
    // 2t+8, 2t+9 (word 2 + t/2), bytes 2(t&1) and 2(t&1) + 1 of each word
    const uint32_t sel0 = 0x7604u | ((2u * (t & 1)) << 4), sel1 = sel0 + 0x10u;
    const int wofs = 4 * (t >> 1);
    fence_regs(acc);
    // a stage is two halves of four k16 steps. A half's A fragment lives in
    // registers that its products read while they run, so a group waits for
    // them before it decodes the next half; the other group's products keep
    // the tensor cores busy meanwhile
    auto half = [&](const unsigned char* st, int hb) {
      const float* s_r0 = reinterpret_cast<const float*>(st + S::S_OFF) + r0 * spg;
      const float* m_r0 = reinterpret_cast<const float*>(st + S::M_OFF) + r0 * spg;
      uint32_t a[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * hb + jj, si = j >> gs;
        const float s0 = s_r0[si], s1 = s_r0[8 * spg + si];
        const float mm0 = mins ? m_r0[si] : 0.f, mm1 = mins ? m_r0[8 * spg + si] : 0.f;
        // s q - m = 2^15 s (1 + u 2^-15) - (32896 s + m), u = q + 128
        const float sa = 32768.f * s0, sb = 32768.f * s1;
        const float ca = -fmaf(32896.f, s0, mm0), cb = -fmaf(32896.f, s1, mm1);
        // chunk j of rows r0 and r0 + 8 sits at chunk j ^ (row & 7) = j ^ g (128-byte swizzle)
        const unsigned char* ch = st + S::W_OFF + r0 * 128 + ((j ^ g) << 4) + wofs;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(ch) ^ FLIP;
        const uint32_t v0 = *reinterpret_cast<const uint32_t*>(ch + 8) ^ FLIP;
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(ch + 8 * 128) ^ FLIP;
        const uint32_t v1 = *reinterpret_cast<const uint32_t*>(ch + 8 * 128 + 8) ^ FLIP;
        a[jj][0] = bf16x2(fmaf(sa, u_f32(w0, sel0), ca), fmaf(sa, u_f32(w0, sel1), ca));
        a[jj][1] = bf16x2(fmaf(sb, u_f32(w1, sel0), cb), fmaf(sb, u_f32(w1, sel1), cb));
        a[jj][2] = bf16x2(fmaf(sa, u_f32(v0, sel0), ca), fmaf(sa, u_f32(v0, sel1), ca));
        a[jj][3] = bf16x2(fmaf(sb, u_f32(v1, sel0), cb), fmaf(sb, u_f32(v1, sel1), cb));
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
    for (int kt = kt0 + (KS ? wg : 0); kt < kt_end; kt += KS ? 2 : 1) {
      const int i = kt - kt0, s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* st = tsm + s * S::STAGE;
      half(st, 0);
      half(st, 1);
      // the group's products of this stage have completed, after every warp
      // of the group had read it: the stage is free
      if ((warp & 3) == 0 && lane == 0) mbar_arrive(&empty[s]);
    }
    fence_regs(acc);
  }
  tile_epilogue<BM, KS, CL>(acc, tsm, r0, n0, m0, M, N, y);
}

template <int BM, bool KS, bool CL>
cudaError_t launch_tiles(const void* x, const int8_t* qs, const float* sc, const float* mn,
                         __nv_bfloat16* y, int M, int K, int N, int gshift, int ks, cudaStream_t st) {
  static bool sized = false;  // one per instantiation: above 48 KB needs the opt-in
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        q8_wgmma_kernel<BM, KS, CL>, cudaFuncAttributeMaxDynamicSharedMemorySize, TileShape<BM>::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  constexpr int RB = KS ? 64 : TN;
  const int ng = K >> gshift, spg = TK >> gshift;
  const auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // TMA strides and addresses are multiples of 16 bytes
  const bool scales_by_tma = ng % 4 == 0 && aligned(sc) && (!mn || aligned(mn));
  CUtensorMap xm, qm, sm, mm;
  cudaError_t err = tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, 64, BM,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qs, N, K, TK, RB,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess && scales_by_tma)
    err = tensor_map(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sc, N, ng, spg, RB,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess && scales_by_tma && mn)
    err = tensor_map(&mm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, mn, N, ng, spg, RB,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  if (!scales_by_tma) sm = qm;  // unused
  if (!scales_by_tma || !mn) mm = sm;  // unused
  const dim3 grid((N + RB - 1) / RB * ks, (M + BM - 1) / BM);
  if (CL)
    return launch_clustered(q8_wgmma_kernel<BM, KS, CL>, grid, T_THREADS, TileShape<BM>::SMEM, ks, st,
                            xm, qm, sm, mm, M, K, sc, mn, y, N, gshift, scales_by_tma);
  q8_wgmma_kernel<BM, KS, CL><<<grid, T_THREADS, TileShape<BM>::SMEM, st>>>(
      xm, qm, sm, mm, M, K, sc, mn, y, N, gshift, scales_by_tma);
  return cudaGetLastError();
}

// a tile width: its K split by `tile_split`
template <int BM>
cudaError_t launch_width(const void* x, const int8_t* qs, const float* sc, const float* mn,
                         __nv_bfloat16* y, int M, int K, int N, int gshift, cudaStream_t st) {
  return tile_split<BM>(M, K, N, [&](auto ks_split, auto cl, int ks) {
    return launch_tiles<BM, decltype(ks_split)::value, decltype(cl)::value>(x, qs, sc, mn, y, M, K, N,
                                                                            gshift, ks, st);
  });
}

// the tile width: the least of 16, 32, 64, 128 that holds M (larger M
// takes several 128-wide row tiles)
cudaError_t tiles(const void* x, const int8_t* qs, const float* sc, const float* mn,
                  __nv_bfloat16* y, int M, int K, int N, int gshift, cudaStream_t st) {
  if (M <= 16) return launch_width<16>(x, qs, sc, mn, y, M, K, N, gshift, st);
  if (M <= 32) return launch_width<32>(x, qs, sc, mn, y, M, K, N, gshift, st);
  if (M <= 64) return launch_width<64>(x, qs, sc, mn, y, M, K, N, gshift, st);
  return launch_width<128>(x, qs, sc, mn, y, M, K, N, gshift, st);
}

}  // namespace

// x [M, K] bf16, qs [N, K] int8, scales/mins [N, K/group] f32 (mins may be
// null), y [M, N] bf16; group 16 or 32. Needs K % 32 == 0 and x, qs 16-byte
// aligned; any M and N.
extern "C" int nfai_q8_matmul(const void* x, const void* qs, const void* sc,
                              const void* mn, void* y, int M, int K, int N,
                              int group, void* stream) {
  if (K % 32 != 0 || M < 1 || N < 1 || (group != 16 && group != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto q = static_cast<const int8_t*>(qs);
  auto s = static_cast<const float*>(sc);
  auto m = static_cast<const float*>(mn);
  auto yb = static_cast<__nv_bfloat16*>(y);
  const int gshift = group == 16 ? 4 : 5;
  if (M == 1) return static_cast<int>(gemv_m1(xb, q, s, m, yb, K, N, gshift, st));
  if (M <= 8) return static_cast<int>(gemv(xb, q, s, m, yb, M, K, N, gshift, st));
  return static_cast<int>(tiles(x, q, s, m, yb, M, K, N, gshift, st));
}

