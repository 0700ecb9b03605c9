// K12: 8-bit dequant-matmul on the q8v3 nibble planes,
//      y[M, N] = x[M, K] @ W^T with W[n, k] = u0[n, k] * s8[n, k / g] (- m[n, k / g]),
//      u0 = v / 8 decoded from the planes (bf16 x, f32 accumulation, bf16 out).
//
// Replaces the Pallas kernel nfai_tpu/ops/qmatmul.py::_q8v3_matmul_layered
// (body _q8v3l_kernel): layer `layer` of a stacked q8v3 container, and the
// JAX 2-D q8v3 head as a one-layer stack. The layer is read in place: the
// wrapper passes the layer's view, an offset into the stacked buffers.
//
// Container (nfai_tpu_torch/ops/qtensor.py, "the q8v3 container"): qs
// uint8 [N, K], each row in chunks of 128 codes; code c = 32b + 16i + 4t + j
// of a chunk sits in plane p (lo = v & 0xF, hi = (v >> 4) + 8) at bytes
// [64p + 16t + 4b, +4), a little-endian word, in nibble NIB[4i + j] with
// NIB = (0, 4, 1, 5, 2, 6, 3, 7). Scales s8 = 8s and mins are bf16 [N, K/g].
//
// What bounds it on an H100: decode (M <= 8) reads a byte a weight plus
// the scales and does 2M flops on it: bytes (4096 x 28672 at M = 8:
// 117 MB + 7.3 MB of scales, 0.037 ms at 3.35 TB/s). Prefill rows are
// bound by operations (gate_up at M = 1024: 0.243 ms at 989 TF/s).
//
// M <= 8: a GEMV, as K11's: a warp owns 8 output rows and a slice of K;
// lane (g, t) loads 16 bytes of each plane of row n0 + g per chunk (the
// streaming hint: read once), decodes 4 words a plane into 16 B fragments
// and runs 8 mma.sync m16n8k16 products against x rows 0..7 (rows 8..15 of
// A zero). Decode with bit operations only: for a lo word w,
// lop3((w << 3), 0x00780078, 0x40004000) is the bf16x2 (2 + lo_a / 8,
// 2 + lo_b / 8) of nibbles 0 and 4; (w >> 1), (w >> 5) and (w >> 9) give
// nibbles 1/5, 2/6 and 3/7. A hi word under the header 0x42004200 gives
// (32 + 2 hi_a, 32 + 2 hi_b). One packed bf16x2 subtract and one add,
// u0 = (hi - 50) + lo, is exact (|u0| <= 16 in steps of 1/8: 8 significant
// bits) and equals v / 8 (the JAX kernel's fold). Lane (g, t) holds codes
// 4t..4t+3 of each 16-code half of a 32-block: logical k slots (2t, 2t+1,
// 2t+8, 2t+9) of the fragment, and x is loaded in the same order; each
// product's f32 partial is scaled by its group's scale in f32, and kinds
// with mins subtract m * sum(x) (a product against ones). A block of 8
// warps splits K into ks slices; the slices' sums meet in shared memory
// and one thread adds them in slice order.
//
// M > 8: wgmma tiles computing y^T = W x^T, K6's tiles (q8_matmul.cu) with
// K12's decode: the weight is the 64-row register A operand of each
// consumer warpgroup (the RS form m64nBMk16), x the B operand, brought by
// TMA in natural K order as two 64-code boxes under the 128-byte swizzle;
// BM = 16, 32, 64 or 128, the least that holds M (larger M takes several
// 128-wide tiles). Two consumer warpgroups and one producer warp; per
// 128-code stage the producer's lane 0 brings x and the planes by TMA into
// a ring of 4-6 stages under mbarriers (a row's chunk is 128 bytes, 64 of
// lo then 64 of hi, one box of 128 bytes a row under the 128-byte swizzle,
// so the eight rows a warp reads at once sit in different banks), and its
// 32 lanes copy the chunk's scales and mins (16 or 8 bytes a row: too
// narrow for a TMA box at g32) by cp.async onto the same mbarrier.
// The fragment mapping: wgmma's A gives lane (g, t) the natural k slots 2t,
// 2t+1, 2t+8, 2t+9 of each 16-code step, for rows g and g+8. Those are
// codes j = 2(t&1), +1 of word t' = t>>1 (slots 2t, 2t+1) and of word
// 2 + (t>>1) (2t+8, 2t+9) of block b = step / 2, half i = step % 2: the
// lane reads the 16-byte chunks t>>1 and 2 + (t>>1) of each plane (two
// lanes share each: a broadcast) and takes word b of each. The two planes'
// words of the same codes join into the sign-flipped bytes u = v + 128 =
// lo | hi << 4 by one lop3 after shifting by 4(t&1): byte 2k of the result
// holds the code in nibble 2k + (t&1), so bytes 0 and 2 are the lane's
// pair of half 0 and bytes 1 and 3 (>> 8) its pair of half 1. A pair of
// bytes becomes the exact bf16x2 of v / 16 by two lop3 and one packed
// subtract (0x4100 | (u & 0x7F) is 8 + (u & 0x7F) / 16; 0x4100 | (~u &
// 0x80) is 8 or 16), and one packed fma folds the group's scale and min:
// A = bf16(v / 16 * s8 - m / 2) = W / 2 rounded once, so the f32 sums are
// doubled at the end (exact). About 3.1 operations a code on the CUDA
// cores, in batches of a whole stage (widths 64, 128) or half of one (16,
// 32); a batch's A registers are read while its products run, so a group
// waits for them before it decodes the next batch, and the other group's
// products fill the tensor cores meanwhile. They run at 1.6-1.8x cuBLAS at
// M = 1024, as K6's tiles do; sharing each x tile across a cluster of two
// row tiles by TMA multicast (half the L2 traffic) and double-buffering A
// (a group's decode beside its own products) both ran slower (PERF.md
// §6): neither L2 traffic nor a group's own decode bounds them. Small N:
// K split across a cluster of blocks, their sums met in distributed shared
// memory in slice order (sm90.cuh's `tile_split` and `tile_epilogue`,
// shared with K6).
// Every output is summed in a fixed order: no atomics, the same bits on
// every launch.
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t NIB_MASK = 0x00780078u, HDR_LO = 0x40004000u, HDR_HI = 0x42004200u;
constexpr uint32_t BF16X2_50 = 0x42484248u;

__device__ __forceinline__ uint32_t bf16x2_fold(uint32_t hi, uint32_t lo) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&hi);
  __nv_bfloat162 l = *reinterpret_cast<__nv_bfloat162*>(&lo);
  const uint32_t off_bits = BF16X2_50;
  const __nv_bfloat162 off = *reinterpret_cast<const __nv_bfloat162*>(&off_bits);
  __nv_bfloat162 u = __hadd2(__hsub2(h, off), l);  // exact: (32 + 2 hi - 50) + (2 + lo / 8)
  return *reinterpret_cast<uint32_t*>(&u);
}

// one lo word and one hi word → the B fragments of the two products of a
// 32-block: u[0], u[1] for half 0 (codes 4t..4t+3), u[2], u[3] for half 1
__device__ __forceinline__ void decode_block(uint32_t wl, uint32_t wh, uint32_t (&u)[4]) {
  u[0] = bf16x2_fold(lop3_and_or(wh << 3, NIB_MASK, HDR_HI), lop3_and_or(wl << 3, NIB_MASK, HDR_LO));
  u[1] = bf16x2_fold(lop3_and_or(wh >> 1, NIB_MASK, HDR_HI), lop3_and_or(wl >> 1, NIB_MASK, HDR_LO));
  u[2] = bf16x2_fold(lop3_and_or(wh >> 5, NIB_MASK, HDR_HI), lop3_and_or(wl >> 5, NIB_MASK, HDR_LO));
  u[3] = bf16x2_fold(lop3_and_or(wh >> 9, NIB_MASK, HDR_HI), lop3_and_or(wl >> 9, NIB_MASK, HDR_LO));
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int b) {
  return b == 0 ? v.x : (b == 1 ? v.y : (b == 2 ? v.z : v.w));
}

// ---------------------------------------------------------------------------
// M <= 8: the GEMV

constexpr int GV_U = 2;  // chunks a load batch (GV_WARPS warps a block)

// the chunk's G-groups of scale (or min) of one row: GPC = 128 / G bf16
template <int G>
__device__ __forceinline__ void load_group_row(const __nv_bfloat16* __restrict__ p, float* f) {
  if constexpr (G == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf16_bits_to_float(w[i] & 0xFFFFu);
      f[2 * i + 1] = bf16_bits_to_float(w[i] >> 16);
    }
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    f[0] = bf16_bits_to_float(v.x & 0xFFFFu);
    f[1] = bf16_bits_to_float(v.x >> 16);
    f[2] = bf16_bits_to_float(v.y & 0xFFFFu);
    f[3] = bf16_bits_to_float(v.y >> 16);
  }
}

template <int G, bool MINS>
__global__ void __launch_bounds__(GV_WARPS * 32)
q8v3_gemv_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                 const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ sc,
                 const __nv_bfloat16* __restrict__ mn, __nv_bfloat16* __restrict__ y, int N,
                 int ks) {
  constexpr int GPC = 128 / G;  // scale groups a chunk
  __shared__ float part[GV_WARPS][8][8];  // [warp][m][n]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slice = warp % ks, rg = warp / ks;
  const int rows_per_block = (GV_WARPS / ks) * 8;
  const int n0 = blockIdx.x * rows_per_block + rg * 8;
  const int chunks = K / 128;
  const int per = (chunks + ks - 1) / ks;
  const int c_lo = slice * per, c_hi = min(chunks, c_lo + per);
  const bool wrow = n0 + g < N, xrow = g < M;
  // lane (g, t): plane words of row n0 + g; x row g; the scales of the
  // output columns it holds, rows n0 + 2t and n0 + 2t + 1
  const uint4* wp = reinterpret_cast<const uint4*>(qs + (size_t)(wrow ? n0 + g : 0) * K) + t;
  const __nv_bfloat16* xp = x + (size_t)(xrow ? g : 0) * K + 4 * t;
  const int r0 = min(n0 + 2 * t, N - 1), r1 = min(n0 + 2 * t + 1, N - 1);
  const int kg = K / G;
  const __nv_bfloat16* s0p = sc + (size_t)r0 * kg;
  const __nv_bfloat16* s1p = sc + (size_t)r1 * kg;
  const __nv_bfloat16* m0p = MINS ? mn + (size_t)r0 * kg : nullptr;
  const __nv_bfloat16* m1p = MINS ? mn + (size_t)r1 * kg : nullptr;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  float acc0 = 0.f, acc1 = 0.f;  // (x row g, columns n0 + 2t, n0 + 2t + 1)

  for (int c0 = c_lo; c0 < c_hi; c0 += GV_U) {
    uint4 wl[GV_U], wh[GV_U];
#pragma unroll
    for (int u = 0; u < GV_U; ++u) {
      const bool ok = wrow && c0 + u < c_hi;
      wl[u] = ok ? __ldcs(wp + (size_t)(c0 + u) * 8) : zero4;  // a chunk is 8 uint4: lo 0..3, hi 4..7
      wh[u] = ok ? __ldcs(wp + (size_t)(c0 + u) * 8 + 4) : zero4;
    }
#pragma unroll
    for (int u = 0; u < GV_U; ++u) {
      const int c = c0 + u;
      if (c >= c_hi) break;
      float s0[GPC], s1[GPC], m0[MINS ? GPC : 1], m1[MINS ? GPC : 1];
      load_group_row<G>(s0p + c * GPC, s0);
      load_group_row<G>(s1p + c * GPC, s1);
      if constexpr (MINS) {
        load_group_row<G>(m0p + c * GPC, m0);
        load_group_row<G>(m1p + c * GPC, m1);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        uint32_t fr[4];
        decode_block(word_of(wl[u], b), word_of(wh[u], b), fr);
        float p[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint2 xv = xrow ? __ldg(reinterpret_cast<const uint2*>(xp + c * 128 + 32 * b + 16 * i))
                                : make_uint2(0, 0);
          mma_16816(p, xv.x, 0u, xv.y, 0u, fr[2 * i], fr[2 * i + 1]);
          if constexpr (MINS) mma_16816(q, xv.x, 0u, xv.y, 0u, BF16X2_ONE, BF16X2_ONE);
          if (G == 16 || i == 1) {  // the group ends: scale its partial in f32
            const int gi = (32 * b + 16 * i) / G;
            acc0 = fmaf(s0[gi], p[0], acc0);
            acc1 = fmaf(s1[gi], p[1], acc1);
            if constexpr (MINS) {
              acc0 = fmaf(-m0[gi], q[0], acc0);
              acc1 = fmaf(-m1[gi], q[1], acc1);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) p[e] = q[e] = 0.f;
          }
        }
      }
    }
  }
  part[warp][g][2 * t] = acc0;
  part[warp][g][2 * t + 1] = acc1;
  __syncthreads();
  const int outs = (GV_WARPS / ks) * 64;
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

// ---------------------------------------------------------------------------
// M > 8: wgmma tiles, y^T = W x^T

constexpr int TN = T8_ROWS, TK = 128;  // weight rows a block, codes a stage
constexpr int SMEM_MAX = 232448;       // 227 KB a block
constexpr uint32_t LOW7 = 0x007F007Fu, SIGN = 0x00800080u, LOW_NIBS = 0x0F0F0F0Fu;
constexpr uint32_t HDR_8 = 0x41004100u;     // bf16x2 (8, 8): its mantissa's ulp is 1/16
constexpr uint32_t NEG_HALF = 0xBF00BF00u;  // bf16x2 (-0.5, -0.5)

template <int BM>
struct TileShape {
  static constexpr int X_BYTES = BM * 128;        // one of the stage's two 64-code x tiles
  static constexpr int W_OFF = 2 * X_BYTES;       // planes: 128 rows of 128 bytes
  static constexpr int S_OFF = W_OFF + TN * 128;  // s8: 128 rows of 16 bytes (8 bf16; 4 at g32)
  static constexpr int M_OFF = S_OFF + TN * 16;   // mins: the same
  static constexpr int STAGE = M_OFF + TN * 16;   // a multiple of 1024
  static constexpr int STAGES = (SMEM_MAX - 2048) / STAGE < 6 ? (SMEM_MAX - 2048) / STAGE : 6;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
};

// (a & c) | (b & ~c): the LUT of f(0xF0, 0xCC, 0xAA) is 0xE4
__device__ __forceinline__ uint32_t lop3_select(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// (~a & b) | c: the LUT of f(0xF0, 0xCC, 0xAA) is 0xAE
__device__ __forceinline__ uint32_t lop3_andnot_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xAE;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  __nv_bfloat162 r = __hfma2(*reinterpret_cast<__nv_bfloat162*>(&a), *reinterpret_cast<__nv_bfloat162*>(&b),
                             *reinterpret_cast<__nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a), *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// bf16 number i of the 8 in v, in both halves of a bf16x2
__device__ __forceinline__ uint32_t bf16_pair(const uint4& v, int i) {
  return prmt(word_of(v, i >> 1), 0u, (i & 1) ? 0x3232u : 0x1010u);
}

// the sign-flipped bytes u at bits 0-7 and 16-23 of w → the bf16x2 of
// v / 16 = (u - 128) / 16, exactly; times the scale pair s8, plus the
// pair nm = -m / 2: bf16(W / 2), rounded once
__device__ __forceinline__ uint32_t a_pair(uint32_t w, uint32_t s8, uint32_t nm) {
  const uint32_t v16 = bf16x2_sub(lop3_and_or(w, LOW7, HDR_8), lop3_andnot_or(w, SIGN, HDR_8));
  return bf16x2_fma(v16, s8, nm);
}

__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src, bool ok, int bytes) {
  const int n = ok ? bytes : 0;  // 0 source bytes: zero-filled
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(n));
}

// Block (row tile, slice; m tile): 128 weight rows (64 with KS) times BM
// rows of x over the slice's stages; with CL a cluster holds the row tile's
// slices. G32: scale groups of 32 codes (else 16).
template <int BM, bool KS, bool CL, bool G32>
__global__ void __launch_bounds__(T8_THREADS, 1)
q8v3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
                  int M, int K, const __nv_bfloat16* __restrict__ sc,
                  const __nv_bfloat16* __restrict__ mn, __nv_bfloat16* __restrict__ y, int N) {
  using S = TileShape<BM>;
  constexpr int STAGES = S::STAGES;
  constexpr int SPG = G32 ? 4 : 8;  // scales a row a stage
  extern __shared__ unsigned char tsm_raw[];
  unsigned char* tsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tsm_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int ks = CL ? cg::this_cluster().num_blocks() : 1;
  const int slice = CL ? cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int RB = KS ? 64 : TN;  // weight rows a block
  const int n0 = blockIdx.x / ks * RB, m0 = blockIdx.y * BM;
  const int ng = K / (G32 ? 32 : 16), kt_n = K / TK;
  const int kt0 = slice * kt_n / ks, kt_end = (slice + 1) * kt_n / ks;  // the slice's stages
  const bool mins = mn != nullptr;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // expect_tx, and the lanes' scale copies
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
  if (warp == 8) {  // the producer warp: x and the planes by TMA from lane 0, the scales by cp.async
    const int tx = 2 * S::X_BYTES + RB * TK;
    for (int kt = kt0; kt < kt_end; ++kt) {
      const int i = kt - kt0, s = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      unsigned char* st = tsm + s * S::STAGE;
      if (lane == 0) {
        mbar_expect_tx(&full[s], tx);
        tma_load_2d(st, &xmap, kt * TK, m0, &full[s]);
        tma_load_2d(st + S::X_BYTES, &xmap, kt * TK + 64, m0, &full[s]);
        tma_load_2d(st + S::W_OFF, &qmap, kt * TK, n0, &full[s]);
      }
      for (int e = lane; e < RB * (mins ? 2 : 1); e += 32) {  // a row's scales (mins): 2 * SPG bytes
        const int which = e >= RB, r = e - which * RB, n = n0 + r;
        const bool ok = n < N;
        const __nv_bfloat16* src = (which ? mn : sc) + (ok ? (size_t)n * ng + kt * SPG : 0);
        cp_async_bytes(st + (which ? S::M_OFF : S::S_OFF) + r * 16, src, ok, 2 * SPG);
      }
      cp_async_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives its thread
    if constexpr (!CL) return;
  } else {
    // consumers: with KS both groups own the tile's 64 rows and take
    // alternate stages (their sums meet at the end, group 0's first); else
    // group wg owns rows 64 wg .. 64 wg + 63 and takes every stage.
    // Lane t's chunks of a row: lo A = t>>1, lo B = 2 + (t>>1), hi A = 4 +
    // (t>>1), hi B = 6 + (t>>1); chunk c of rows r0 and r0 + 8 sits at
    // chunk c ^ g (the 128-byte swizzle)
    const int sl = 4 * (t & 1), sh = 4 - sl;  // the joins' shifts: nibble 2k + (t & 1) to byte 2k
    fence_regs(acc);
    // A stage is eight k16 steps, decoded and multiplied in NB batches: the
    // whole stage at widths 64 and 128, halves at 16 and 32 (measured:
    // M = 64 ran 4-13% faster in one batch, M = 32 3-15% slower). A batch's
    // A fragment lives in registers that its products read while they run,
    // so a group waits for them before it decodes the next batch; the other
    // group's products fill the tensor cores meanwhile.
    constexpr int NB = BM >= 64 ? 1 : 2, SB = 8 / NB;  // batches a stage, k16 steps a batch
    auto batch = [&](const unsigned char* st, int hb, const uint4 (&q)[2][4], const uint4 (&sv)[2],
                     const uint4 (&mv)[2]) {
      uint32_t a[SB][4];
#pragma unroll
      for (int bb = 0; bb < SB / 2; ++bb) {
        const int b = (SB / 2) * hb + bb;  // the 32-block
        uint32_t u[2][2];           // [row r0, r0 + 8][word A, word B]: the joined bytes
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          u[h][0] = lop3_select(word_of(q[h][0], b) >> sl, word_of(q[h][2], b) << sh, LOW_NIBS);
          u[h][1] = lop3_select(word_of(q[h][1], b) >> sl, word_of(q[h][3], b) << sh, LOW_NIBS);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int jj = 2 * bb + i, si = G32 ? b : 2 * b + i;  // the step in the batch; its group
          uint32_t s8[2], nm[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s8[h] = bf16_pair(sv[h], si);
            nm[h] = mins ? bf16x2_mul(bf16_pair(mv[h], si), NEG_HALF) : 0u;
          }
          a[jj][0] = a_pair(u[0][0] >> (8 * i), s8[0], nm[0]);
          a[jj][1] = a_pair(u[1][0] >> (8 * i), s8[1], nm[1]);
          a[jj][2] = a_pair(u[0][1] >> (8 * i), s8[0], nm[0]);
          a[jj][3] = a_pair(u[1][1] >> (8 * i), s8[1], nm[1]);
        }
      }
      uint64_t desc[SB];
#pragma unroll
      for (int j = 0; j < SB; ++j) {
        const int step = SB * hb + j;  // x: steps 0-3 in the first 64-code box, 4-7 in the second
        desc[j] = sw128_desc(st + (step >> 2) * S::X_BYTES + 32 * (step & 3));
        pin(a[j], desc[j]);  // operands final before the fence: nothing sinks between products
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < SB; ++j) wgmma_rs<BM>(acc, a[j], desc[j]);
      wgmma_commit();
      wgmma_wait<0>();
    };
    const uint4 zero4 = make_uint4(0, 0, 0, 0);
    for (int kt = kt0 + (KS ? wg : 0); kt < kt_end; kt += KS ? 2 : 1) {
      const int i = kt - kt0, s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* st = tsm + s * S::STAGE;
      uint4 q[2][4], sv[2], mv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* row = st + S::W_OFF + (r0 + 8 * h) * 128;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          q[h][c] = *reinterpret_cast<const uint4*>(row + (((2 * c + (t >> 1)) ^ g) << 4));
        sv[h] = *reinterpret_cast<const uint4*>(st + S::S_OFF + (r0 + 8 * h) * 16);
        mv[h] = mins ? *reinterpret_cast<const uint4*>(st + S::M_OFF + (r0 + 8 * h) * 16) : zero4;
      }
#pragma unroll
      for (int hb = 0; hb < NB; ++hb) batch(st, hb, q, sv, mv);
      // the group's products of this stage have completed, after every warp
      // of the group had read it: the stage is free
      if ((warp & 3) == 0 && lane == 0) mbar_arrive(&empty[s]);
    }
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] *= 2.f;  // the products were of W / 2
  }
  tile_epilogue<BM, KS, CL>(acc, tsm, r0, n0, m0, M, N, y);
}

template <int BM, bool KS, bool CL, bool G32>
cudaError_t launch_tiles(const void* x, const uint8_t* qs, const __nv_bfloat16* sc,
                         const __nv_bfloat16* mn, __nv_bfloat16* y, int M, int K, int N, int ks,
                         cudaStream_t st) {
  static bool sized = false;  // one per instantiation: above 48 KB needs the opt-in
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(q8v3_wgmma_kernel<BM, KS, CL, G32>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 TileShape<BM>::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  constexpr int RB = KS ? 64 : TN;
  CUtensorMap xm, qm;
  cudaError_t err = tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, 64, BM,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qs, N, K, TK, RB,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + RB - 1) / RB * ks, (M + BM - 1) / BM);
  if (CL)
    return launch_clustered(q8v3_wgmma_kernel<BM, KS, CL, G32>, grid, T8_THREADS, TileShape<BM>::SMEM,
                            ks, st, xm, qm, M, K, sc, mn, y, N);
  q8v3_wgmma_kernel<BM, KS, CL, G32><<<grid, T8_THREADS, TileShape<BM>::SMEM, st>>>(
      xm, qm, M, K, sc, mn, y, N);
  return cudaGetLastError();
}

// a tile width (the least of 16, 32, 64, 128 that holds M; larger M takes
// several 128-wide row tiles) and its K split by `tile_split`
template <int BM, bool G32>
cudaError_t launch_width(const void* x, const uint8_t* qs, const __nv_bfloat16* sc,
                         const __nv_bfloat16* mn, __nv_bfloat16* y, int M, int K, int N,
                         cudaStream_t st) {
  return tile_split<BM>(M, K, N, [&](auto ks_split, auto cl, int ks) {
    return launch_tiles<BM, decltype(ks_split)::value, decltype(cl)::value, G32>(x, qs, sc, mn, y, M,
                                                                                 K, N, ks, st);
  });
}

template <bool G32>
cudaError_t tiles(const void* x, const uint8_t* qs, const __nv_bfloat16* sc, const __nv_bfloat16* mn,
                  __nv_bfloat16* y, int M, int K, int N, cudaStream_t st) {
  if (M <= 16) return launch_width<16, G32>(x, qs, sc, mn, y, M, K, N, st);
  if (M <= 32) return launch_width<32, G32>(x, qs, sc, mn, y, M, K, N, st);
  if (M <= 64) return launch_width<64, G32>(x, qs, sc, mn, y, M, K, N, st);
  return launch_width<128, G32>(x, qs, sc, mn, y, M, K, N, st);
}

template <int G, bool MINS>
cudaError_t gemv(const __nv_bfloat16* x, const uint8_t* qs, const __nv_bfloat16* sc,
                 const __nv_bfloat16* mn, __nv_bfloat16* y, int M, int K, int N, cudaStream_t st) {
  // K slices a row group: each warp streams at least 2 chunks of 128 codes
  const int chunks = K / 128;
  int ks = 1;
  while (ks < GV_WARPS && chunks / (2 * ks) >= 2) ks *= 2;
  const int rows_per_block = (GV_WARPS / ks) * 8;
  dim3 grid((N + rows_per_block - 1) / rows_per_block), block(GV_WARPS * 32);
  q8v3_gemv_kernel<G, MINS><<<grid, block, 0, st>>>(x, M, K, qs, sc, mn, y, N, ks);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, qs [N, K] uint8 planes, scales / mins [N, K/group] bf16
// (mins may be null), y [M, N] bf16; K % 128 == 0, group 16 or 32, every
// pointer 16-byte aligned. M <= 8: the GEMV; above: the wgmma tiles.
extern "C" int nfai_q8v3_matmul(const void* x, const void* qs, const void* scales,
                                const void* mins, void* y, int M, int K, int N, int group,
                                void* stream) {
  if (K % 128 != 0 || (group != 16 && group != 32) || M < 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto q = static_cast<const uint8_t*>(qs);
  auto s = static_cast<const __nv_bfloat16*>(scales);
  auto m = static_cast<const __nv_bfloat16*>(mins);
  auto yb = static_cast<__nv_bfloat16*>(y);
  cudaError_t err;
  if (M > 8)
    err = group == 16 ? tiles<false>(x, q, s, m, yb, M, K, N, st) : tiles<true>(x, q, s, m, yb, M, K, N, st);
  else if (group == 16)
    err = m ? gemv<16, true>(xb, q, s, m, yb, M, K, N, st) : gemv<16, false>(xb, q, s, m, yb, M, K, N, st);
  else
    err = m ? gemv<32, true>(xb, q, s, m, yb, M, K, N, st) : gemv<32, false>(xb, q, s, m, yb, M, K, N, st);
  return static_cast<int>(err);
}
