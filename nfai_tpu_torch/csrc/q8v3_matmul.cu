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
// The decode, with bit operations only (what sets this kernel apart from
// K6, which converts int8 to float): for a lo word w,
// lop3((w << 3), 0x00780078, 0x40004000) is the bf16x2 (2 + lo_a / 8,
// 2 + lo_b / 8) of nibbles 0 and 4; (w >> 1), (w >> 5) and (w >> 9) give
// nibbles 1/5, 2/6 and 3/7. A hi word under the header 0x42004200 gives
// (32 + 2 hi_a, 32 + 2 hi_b). One packed bf16x2 subtract and one add,
// u0 = (hi - 50) + lo, is exact (|u0| <= 16 in steps of 1/8: 8 significant
// bits) and equals v / 8. The JAX kernel's fold is the same.
//
// The products run on tensor cores, mma.sync m16n8k16 (bf16 in, f32 out).
// Lane (g, t) of a warp holds codes 4t..4t+3 of each 16-code half of a
// 32-block: they are logical k slots (2t, 2t+1, 2t+8, 2t+9) of the
// fragment, and x is loaded in the same order (8 bytes at 4t), so each
// product pairs an x value with the weight at the same K. The 16 codes of a
// product lie in one scale group (g = 16: one group; g = 32: the two
// halves of a block): a product's f32 partial is multiplied by its group's
// scale in f32 and added to the sum. Kinds with mins (Q5_K, Q2_K) also
// take the group's x sum from a product against a B fragment of ones and
// subtract m * sum(x) (the JAX kernel's block-sum dot).
//
// What bounds it on an H100: decode (M <= 8) reads a byte a weight plus
// the scales and does 2M flops on it: bytes (4096 x 28672 at M = 8:
// 117 MB + 7.3 MB of scales, 0.037 ms at 3.35 TB/s). Prefill rows are
// bound by operations.
//
// Design. M <= 8: a GEMV, as K11's: a warp owns 8 output rows and a slice
// of K; lane (g, t) loads 16 bytes of each plane of row n0 + g per chunk
// (the streaming hint: read once), decodes 4 words a plane into 16 B
// fragments and runs 8 products against x rows 0..7 (rows 8..15 of A zero).
// A block of 8 warps splits K into ks slices; the slices' sums meet in
// shared memory and one thread adds them in slice order. M > 8: 64 x 128
// output tiles, 8 warps of 32 x 32, a 3-stage cp.async pipeline of x
// tiles (64 x 128), plane tiles (128 rows x 128 bytes, rows padded to 192
// bytes so a quarter warp's 16-byte loads meet no bank twice) and the
// chunk's scales and mins; each warp decodes its rows' words in registers.
// Every output is summed by one warp in K order: no atomics, the same bits
// on every launch. wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t NIB_MASK = 0x00780078u, HDR_LO = 0x40004000u, HDR_HI = 0x42004200u;
constexpr uint32_t BF16X2_50 = 0x42484248u, BF16X2_ONE = 0x3F803F80u;

__device__ __forceinline__ uint32_t lop3_and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;  // (a & b) | c: the LUT of f(0xF0, 0xCC, 0xAA) is 0xEA
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

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

__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int b) {
  return b == 0 ? v.x : (b == 1 ? v.y : (b == 2 ? v.z : v.w));
}

// ---------------------------------------------------------------------------
// M <= 8: the GEMV

constexpr int GV_WARPS = 8, GV_U = 2;  // warps a block; chunks a load batch

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
// M > 8: tiles

constexpr int TM = 64, TN = 128, TK = 128, STAGES = 3, THREADS = 256;
constexpr int LDX = TK + 16;  // bf16 a row of the x tile: 288 bytes, 8 words mod 32
constexpr int LDW = 192;      // bytes a row of the plane tile: 48 words, 16 mod 32
constexpr int LDS_ = 16;      // bytes a row of the chunk's scales (or mins)
constexpr int X_BYTES = TM * LDX * 2, W_BYTES = TN * LDW, S_BYTES = TN * LDS_;
constexpr int STAGE_BYTES = X_BYTES + W_BYTES + 2 * S_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;

__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? bytes : 0;  // 0 source bytes: zero-filled
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_stages() {  // all but the STAGES - 2 newest groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

template <int G, bool MINS>
__device__ __forceinline__ void load_stage(unsigned char* st, const __nv_bfloat16* __restrict__ x,
                                           int M, int K, const uint8_t* __restrict__ qs,
                                           const __nv_bfloat16* __restrict__ sc,
                                           const __nv_bfloat16* __restrict__ mn, int N, int m0,
                                           int n0, int c, int tid) {
  constexpr int GPC = 128 / G;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st);
  unsigned char* ws = st + X_BYTES;
  unsigned char* ss = ws + W_BYTES;
  unsigned char* ms = ss + S_BYTES;
  const int k0 = c * TK;
#pragma unroll
  for (int i = 0; i < TM * (TK / 8) / THREADS; ++i) {  // x: 16 chunks of 16 bytes a row
    const int e = tid + i * THREADS, r = e / (TK / 8), cc = (e % (TK / 8)) * 8;
    const bool ok = m0 + r < M;
    cp_async(xs + r * LDX + cc, ok ? x + (size_t)(m0 + r) * K + k0 + cc : x, ok, 16);
  }
#pragma unroll
  for (int i = 0; i < TN * 8 / THREADS; ++i) {  // planes: 8 chunks of 16 bytes a row
    const int e = tid + i * THREADS, r = e / 8, cc = (e % 8) * 16;
    const bool ok = n0 + r < N;
    cp_async(ws + r * LDW + cc, ok ? qs + (size_t)(n0 + r) * K + k0 + cc : qs, ok, 16);
  }
  const int kg = K / G;
  if (tid < TN) {
    const bool ok = n0 + tid < N;
    cp_async(ss + tid * LDS_, ok ? sc + (size_t)(n0 + tid) * kg + c * GPC : sc, ok, GPC * 2);
  } else if (MINS) {
    const int r = tid - TN;
    const bool ok = n0 + r < N;
    cp_async(ms + r * LDS_, ok ? mn + (size_t)(n0 + r) * kg + c * GPC : mn, ok, GPC * 2);
  }
}

template <int G, bool MINS>
__global__ void __launch_bounds__(THREADS)
q8v3_mma_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ sc,
                const __nv_bfloat16* __restrict__ mn, __nv_bfloat16* __restrict__ y, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int nc = K / TK;

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nc) load_stage<G, MINS>(smem + s * STAGE_BYTES, x, M, K, qs, sc, mn, N, m0, n0, s, tid);
    cp_async_commit();
  }
  for (int kc = 0; kc < nc; ++kc) {
    cp_async_wait_stages();  // chunk kc has landed (this thread's copies)
    __syncthreads();         // ... everyone's, and stage (kc - 1) % STAGES is free
    if (kc + STAGES - 1 < nc)
      load_stage<G, MINS>(smem + ((kc + STAGES - 1) % STAGES) * STAGE_BYTES, x, M, K, qs, sc, mn,
                          N, m0, n0, kc + STAGES - 1, tid);
    cp_async_commit();
    const unsigned char* st = smem + (kc % STAGES) * STAGE_BYTES;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
    const unsigned char* ws = st + X_BYTES;
    const __nv_bfloat16* ss = reinterpret_cast<const __nv_bfloat16*>(ws + W_BYTES);
    const __nv_bfloat16* ms = reinterpret_cast<const __nv_bfloat16*>(ws + W_BYTES + S_BYTES);
    // this lane's plane words of the warp's 4 column tiles (rows wn + 8j + g)
    uint4 wl[4], wh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned char* row = ws + (wn + 8 * j + g) * LDW;
      wl[j] = *reinterpret_cast<const uint4*>(row + 16 * t);
      wh[j] = *reinterpret_cast<const uint4*>(row + 64 + 16 * t);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      uint32_t a[2][2][4];  // [half i][row tile][a0..a3]
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int col = 32 * b + 16 * i + 4 * t;
          const uint2 lo = *reinterpret_cast<const uint2*>(xs + (wm + 16 * mt + g) * LDX + col);
          const uint2 hi = *reinterpret_cast<const uint2*>(xs + (wm + 16 * mt + g + 8) * LDX + col);
          a[i][mt][0] = lo.x;
          a[i][mt][1] = hi.x;
          a[i][mt][2] = lo.y;
          a[i][mt][3] = hi.y;
        }
      float q[2][2][4];  // [i][mt]: x sums of rows g, g + 8 over each half (mins)
      if constexpr (MINS) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) q[i][mt][e] = 0.f;
            mma_16816(q[i][mt], a[i][mt][0], a[i][mt][1], a[i][mt][2], a[i][mt][3], BF16X2_ONE,
                      BF16X2_ONE);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t fr[4];
        decode_block(word_of(wl[j], b), word_of(wh[j], b), fr);
        const int c0 = wn + 8 * j + 2 * t;  // this lane's output columns c0, c0 + 1 in the tile
        float p[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (G == 16 || i == 0) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) p[mt][e] = 0.f;
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_16816(p[mt], a[i][mt][0], a[i][mt][1], a[i][mt][2], a[i][mt][3], fr[2 * i],
                      fr[2 * i + 1]);
          if (G == 16 || i == 1) {  // the group ends: scale its partial in f32
            const int gi = (32 * b + 16 * i) / G;
            const float s0 = __bfloat162float(ss[c0 * (LDS_ / 2) + gi]);
            const float s1 = __bfloat162float(ss[(c0 + 1) * (LDS_ / 2) + gi]);
            float mm0 = 0.f, mm1 = 0.f;
            if constexpr (MINS) {
              mm0 = __bfloat162float(ms[c0 * (LDS_ / 2) + gi]);
              mm1 = __bfloat162float(ms[(c0 + 1) * (LDS_ / 2) + gi]);
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              acc[mt][j][0] = fmaf(s0, p[mt][0], acc[mt][j][0]);
              acc[mt][j][1] = fmaf(s1, p[mt][1], acc[mt][j][1]);
              acc[mt][j][2] = fmaf(s0, p[mt][2], acc[mt][j][2]);
              acc[mt][j][3] = fmaf(s1, p[mt][3], acc[mt][j][3]);
              if constexpr (MINS) {
                // the group's x sums: rows g (c0 = c1) and g + 8 (c2 = c3)
                const float sg = G == 16 ? q[i][mt][0] : q[0][mt][0] + q[1][mt][0];
                const float sg8 = G == 16 ? q[i][mt][2] : q[0][mt][2] + q[1][mt][2];
                acc[mt][j][0] = fmaf(-mm0, sg, acc[mt][j][0]);
                acc[mt][j][1] = fmaf(-mm1, sg, acc[mt][j][1]);
                acc[mt][j][2] = fmaf(-mm0, sg8, acc[mt][j][2]);
                acc[mt][j][3] = fmaf(-mm1, sg8, acc[mt][j][3]);
              }
            }
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // no copy outlives the block
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * mt + g + 8 * h;
        if (m >= M) continue;
        if (n < N) y[(size_t)m * N + n] = __float2bfloat16(acc[mt][j][2 * h]);
        if (n + 1 < N) y[(size_t)m * N + n + 1] = __float2bfloat16(acc[mt][j][2 * h + 1]);
      }
    }
}

template <int G, bool MINS>
cudaError_t launch(const __nv_bfloat16* x, const uint8_t* qs, const __nv_bfloat16* sc,
                   const __nv_bfloat16* mn, __nv_bfloat16* y, int M, int K, int N,
                   cudaStream_t st) {
  if (M <= 8) {
    // K slices a row group: each warp streams at least 2 chunks of 128 codes
    const int chunks = K / 128;
    int ks = 1;
    while (ks < GV_WARPS && chunks / (2 * ks) >= 2) ks *= 2;
    const int rows_per_block = (GV_WARPS / ks) * 8;
    dim3 grid((N + rows_per_block - 1) / rows_per_block), block(GV_WARPS * 32);
    q8v3_gemv_kernel<G, MINS><<<grid, block, 0, st>>>(x, M, K, qs, sc, mn, y, N, ks);
  } else {
    static bool sized = false;  // one per instantiation: above 48 KB needs the opt-in
    if (!sized) {
      const cudaError_t err = cudaFuncSetAttribute(
          q8v3_mma_kernel<G, MINS>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (err != cudaSuccess) return err;
      sized = true;
    }
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM), block(THREADS);
    q8v3_mma_kernel<G, MINS><<<grid, block, SMEM_BYTES, st>>>(x, M, K, qs, sc, mn, y, N);
  }
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, qs [N, K] uint8 planes, scales / mins [N, K/group] bf16
// (mins may be null), y [M, N] bf16; K % 128 == 0, group 16 or 32, every
// pointer 16-byte aligned.
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
  if (group == 16)
    err = m ? launch<16, true>(xb, q, s, m, yb, M, K, N, st)
            : launch<16, false>(xb, q, s, m, yb, M, K, N, st);
  else
    err = m ? launch<32, true>(xb, q, s, m, yb, M, K, N, st)
            : launch<32, false>(xb, q, s, m, yb, M, K, N, st);
  return static_cast<int>(err);
}
