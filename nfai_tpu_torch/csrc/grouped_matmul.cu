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
// A stack is contiguous, so expert e's rows are rows e*N .. e*N + N - 1 of
// the 2-D [E*N, .] view: the expert is a row offset, nothing more.
//
// Replaces nfai_tpu/ops/qmatmul.py::_grouped_call via _qmatmul_grouped_q4
// (_q4g_kernel, K8) and _qmatmul_grouped_q8 (_q8g_kernel, K9). The TPU
// kernels walk the row blocks on a sequential grid and prefetch
// block_group as scalars into the weight BlockSpecs, so a run of blocks of
// one expert keeps its weight tiles in VMEM. Here blocks run in parallel in
// no order: each block loads its own group id and its own tiles, and
// nothing carries over between blocks. block_rows[i] (the real rows of
// block i, the rest being padding) decides everything a block does: a
// block with none (the empty blocks past the last expert's padded rows,
// their group clipped to expert E-1 as in the JAX layout) writes zeros and
// reads no weight, and rows at or past it are written as zeros whatever x
// holds there. The launch plan uses only what the host knows (M, tm, K, N,
// the SM count); nothing is read back, nothing is cleared before a launch.
//
// What bounds it on an H100: decode (tm = 8, one or two real rows per block)
// streams each hit expert's weights once per row block: 0.75 B/weight for
// K8, 1 B + 4/g (8/g with mins) for K9, so HBM bytes bound it (batch 1 of a
// Qwen3-30B-A3B layer: 8 experts x 3 matrices x 768 x 2048 weights). Prefill
// (tm = 32 or 128) does 2 * rows * K * N flops against one read of the hit
// experts: a 256-token chunk (2048 rows, every expert hit) is still bound by
// bytes there; operations take over from about 14k rows (1.7k tokens).
//
// tm = 8 (`grouped_gemv_kernel`): K1's and K6's tensor-core GEMV fed by the
// row block's expert. A block of 8 warps takes 128 / ks weight rows of one
// row block's expert (16 a warp) over ks slices of K (the slices meet in
// shared memory, added in slice order). mma.sync m16n8k16 with the weight
// as A and the block's 8 x rows as B (the mma's n8): lane (g, t) holds word
// t of a 16-byte code block of rows g and g + 8 (ldmatrix from the warp's
// ring), decoded in K1's permuted K order: K8's nibbles to 128 + q by one
// lop3 a pair (the 128 x sum goes into the min), K9's bytes to q by K6's two
// lop3 and a packed subtract. Each block's (K9: scale group's) product starts
// on a zero accumulator operand and is folded into the row's sum in f32 by
// its scale, less (min + 128 scale) x the group's x sum: W enters as s q - m.
// Each warp streams its 16 rows' codes, scales and mins through its own ring
// by cp.async (128 code bytes a row a stage, 2 stages for K8 and 3 for K9),
// with no block-wide barrier. The block's x rows are staged once (in chunks
// of 2048 codes) as B fragments in shared memory beside each scale group's x
// sums, rows past block_rows zero. Rows per warp carry the parallelism, so
// every lane works at K = 768 too. The K split: the fewest slices that give
// every SM a block (blocks x column tiles; each slice at least 256 codes),
// then, while slices keep 1024 codes, more until the grid fills three waves
// (the host counts every row block, the empty ones too): at batch 1 of a
// Qwen3-30B-A3B gate (8 blocks x 6 tiles) four, at batch 8 (64 x 6) two, on
// its down (K = 768) none. Two blocks an SM (at most 82 KB of shared memory
// for K8, 108 KB for K9; 128 registers). What holds it: the weight stream and
// the products overlap only in part (tests/torch_grouped_probe.py, PERF.md).
//
// tm % 32 == 0 (`grouped_wgmma_kernel`): K1's (K8) and K6's (K9) wgmma
// tiles over y^T = W x^T, so a row block's x is wgmma's N width: 32 at
// tm = 32, 128 at tm = 128 (any other multiple of 32 takes 32-wide tiles),
// and every tile lies in one block, hence one expert. 128 weight rows a
// block (two consumer warpgroups of 64) and one producer warp whose lane 0
// brings, per 128-code stage, x (two 64-code boxes at row m0 under the
// 128-byte swizzle), the codes (row e*N + n0 of the [E*N, .] view), the
// scales and the mins by TMA into a ring of 4-6 stages under mbarriers
// (the scales by the warp's cp.async where their rows are not 16-byte
// strided, K % 128 != 0 for K8). Consumers decode A in registers straight
// into the wgmma fragment as bf16(s q - m) (K1's nibble decode, K6's int8
// one) and run the RS form m64nBMk16. At tm = 128 most blocks are about
// half padding (8192 rows over 128 experts: 64 a block on average), so a
// block with at most 64 real rows brings 64 rows of x and runs the 64-wide
// product (one branch on block_rows; 5-6% faster at 8 x 128 tokens than the
// 128-wide product everywhere, PERF.md). Where the grid the host sees (every
// row block) is short, K1's two-group K split takes over: both groups own
// 64 rows and take alternate stages, added in order; it is also taken where
// N % 128 != 0, so that no TMA box runs past an expert's rows (the host
// does not know E, so the maps reach as far as TMA allows). The epilogue
// (K6's, through shared memory into rows of y) writes rows at or past
// block_rows as zeros. Every output is summed in a fixed order: the same
// bits on every launch.
#include "sm90.cuh"

namespace {

__device__ __forceinline__ int real_rows(const int* block_rows, int blk, int tm) {
  const int r = __ldg(block_rows + blk);
  return r < 0 ? 0 : (r > tm ? tm : r);
}

// ---------------------------------------------------------------------------
// tm = 8: tensor-core GEMVs over each row block's expert

constexpr uint32_t NIB_MASK = 0x000F000Fu, HDR_128 = 0x43004300u;  // bf16x2 (128, 128)
constexpr uint32_t LOW7 = 0x007F007Fu, SIGN = 0x00800080u;

// the nibbles at bits 0-3 and 16-19 of w → the bf16x2 of 128 + each code,
// exact: 0x4300 | q is 128 + q (the 128 x sum goes into the min)
__device__ __forceinline__ uint32_t nib128x2(uint32_t w) { return lop3_and_or(w, NIB_MASK, HDR_128); }

// the int8 codes at bits 0-7 and 16-23 of w → their bf16x2, exactly (K6's decode)
__device__ __forceinline__ uint32_t i8x2(uint32_t w) {
  return bf16x2_sub(lop3_and_or(w, LOW7, HDR_128), lop3_and_or(w, SIGN, HDR_128));
}

// d = A B on a zero accumulator (one zero register for C, no per-product reset)
__device__ __forceinline__ void mma_16816_z(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
}

constexpr int GV_TM = 8;                      // rows of a decode block: the mma's n8
constexpr int GV_THREADS = GV_WARPS * 32;     // 8 warps, 16 weight rows each
constexpr int GV_SB = 128;                    // code bytes a weight row a stage (8 blocks of 16)
constexpr int GV_ST_S = 16 * GV_SB;           // scales [16 rows][8] f32
constexpr int GV_ST_M = GV_ST_S + 16 * 32;    // mins, the same
constexpr int GV_STAGE = GV_ST_M + 16 * 32;   // 3 KB
constexpr int GV_CHUNK = 2048;                // codes of x a chunk of B fragments (32 KB)

// A code layout: a 16-byte code block holds CPB codes (32 nibbles, or 16
// bytes), BPS blocks share a scale, a lane's B fragment of a block is FRAG
// bytes, a chunk of x is CB blocks (CS stages); each warp's ring holds S
// stages (K8 2, K9 3: measured)
template <bool Q4, bool G32>
struct GvLayout {
  static constexpr int CPB = Q4 ? 32 : 16;
  static constexpr int BPS = (!Q4 && G32) ? 2 : 1;
  static constexpr int FRAG = Q4 ? 16 : 8;
  static constexpr int CB = GV_CHUNK / CPB, CS = CB / 8;
  static constexpr int S = Q4 ? 2 : 3, RING = GV_WARPS * S * GV_STAGE;
};

// dynamic shared memory of a decode block: the warps' rings, then a chunk's
// B fragments [blocks][32 lanes] and x sums [scale groups][8 rows] (at most
// 82 KB for K8, 108 KB for K9: two blocks an SM)
template <bool Q4, bool G32>
int gv_smem(int K) {
  using L = GvLayout<Q4, G32>;
  const int blocks = (K / L::CPB + 7) / 8 * 8, fb = blocks < L::CB ? blocks : L::CB;
  return L::RING + fb * 32 * L::FRAG + fb / L::BPS * GV_TM * 4;
}

// Grid (ceil(N / (128 / ks)), M / 8): block (c, i) takes rows c * 128 / ks ..
// of row block i's expert; warp w rows 16 (w / ks) .. over slice w % ks of
// each chunk's stages. `vec`: scale rows 16-byte strided and aligned.
template <bool Q4, bool G32, bool MINS>
__global__ void __launch_bounds__(GV_THREADS, 2)
grouped_gemv_kernel(const __nv_bfloat16* __restrict__ x, int K, const uint8_t* __restrict__ qs,
                    const float* __restrict__ sc, const float* __restrict__ mn,
                    const int* __restrict__ block_group, const int* __restrict__ block_rows,
                    __nv_bfloat16* __restrict__ y, int N, int ks, bool vec) {
  using L = GvLayout<Q4, G32>;
  extern __shared__ __align__(16) unsigned char gsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int blk = blockIdx.y, rpb = (GV_WARPS / ks) * 16, n_base = blockIdx.x * rpb;
  const int rows = real_rows(block_rows, blk, GV_TM);
  __nv_bfloat16* yb = y + (size_t)blk * GV_TM * N;
  if (rows == 0) {  // an empty block: zeros, no weight read
    for (int e = tid; e < GV_TM * rpb; e += GV_THREADS) {
      const int n = n_base + e % rpb;
      if (n < N) yb[(size_t)(e / rpb) * N + n] = __float2bfloat16(0.f);
    }
    return;
  }
  const size_t erow = (size_t)__ldg(block_group + blk) * N;  // the expert's row 0
  const int slice = warp % ks, nrow0 = n_base + (warp / ks) * 16;
  const int row_bytes = Q4 ? K / 2 : K, nblk = row_bytes / 16, ng = nblk / L::BPS;
  // stages of 8 blocks: a row's, a chunk's; this warp's share of each chunk
  const int n_st = (nblk + 7) / 8, n_ch = (n_st + L::CS - 1) / L::CS, cs_last = n_st - (n_ch - 1) * L::CS;
  const int lo_full = slice * L::CS / ks, per_full = (slice + 1) * L::CS / ks - lo_full;
  const int lo_last = slice * cs_last / ks, per_last = (slice + 1) * cs_last / ks - lo_last;
  const int mine = (n_ch - 1) * per_full + per_last;
  auto stage_of = [&](int i) {  // the stage of this warp's i-th
    const int c = per_full > 0 ? i / per_full : n_ch - 1;
    return c < n_ch - 1 ? c * L::CS + lo_full + i % per_full
                        : (n_ch - 1) * L::CS + lo_last + (i - (n_ch - 1) * per_full);
  };
  unsigned char* ring = gsm + warp * L::S * GV_STAGE;
  unsigned char* xfr = gsm + L::RING;  // a chunk's B fragments
  const int fr_blocks = (n_st < L::CS ? n_st : L::CS) * 8;
  float* xsum = reinterpret_cast<float*>(xfr + fr_blocks * 32 * L::FRAG);  // [groups][8 rows]
  // row r of this warp's 16 in the stack (rows past N: read, discarded)
  auto row = [&](int r) { return erow + min(nrow0 + r, N - 1); };

  // a lane's copies of a stage: 16-byte chunk cq of code rows rq + 4k
  // (stored at chunk cq ^ (row & 7): ldmatrix's eight rows of a chunk fall
  // in eight bank groups); the scales and mins of 16 rows
  const int rq = lane >> 3, cq = lane & 7;
  constexpr int SPS = 8 / L::BPS;  // scales a row a stage
  auto issue = [&](int i) {  // this warp's i-th stage into its ring
    if (i >= mine) return;
    const int s = stage_of(i);
    unsigned char* st = ring + (i % L::S) * GV_STAGE;
    const bool ok = 8 * s + cq < nblk;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = rq + 4 * k;
      cp_async16_zfill(st + r * GV_SB + 16 * (cq ^ (r & 7)),
                       qs + row(r) * row_bytes + (ok ? GV_SB * (size_t)s + 16 * cq : 0), ok);
    }
    if (vec) {  // 16 rows x SPS / 4 chunks of 16 bytes
      if (lane < 4 * SPS) {
        const int r = lane / (SPS / 4), c = lane % (SPS / 4), gi = SPS * s + 4 * c;
        const bool in = gi < ng;
        cp_async16_zfill(st + GV_ST_S + 32 * r + 16 * c, sc + row(r) * ng + (in ? gi : 0), in);
        if (MINS) cp_async16_zfill(st + GV_ST_M + 32 * r + 16 * c, mn + row(r) * ng + (in ? gi : 0), in);
      }
    } else {
#pragma unroll
      for (int h = 0; h < SPS / 2; ++h) {  // 16 rows x SPS entries of 4 bytes
        const int e = lane + 32 * h, r = e / SPS, j = e % SPS, gi = SPS * s + j;
        const bool in = gi < ng;
        cp_async4(st + GV_ST_S + 32 * r + 4 * j, sc + row(r) * ng + (in ? gi : 0), in);
        if (MINS) cp_async4(st + GV_ST_M + 32 * r + 4 * j, mn + row(r) * ng + (in ? gi : 0), in);
      }
    }
  };
  for (int i = 0; i < L::S - 1; ++i) {  // the ring's first stages, in flight while x is staged
    issue(i);
    cp_async_commit();
  }

  // ldmatrix: lanes 8j..8j+7 give the rows of matrix j = (rows 0-7 | 8-15) x
  // (chunk 2p | 2p + 1); lane (g, t) receives word t of row g of each
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = lane >> 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int i = 0;  // this warp's stages consumed
  for (int c = 0; c < n_ch; ++c) {
    __syncthreads();  // every warp is done with the previous chunk
    // x's B fragments of the chunk: lane (m, tt) of block b holds codes
    // 4tt..4tt+3 of row m (K8: of both halves of a 32-block) in the slots'
    // order; rows past `rows` zero
    for (int e = tid; e < fr_blocks * 32; e += GV_THREADS) {
      const int b = e >> 5, m = (e & 31) >> 2, gb = c * L::CB + b;
      const __nv_bfloat16* xb = x + ((size_t)blk * GV_TM + m) * K + (size_t)gb * L::CPB + 4 * (e & 3);
      const bool live = m < rows && gb < nblk;
      const uint2 u = live ? __ldg(reinterpret_cast<const uint2*>(xb)) : make_uint2(0, 0);
      if constexpr (Q4) {
        const uint2 v = live ? __ldg(reinterpret_cast<const uint2*>(xb + 16)) : make_uint2(0, 0);
        reinterpret_cast<uint4*>(xfr)[e] = make_uint4(prmt(u.x, u.y, 0x5410), prmt(u.x, u.y, 0x7632),
                                                      prmt(v.x, v.y, 0x5410), prmt(v.x, v.y, 0x7632));
      } else {
        reinterpret_cast<uint2*>(xfr)[e] = make_uint2(prmt(u.x, u.y, 0x5410), prmt(u.x, u.y, 0x7632));
      }
    }
    if (MINS) {  // each scale group's x sum, in order, rows past `rows` zero
      for (int e = tid; e < fr_blocks / L::BPS * GV_TM; e += GV_THREADS) {
        const int m = e & 7, k0 = (c * L::CB / L::BPS + (e >> 3)) * L::CPB * L::BPS;
        float sum = 0.f;
        if (m < rows && k0 < K) {
          const uint4* xr = reinterpret_cast<const uint4*>(x + ((size_t)blk * GV_TM + m) * K + k0);
#pragma unroll
          for (int v = 0; v < L::CPB * L::BPS / 8; ++v) {
            float f[8];
            bf16x8(__ldg(xr + v), f);
#pragma unroll
            for (int k = 0; k < 8; ++k) sum += f[k];
          }
        }
        xsum[e] = sum;
      }
    }
    __syncthreads();
    const int lo = c < n_ch - 1 ? lo_full : lo_last, hi = lo + (c < n_ch - 1 ? per_full : per_last);
    for (int j = lo; j < hi; ++j, ++i) {
      issue(i + L::S - 1);
      cp_async_commit();
      cp_async_wait<L::S - 1>();
      __syncwarp();
      const unsigned char* st = ring + (i % L::S) * GV_STAGE;
      const float4* s4 = reinterpret_cast<const float4*>(st + GV_ST_S);  // [16 rows][2]
      const float4* m4 = reinterpret_cast<const float4*>(st + GV_ST_M);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // blocks 4 hf .. 4 hf + 3
        const int fi = hf / L::BPS;  // the float4 of their scales
        const float4 s0 = s4[2 * g + fi], s1 = s4[2 * (g + 8) + fi];
        float4 n0 = make_float4(0.f, 0.f, 0.f, 0.f), n1 = n0;
        if (MINS) {
          n0 = m4[2 * g + fi];
          n1 = m4[2 * (g + 8) + fi];
        }
        float p[4];
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          uint32_t w[4];  // word t of: row g block 2pr, row g + 8 block 2pr, the same of block 2pr + 1
          const int ch = 4 * hf + 2 * pp + lc;
          ldmatrix_x4(w, st + lr * GV_SB + 16 * (ch ^ (lr & 7)));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int b = 4 * hf + 2 * pp + h, lb = 8 * j + b;  // the block in the stage, in the chunk
            const uint32_t w0 = w[2 * h], w1 = w[2 * h + 1];
            if constexpr (Q4) {
              // half 0 (low nibbles): slots 2t, 2t+1 <- codes 4t, 4t+2; 2t+8,
              // 2t+9 <- 4t+1, 4t+3; half 1 (high nibbles) the same slots
              const uint4 xv = reinterpret_cast<const uint4*>(xfr)[lb * 32 + lane];
              mma_16816_z(p, nib128x2(w0), nib128x2(w1), nib128x2(w0 >> 8), nib128x2(w1 >> 8), xv.x, xv.y);
              mma_16816(p, nib128x2(w0 >> 4), nib128x2(w1 >> 4), nib128x2(w0 >> 12), nib128x2(w1 >> 12),
                        xv.z, xv.w);
            } else {
              const uint2 xv = reinterpret_cast<const uint2*>(xfr)[lb * 32 + lane];
              if (b % L::BPS == 0)
                mma_16816_z(p, i8x2(w0), i8x2(w1), i8x2(w0 >> 8), i8x2(w1 >> 8), xv.x, xv.y);
              else
                mma_16816(p, i8x2(w0), i8x2(w1), i8x2(w0 >> 8), i8x2(w1 >> 8), xv.x, xv.y);
            }
            if (b % L::BPS == L::BPS - 1) {  // a scale group's partial, scaled; its min * x sum off
              const int si = (b / L::BPS) % 4;
              const float sg = comp(s0, si), sh = comp(s1, si);
              acc[0] = fmaf(sg, p[0], acc[0]);
              acc[1] = fmaf(sg, p[1], acc[1]);
              acc[2] = fmaf(sh, p[2], acc[2]);
              acc[3] = fmaf(sh, p[3], acc[3]);
              if (MINS) {
                const float2 xs = *reinterpret_cast<const float2*>(xsum + (lb / L::BPS) * GV_TM + 2 * t);
                const float c4 = Q4 ? 128.f : 0.f;  // K8's A is 128 + q
                const float mg = comp(n0, si) + c4 * sg, mh = comp(n1, si) + c4 * sh;
                acc[0] = fmaf(-mg, xs.x, acc[0]);
                acc[1] = fmaf(-mg, xs.y, acc[1]);
                acc[2] = fmaf(-mh, xs.x, acc[2]);
                acc[3] = fmaf(-mh, xs.y, acc[3]);
              }
            }
          }
        }
      }
      __syncwarp();  // every lane is done with the slot before it is refilled
    }
  }
  // the slices' sums meet in shared memory (the rings are spent: no copy is
  // in flight) and are added in slice order. C fragment: acc[0..1] row g
  // (x rows m = 2t, 2t + 1), acc[2..3] row g + 8
  __syncthreads();
  float* part = reinterpret_cast<float*>(gsm);  // [warp][16][8]
  part[(warp * 16 + g) * 8 + 2 * t] = acc[0];
  part[(warp * 16 + g) * 8 + 2 * t + 1] = acc[1];
  part[(warp * 16 + g + 8) * 8 + 2 * t] = acc[2];
  part[(warp * 16 + g + 8) * 8 + 2 * t + 1] = acc[3];
  __syncthreads();
  for (int e = tid; e < GV_TM * rpb; e += GV_THREADS) {
    const int m = e / rpb, rl = e % rpb, n = n_base + rl;
    if (n >= N) continue;
    float sum = 0.f;
    if (m < rows)
      for (int k = 0; k < ks; ++k) sum += part[(((rl >> 4) * ks + k) * 16 + (rl & 15)) * 8 + m];
    yb[(size_t)m * N + n] = __float2bfloat16(sum);
  }
}

// K slices a decode block: the fewest that give every SM a block, counting
// every row block (the host cannot see which are empty) times the column
// tiles, each slice at least 256 codes; where slices keep 1024 codes, more
// until the grid fills GV_WAVES waves of one block an SM
constexpr int GV_WAVES = 3;
int gv_ks(int blocks, int K, int N, int sms) {
  const auto ctas = [&](int ks) {
    const int rpb = (GV_WARPS / ks) * 16;
    return blocks * ((N + rpb - 1) / rpb);
  };
  int ks = 1;
  while (ks < GV_WARPS && K / (2 * ks) >= 256 &&
         (ctas(ks) < sms || (ctas(ks) < GV_WAVES * sms && K / (2 * ks) >= 1024)))
    ks *= 2;
  return ks;
}

template <bool Q4, bool G32, bool MINS>
cudaError_t gemv_launch(const __nv_bfloat16* x, const uint8_t* qs, const float* sc, const float* mn,
                        const int* bg, const int* br, __nv_bfloat16* y, int M, int K, int N,
                        cudaStream_t st) {
  static bool sized = false;  // above 48 KB of shared memory needs the opt-in
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(grouped_gemv_kernel<Q4, G32, MINS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 gv_smem<Q4, G32>(1 << 20));
    if (err != cudaSuccess) return err;
    sized = true;
  }
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int blocks = M / GV_TM, ks = gv_ks(blocks, K, N, sms), rpb = (GV_WARPS / ks) * 16;
  const int ng = (Q4 ? K / 32 : K / 16) / GvLayout<Q4, G32>::BPS;
  const auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = ng % 4 == 0 && aligned(sc) && (!MINS || aligned(mn));
  const dim3 grid((N + rpb - 1) / rpb, blocks);
  grouped_gemv_kernel<Q4, G32, MINS><<<grid, GV_THREADS, gv_smem<Q4, G32>(K), st>>>(
      x, K, qs, sc, mn, bg, br, y, N, ks, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tm % 32 == 0: wgmma tiles, y^T = W x^T inside one row block

constexpr int GT_TK = 128;               // codes a stage
constexpr int GT_THREADS = T8_THREADS;   // two consumer warpgroups, one producer warp
constexpr uint32_t FLIP = 0x80808080u;   // the sign bit of each byte (K6's decode)

template <int W>
using Width = std::integral_constant<int, W>;

// A stage: x as two 64-code tiles of BM rows (128-byte swizzle, wgmma's B),
// the codes of 128 weight rows (K8: 64 bytes a row, K9: 128 under the
// 128-byte swizzle), their scales and mins (K8: 4 f32 a row, K9: up to 8)
template <bool Q4, int BM>
struct GtShape {
  static constexpr int X_BYTES = BM * 128;
  static constexpr int W_OFF = 2 * X_BYTES;
  static constexpr int W_ROW = Q4 ? 64 : 128;
  static constexpr int S_OFF = W_OFF + T8_ROWS * W_ROW;
  static constexpr int S_ROW = Q4 ? 16 : 32;
  static constexpr int M_OFF = S_OFF + T8_ROWS * S_ROW;
  static constexpr int STAGE = M_OFF + T8_ROWS * S_ROW;  // a multiple of 1024
  static constexpr int STAGES = (232448 - 2048) / STAGE < 6 ? (232448 - 2048) / STAGE : 6;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
};

// byte i of w (sign-flipped, u = q + 128) as the f32 1 + u 2^-15: bytes
// (0x00, u, 0x80, 0x3F)
__device__ __forceinline__ float u_f32(uint32_t w, uint32_t sel) {
  return __uint_as_float(prmt(w, 0x3F800000u, sel));
}

// Block (weight tile, x tile): 128 weight rows of the row block's expert (64
// with KS) times BM rows of x, every one of them in row block m0 / tm. A
// tile with no real row writes zeros and reads no weight; a 128-wide tile
// whose block has at most 64 real rows brings 64 rows of x and runs the
// 64-wide product. The epilogue writes rows at or past block_rows as zeros.
template <bool Q4, int BM, bool KS>
__global__ void __launch_bounds__(GT_THREADS, 1)
grouped_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap xmap64,
                     const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap smap,
                     const __grid_constant__ CUtensorMap mmap, int K, const float* __restrict__ sc,
                     const float* __restrict__ mn, const int* __restrict__ block_group,
                     const int* __restrict__ block_rows, __nv_bfloat16* __restrict__ y, int N, int tm,
                     int gshift, bool scales_by_tma) {
  using S = GtShape<Q4, BM>;
  constexpr int STAGES = S::STAGES;
  constexpr int RB = KS ? 64 : T8_ROWS;  // weight rows a block
  extern __shared__ unsigned char tsm_raw[];
  unsigned char* tsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tsm_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * RB, m0 = blockIdx.y * BM, blk = m0 / tm;
  int rows = real_rows(block_rows, blk, tm) - (m0 - blk * tm);
  rows = rows < 0 ? 0 : (rows > BM ? BM : rows);
  if (rows == 0) {  // padding or an empty block: zeros, no weight read
    for (int e = tid; e < BM * (RB / 8); e += GT_THREADS)
      *reinterpret_cast<uint4*>(y + (size_t)(m0 + e / (RB / 8)) * N + n0 + 8 * (e % (RB / 8))) =
          make_uint4(0, 0, 0, 0);
    return;
  }
  const int erow = __ldg(block_group + blk) * N + n0;  // the tile's first row in the [E*N, .] maps
  const bool narrow = BM == 128 && rows <= 64;
  const int spg = Q4 ? 4 : GT_TK >> gshift, ng = Q4 ? K >> 5 : K >> gshift;  // scales a row: a stage's, all
  const int kt_n = (K + GT_TK - 1) / GT_TK;
  const bool mins = mn != nullptr;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], scales_by_tma ? 1 : 1 + 32);  // expect_tx (+ the lanes' copies)
      mbar_init(&empty[s], KS ? 1 : 2);  // one thread of each group that reads the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp: every operand by TMA from lane 0
    const int x_bytes = narrow ? 64 * 128 : S::X_BYTES;
    const int sbytes = RB * spg * 4 * (mins ? 2 : 1);
    const int tx = 2 * x_bytes + RB * S::W_ROW + (scales_by_tma ? sbytes : 0);
    const CUtensorMap* xm = narrow ? &xmap64 : &xmap;
    for (int kt = 0; kt < kt_n; ++kt) {
      const int s = kt % STAGES;
      if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
      unsigned char* st = tsm + s * S::STAGE;
      if (lane == 0) {
        mbar_expect_tx(&full[s], tx);
        tma_load_2d(st, xm, kt * GT_TK, m0, &full[s]);
        tma_load_2d(st + S::X_BYTES, xm, kt * GT_TK + 64, m0, &full[s]);
        tma_load_2d(st + S::W_OFF, &qmap, kt * S::W_ROW, erow, &full[s]);
        if (scales_by_tma) {
          tma_load_2d(st + S::S_OFF, &smap, kt * spg, erow, &full[s]);
          if (mins) tma_load_2d(st + S::M_OFF, &mmap, kt * spg, erow, &full[s]);
        }
      }
      if (!scales_by_tma) {  // scale rows not 16-byte strided or aligned: 4-byte copies
        const int per = RB * spg;
        for (int e = lane; e < per * (mins ? 2 : 1); e += 32) {
          const int which = e >= per, f = e - which * per, r = f / spg, j = f % spg, gi = kt * spg + j;
          const bool ok = gi < ng;
          const float* src = (which ? mn : sc) + (ok ? (size_t)(erow + r) * ng + gi : 0);
          cp_async4(st + (which ? S::M_OFF : S::S_OFF) + (r * spg + j) * 4, src, ok);
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
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  // A stage is two halves of four k16 products. A half's A fragment lives in
  // registers that its products read while they run, so a group waits for
  // them before it decodes the next half; the other group's products keep
  // the tensor cores busy meanwhile. K8: K1's decode (lane t keeps bytes 2t,
  // 2t+1, 2t+8, 2t+9 of a 32-block: bf16(s (128 + q) - (m + 128 s)));
  // K9: K6's (the sign-flipped byte u = q + 128 in an f32 1 + u 2^-15, one fma
  // by 2^15 s plus -(32896 s + m)); both one rounding of s q - m to bf16.
  const int gs = gshift - 4;  // K9: a scale group is 1 << gs k16 steps
  const uint32_t sel0 = 0x7604u | ((2u * (t & 1)) << 4), sel1 = sel0 + 0x10u;
  const int wofs = 4 * (t >> 1);
  auto half = [&](const unsigned char* st, int hb, const float4 (&q)[4], auto width) {
    constexpr int W = decltype(width)::value;
    uint32_t a[4][4];  // k16 step j of the half
    if constexpr (Q4) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {  // k16 steps 2 jj + h: block 2 hb + jj, half h
        const int jb = 2 * hb + jj;
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
    } else {
      const float* s_r0 = reinterpret_cast<const float*>(st + S::S_OFF) + r0 * spg;
      const float* m_r0 = reinterpret_cast<const float*>(st + S::M_OFF) + r0 * spg;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * hb + jj, si = j >> gs;
        const float s0 = s_r0[si], s1 = s_r0[8 * spg + si];
        const float mm0 = mins ? m_r0[si] : 0.f, mm1 = mins ? m_r0[8 * spg + si] : 0.f;
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
    }
    uint64_t desc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      desc[j] = sw128_desc(st + hb * S::X_BYTES + 32 * j);
      pin(a[j], desc[j]);  // operands final before the fence: nothing sinks between products
    }
    float(&accw)[W / 2] = reinterpret_cast<float(&)[W / 2]>(acc);  // the first W / 8 x rows
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs<W>(accw, a[j], desc[j]);
    wgmma_commit();
    wgmma_wait<0>();
  };
  auto mainloop = [&](auto width) {
    for (int kt = KS ? wg : 0; kt < kt_n; kt += KS ? 2 : 1) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const unsigned char* st = tsm + s * S::STAGE;
      float4 q[4];  // K8: the stage's four scales and mins of rows r0 and r0 + 8
      if constexpr (Q4) {
        q[0] = *reinterpret_cast<const float4*>(st + S::S_OFF + r0 * 16);
        q[1] = *reinterpret_cast<const float4*>(st + S::S_OFF + (r0 + 8) * 16);
        q[2] = *reinterpret_cast<const float4*>(st + S::M_OFF + r0 * 16);
        q[3] = *reinterpret_cast<const float4*>(st + S::M_OFF + (r0 + 8) * 16);
      }
      half(st, 0, q, width);
      half(st, 1, q, width);
      // the group's products of this stage have completed, after every warp
      // of the group had read it: the stage is free
      if ((warp & 3) == 0 && lane == 0) mbar_arrive(&empty[s]);
    }
  };
  if (narrow)
    mainloop(Width<64>{});
  else
    mainloop(Width<BM>{});
  fence_regs(acc);
  tile_epilogue<BM, KS, false>(acc, tsm, r0, n0, m0, m0 + rows, N, y);
  for (int e = tid; e < (BM - rows) * (RB / 8); e += 256) {  // the padding rows: zeros
    const int m = rows + e / (RB / 8), c = 8 * (e % (RB / 8));
    *reinterpret_cast<uint4*>(y + (size_t)(m0 + m) * N + n0 + c) = make_uint4(0, 0, 0, 0);
  }
}

// the rows of a [E*N, cols] map over an expert stack: the host does not
// know E, so the map reaches as far as TMA's coordinates and strides allow;
// every box the kernel asks for lies inside one expert (RB divides N)
uint64_t stack_rows(uint64_t row_bytes) {
  const uint64_t by_stride = ((uint64_t(1) << 40) - 1) / row_bytes;
  return by_stride < 0x7FFFFFFFull ? by_stride : 0x7FFFFFFFull;
}

template <bool Q4, int BM, bool KS>
cudaError_t tiles_launch(const void* x, const void* qs, const float* sc, const float* mn,
                         const int* bg, const int* br, __nv_bfloat16* y, int M, int K, int N, int tm,
                         int gshift, cudaStream_t st) {
  using S = GtShape<Q4, BM>;
  static bool sized = false;  // one per instantiation: above 48 KB needs the opt-in
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(grouped_wgmma_kernel<Q4, BM, KS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  constexpr int RB = KS ? 64 : T8_ROWS;
  const int ng = Q4 ? K / 32 : K >> gshift, spg = Q4 ? 4 : GT_TK >> gshift;
  const auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  // TMA strides and addresses are multiples of 16 bytes
  const bool scales_by_tma = ng % 4 == 0 && aligned(sc) && (!mn || aligned(mn));
  const uint64_t row_bytes = Q4 ? K / 2 : K;
  const uint64_t qdims[2] = {row_bytes, stack_rows(row_bytes)};
  const uint32_t qbox[2] = {static_cast<uint32_t>(S::W_ROW), RB};
  const uint64_t sdims[2] = {static_cast<uint64_t>(ng), stack_rows(4ull * ng)};
  const uint32_t sbox[2] = {static_cast<uint32_t>(spg), RB};
  CUtensorMap xm, xm64, qm, sm, mm;
  cudaError_t err = tensor_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, 64, BM,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = BM == 128 ? tensor_map(&xm64, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, 64, 64,
                                 CU_TENSOR_MAP_SWIZZLE_128B)
                    : cudaSuccess;
  if (err == cudaSuccess)
    err = tensor_map_nd(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qs, 2, qdims, qbox,
                        Q4 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess && scales_by_tma)
    err = tensor_map_nd(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sc, 2, sdims, sbox,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess && scales_by_tma && mn)
    err = tensor_map_nd(&mm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, mn, 2, sdims, sbox,
                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  if (BM != 128) xm64 = xm;  // unused
  if (!scales_by_tma) sm = qm;  // unused
  if (!scales_by_tma || !mn) mm = sm;  // unused
  const dim3 grid(N / RB, M / BM);
  grouped_wgmma_kernel<Q4, BM, KS><<<grid, GT_THREADS, S::SMEM, st>>>(
      xm, xm64, qm, sm, mm, K, sc, mn, bg, br, y, N, tm, gshift, scales_by_tma);
  return cudaGetLastError();
}

// The tiles: 128 wide where tm % 128 == 0 (64 wide on a block of at most 64
// real rows), else 32; the K split by `tiles_k_split` on the grid the host
// sees (every row block, empty or not), and wherever N % 128 != 0, so that
// no box runs past an expert's rows
template <bool Q4, int BM>
cudaError_t tiles_width(const void* x, const void* qs, const float* sc, const float* mn, const int* bg,
                        const int* br, __nv_bfloat16* y, int M, int K, int N, int tm, int gshift,
                        cudaStream_t st) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  return N % T8_ROWS != 0 || tiles_k_split(N / T8_ROWS * (M / BM), sms)
             ? tiles_launch<Q4, BM, true>(x, qs, sc, mn, bg, br, y, M, K, N, tm, gshift, st)
             : tiles_launch<Q4, BM, false>(x, qs, sc, mn, bg, br, y, M, K, N, tm, gshift, st);
}

template <bool Q4>
cudaError_t tiles(const void* x, const void* qs, const float* sc, const float* mn, const int* bg,
                  const int* br, __nv_bfloat16* y, int M, int K, int N, int tm, int gshift,
                  cudaStream_t st) {
  return tm % 128 == 0 ? tiles_width<Q4, 128>(x, qs, sc, mn, bg, br, y, M, K, N, tm, gshift, st)
                       : tiles_width<Q4, 32>(x, qs, sc, mn, bg, br, y, M, K, N, tm, gshift, st);
}

// tm = 8 or a multiple of 32 (then N % 64 == 0); K % 32 == 0
bool shape_ok(int M, int K, int N, int tm) {
  return K % 32 == 0 && K > 0 && N > 0 && tm > 0 && M % tm == 0 &&
         (tm == GV_TM || (tm % 32 == 0 && N % 64 == 0));
}

}  // namespace

// x [M, K] bf16 (M % tm == 0), block_group [M/tm] int32 (an expert id),
// block_rows [M/tm] int32 (the real rows of each block), y [M, N] bf16.
// tm = 8 (GEMV) or a multiple of 32 (tiles, N % 64 == 0); K % 32 == 0.
// K8: qs [E, N, K/2] uint8, scales/mins [E, N, K/32] f32.
extern "C" int nfai_grouped_q4(const void* x, const void* qs, const void* sc, const void* mn,
                               const void* block_group, const void* block_rows, void* y,
                               int M, int K, int N, int tm, void* stream) {
  if (!shape_ok(M, K, N, tm)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xb = static_cast<const __nv_bfloat16*>(x);
  const auto q = static_cast<const uint8_t*>(qs);
  const auto s = static_cast<const float*>(sc);
  const auto m = static_cast<const float*>(mn);
  const auto bg = static_cast<const int*>(block_group);
  const auto br = static_cast<const int*>(block_rows);
  const auto yb = static_cast<__nv_bfloat16*>(y);
  if (tm == GV_TM) return static_cast<int>(gemv_launch<true, false, true>(xb, q, s, m, bg, br, yb, M, K, N, st));
  return static_cast<int>(tiles<true>(x, qs, s, m, bg, br, yb, M, K, N, tm, 5, st));
}

// K9: qs [E, N, K] int8, scales/mins [E, N, K/group] f32 (mins may be null),
// group 16 or 32.
extern "C" int nfai_grouped_q8(const void* x, const void* qs, const void* sc, const void* mn,
                               const void* block_group, const void* block_rows, void* y,
                               int M, int K, int N, int tm, int group, void* stream) {
  if (!shape_ok(M, K, N, tm) || (group != 16 && group != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xb = static_cast<const __nv_bfloat16*>(x);
  const auto q = static_cast<const uint8_t*>(qs);
  const auto s = static_cast<const float*>(sc);
  const auto m = static_cast<const float*>(mn);
  const auto bg = static_cast<const int*>(block_group);
  const auto br = static_cast<const int*>(block_rows);
  const auto yb = static_cast<__nv_bfloat16*>(y);
  if (tm == GV_TM) {
    cudaError_t err;
    if (group == 32)
      err = m ? gemv_launch<false, true, true>(xb, q, s, m, bg, br, yb, M, K, N, st)
              : gemv_launch<false, true, false>(xb, q, s, m, bg, br, yb, M, K, N, st);
    else
      err = m ? gemv_launch<false, false, true>(xb, q, s, m, bg, br, yb, M, K, N, st)
              : gemv_launch<false, false, false>(xb, q, s, m, bg, br, yb, M, K, N, st);
    return static_cast<int>(err);
  }
  return static_cast<int>(tiles<false>(x, qs, s, m, bg, br, yb, M, K, N, tm, group == 16 ? 4 : 5, st));
}
