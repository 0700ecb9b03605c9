// K5: the one-kernel quantized MLP,
//     y[M, H] = bf16(act(x Wg^T) * (x Wu^T)) Wd^T        (M <= 1024)
// x bf16 [M, K]; Wg/Wu the two halves of the fused 4-bit gate_up weight
// [2F, K]; Wd the 4-bit down weight [H, F]; act = silu or tanh-gelu; f32
// accumulation, bf16 out. The activation is rounded to bf16 before the down
// product, as both Pallas bodies do.
//
// Replaces the Pallas kernel nfai_tpu/ops/fused_mlp.py::_fused_mlp with
// both its bodies, _mlp_kernel_v2 and _mlp_kernel (one function). The TPU
// kernel walks F in order on one core and carries the [B, H] sum in VMEM
// across grid steps; here blocks run in parallel, so the activation a is
// handed from the gate|up product to the down product through L2, and
// where blocks split F their partial sums are added in a fixed order, so
// that equal inputs give equal bits on every run (the TPU kernel's sum is
// ordered too).
//
// Weight layout: the port's Q4Tensor (nfai_tpu_torch/ops/qtensor.py) in
// natural order, N-major: qs uint8 [N, K/2] (32-block b of row n is bytes
// [16b, 16b+16), byte j = element 32b+j low nibble, 32b+16+j high), f32
// scales and mins [N, K/32]; w = s*q - m. gate_up rows [0, F) are gate,
// [F, 2F) up; down rows are output columns h.
//
// What bounds it on an H100: at decode (M <= 16) the weights, 0.75 B each
// (25.2 MB gate_up + 12.6 MB down at Llama-3.2-1B widths, 0.011 ms at 3.35
// TB/s). At M = 1024 the operations (103 GFLOP, 0.104 ms at 989 TF/s bf16).
//
// Decode (M <= 16, `fused_mlp_decode_kernel`): F / 64 blocks of 8 warps
// (128 at Llama-3.2-1B and -3B widths, on the 132 SMs), all resident at
// once (a cooperative launch). Each warp streams its own weight rows through
// a private ring of 4 (3 where shared memory is short) stages by 16-byte
// cp.async, ~80 KB in flight an SM with no block-wide barrier a step; a
// stage is 16 rows x 256 codes (2 KB of codes at a padded pitch, 1 KB of f32
// scales and mins). The product of a stage (`stage_product`) runs on tensor
// cores: mma.sync m16n8k16 with the weight as A (ldmatrix gives lane (g, t)
// word t of a 32-block of rows g and g + 8), its nibbles made exact bf16
// integers by one lop3 and one packed subtract in K1's permuted K order, and
// the activations as B in the same order (fragments built once a launch,
// rows past M zero); each 32-block's sum is scaled by its f32 scale and its
// min times the block's activation sum is subtracted: W enters as s q - m
// exactly.
//   1. Block b computes g and u for ffn columns 64 b .. 64 b + 63, a warp 8
//      of them: rows g = gate and g + 8 = up of one A fragment, so
//      a = bf16(act(g) u) forms in registers. The block stores its a as B
//      fragments and 32-block sums in `work` (L2) and counts its F slice.
//   2. Phase 2 runs items of 128 output rows x one F slice (1024 codes, 256
//      where F % 1024 != 0), dealt to the blocks in turn (one each at the
//      1B's widths): the block waits until every block of its slice has
//      stored a (all are resident, so this ends), copies the slice's
//      fragments into shared memory, and each warp multiplies 16 rows of
//      the down weight over the slice: 512 contiguous bytes of codes a row
//      (phase 2 over a 128-code slice of every row, with clusters
//      exchanging a in distributed shared memory, read 64-byte pieces at a
//      4 KB stride and took twice as long: PERF.md). The ring has fetched
//      the first down stages during phase 1.
//   3. A warp stores its [M, 16] f32 partial (part[slice][M][H], 0.5 MB at
//      M = 8 and the 1B's widths) and counts it at its 16 output rows; the
//      last of the F / slice arrivals sums the slices' partials in slice
//      order (no atomics in the sum: equal inputs give equal bits). Each
//      counter is left zero for the next launch by the one that used it last.
// What bounds it: the weight stream, ~1.7 TB/s on an H100 80GB HBM3 (37.7
// MB at the 1B's widths in 0.027 ms; the products cost ~0.003 ms of it,
// PERF.md).
//
// Tiles (M > 16, and shapes the decode kernel does not take;
// `fused_mlp_tiles_kernel`): K1's wgmma tiles twice in one launch. A
// producer warp brings every operand by TMA into a ring of 128-code stages
// under mbarriers; two consumer warpgroups decode the codes in registers
// into RS-form A fragments (bf16(s q - m), one rounding) against x or a as
// the 128-byte-swizzled B, y^T = W x^T with M as wgmma's N width (16, 32,
// 64 or 128).
//   1. Phase-1 tiles (F / 64 x row tiles): warpgroup 0 the 64 gate rows of
//      an ffn tile, warpgroup 1 its 64 up rows; the epilogue forms
//      a = bf16(act(g) u) through shared memory and stores a's rows [M, F]
//      (L2), then counts the row tile.
//   2. Phase-2 tiles (H / 128 x row tiles x ks F slices): each waits until
//      every phase-1 tile of its rows has stored a (blocks start in index
//      order and phase 1 waits on nothing, so this ends), then multiplies
//      128 down rows by a over its slice; with ks > 1 (the wrapper doubles
//      it while phase 2 fills no more than the SMs: 8 at 1-64 rows of the
//      1B's widths) the last slice to arrive adds the slices' f32 sums in
//      slice order. Both grids put a weight tile's row tiles side by side,
//      so each weight tile leaves HBM once.
// The gate|up product never leaves the SMs but as bf16 a; at M = 1024 a is
// 16 MB of L2 traffic each way. What bounds the tiles is K1's: the f32
// decode on the CUDA cores beside the products (PERF.md).
#include "sm90.cuh"

namespace {

__device__ __forceinline__ float activation(float g, int gelu) {
  if (gelu) {  // tanh approximation, as jax.nn.gelu(approximate=True)
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return g / (1.f + __expf(-g));  // silu
}

// ---------------------------------------------------------------------------
// decode (M <= 16): tensor-core GEMVs, a handed over through L2

constexpr int D_FB = 64;                      // ffn columns a block in phase 1 (8 a warp)
constexpr int D_RB = 128;                     // output rows of a phase-2 item (16 a warp)
constexpr int D_WARPS = 8, D_THREADS = 32 * D_WARPS;
constexpr int D_KS = 256;                     // codes a stage
constexpr int D_QP = 144;                     // smem pitch of a stage row's 128 code bytes
constexpr int D_ST_S = 16 * D_QP;             // scales [16 rows][8 f32]
constexpr int D_ST_M = D_ST_S + 16 * 32;      // mins, the same
constexpr int D_STAGE = D_ST_M + 16 * 32;     // 3328 bytes
constexpr int D_SMEM_MAX = 232448;            // an H100 block's shared memory

constexpr uint32_t NIB_MASK = 0x000F000Fu, HDR_128 = 0x43004300u;  // bf16x2 (128, 128)

// the nibbles at bits 0-3 and 16-19 of w → the bf16x2 of the two codes,
// exact (K1's decode): 0x4300 | q is 128 + q, and (128 + q) - 128 rounds nothing
__device__ __forceinline__ uint32_t nib2(uint32_t w) {
  return bf16x2_sub(lop3_and_or(w, NIB_MASK, HDR_128), HDR_128);
}

// B fragment of a 32-block of a bf16 row (x or a) in K1's permuted K order:
// lane (g, t) holds codes 4t..4t+3 of both halves of row g, from u (codes
// 4t..4t+3 of the low half) and v (the high half)
__device__ __forceinline__ uint4 b_frag(uint2 u, uint2 v) {
  return make_uint4(prmt(u.x, u.y, 0x5410), prmt(u.x, u.y, 0x7632), prmt(v.x, v.y, 0x5410),
                    prmt(v.x, v.y, 0x7632));
}

// the f32 sum of a 32-block of row g from the four lanes' fragments, in order
__device__ __forceinline__ float frag_sum(const uint4* lanes) {
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float f[8];
    bf16x8(lanes[t], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += f[i];
  }
  return sum;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// the F slice of a phase-2 item: 1024 codes, or 256 where F % 1024 != 0
__host__ __device__ constexpr int d_slice(int F) { return F % 1024 ? 256 : 1024; }

// shared memory of the decode kernel: the warps' rings; x's B fragments
// [K/32][NF][32 lanes] uint4 and their 32-block sums [K/32][MP]; a slice of
// a's fragments [FS/32][NF][32] and sums [FS/32][MP]; this block's a [MP][64]
__host__ __device__ constexpr int d_smem(int nf, int stages, int K, int F) {
  return D_WARPS * stages * D_STAGE + nf * K * 16 + (K / 32) * 8 * nf * 4 + nf * d_slice(F) * 16 +
         (d_slice(F) / 32) * 8 * nf * 4 + 8 * nf * D_FB * 2;
}

// One stage of a warp: acc[j] += W(16 rows x 256 codes) B(j), with B's
// fragments of its 32-blocks blk0 .. blk0 + 7 at frags[blk][NF][32] and
// their sums at sums[blk][MP]. C fragment: acc[j][0..1] row g, columns
// m = 8j + 2t, 2t + 1; acc[j][2..3] row g + 8.
template <int NF>
__device__ __forceinline__ void stage_product(const unsigned char* st, const uint4* frags, int blk0,
                                              const float* sums, int lane, float (&acc)[NF][4]) {
  constexpr int MP = 8 * NF;
  const int g = lane >> 2, t = lane & 3;
  const float4* sc = reinterpret_cast<const float4*>(st + D_ST_S);  // [16][2] float4
  const float4* mn = reinterpret_cast<const float4*>(st + D_ST_M);
  // ldmatrix: lanes 8i..8i+7 give rows of matrix i = (rows 0-7 | 8-15) x (block bb | bb + 1)
  const unsigned char* lrow = st + ((lane & 7) + 8 * ((lane >> 3) & 1)) * D_QP + 16 * (lane >> 4);
#pragma unroll
  for (int bb = 0; bb < 8; bb += 2) {
    uint32_t w[4];  // word t of: row g block bb, row g + 8 block bb, the same of block bb + 1
    ldmatrix_x4(w, lrow + 16 * bb);
    const float4 s0 = sc[2 * g + (bb >> 2)], s1 = sc[2 * (g + 8) + (bb >> 2)];
    const float4 m0 = mn[2 * g + (bb >> 2)], m1 = mn[2 * (g + 8) + (bb >> 2)];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = bb + h;
      const uint32_t w0 = w[2 * h], w1 = w[2 * h + 1];
      // half 0 (low nibbles): slots 2t, 2t+1 <- codes 4t, 4t+2; 2t+8, 2t+9 <- 4t+1, 4t+3;
      // half 1 (high nibbles) the same slots
      const uint32_t a0 = nib2(w0), a1 = nib2(w1), a2 = nib2(w0 >> 8), a3 = nib2(w1 >> 8);
      const uint32_t a4 = nib2(w0 >> 4), a5 = nib2(w1 >> 4), a6 = nib2(w0 >> 12), a7 = nib2(w1 >> 12);
      const float sg = comp(s0, b & 3), sh = comp(s1, b & 3);
      const float mg = comp(m0, b & 3), mh = comp(m1, b & 3);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const uint4 xv = frags[((blk0 + b) * NF + j) * 32 + lane];
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        mma_16816(p, a0, a1, a2, a3, xv.x, xv.y);
        mma_16816(p, a4, a5, a6, a7, xv.z, xv.w);
        const float2 xs = *reinterpret_cast<const float2*>(sums + (blk0 + b) * MP + 8 * j + 2 * t);
        acc[j][0] = fmaf(-mg, xs.x, fmaf(sg, p[0], acc[j][0]));
        acc[j][1] = fmaf(-mg, xs.y, fmaf(sg, p[1], acc[j][1]));
        acc[j][2] = fmaf(-mh, xs.x, fmaf(sh, p[2], acc[j][2]));
        acc[j][3] = fmaf(-mh, xs.y, fmaf(sh, p[3], acc[j][3]));
      }
    }
  }
}

// Grid: F / 64 blocks, all resident at once (a cooperative launch). work:
// a's fragments [F/32][NF][32] uint4, a's sums [F/32][MP] f32, the partials
// [F/FS][M][H] f32. counters u32: [H/16] row groups, then [F/FS] slices
// made ready, then [F/FS] slices read; zero at launch and left zero.
template <int NF, int S>
__global__ void __launch_bounds__(D_THREADS, 1)
fused_mlp_decode_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ gq,
                        const float* __restrict__ gs, const float* __restrict__ gm,
                        const uint8_t* __restrict__ dq, const float* __restrict__ ds,
                        const float* __restrict__ dm, unsigned char* __restrict__ work,
                        unsigned* __restrict__ counters, __nv_bfloat16* __restrict__ y, int M,
                        int K, int F, int H, int gelu) {
  constexpr int MP = 8 * NF;  // rows of x and a held (past M: zero)
  extern __shared__ __align__(16) unsigned char dsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int FS = d_slice(F), n_fs = F / FS;       // phase 2's F slices
  const int n_items = (H / D_RB) * n_fs;          // phase 2's items: (128 rows, slice)
  const int mine = ((int)(n_items - blockIdx.x) + (int)gridDim.x - 1) / (int)gridDim.x;  // this block's
  unsigned char* ring = dsm + warp * S * D_STAGE;
  uint4* xfr = reinterpret_cast<uint4*>(dsm + D_WARPS * S * D_STAGE);  // x's fragments
  float* xsum = reinterpret_cast<float*>(xfr + (K / 32) * NF * 32);
  uint4* afr = reinterpret_cast<uint4*>(xsum + (K / 32) * MP);        // a slice's fragments
  float* asum = reinterpret_cast<float*>(afr + (FS / 32) * NF * 32);
  __nv_bfloat16* a_own = reinterpret_cast<__nv_bfloat16*>(asum + (FS / 32) * MP);  // [MP][64]
  uint4* a_frag_g = reinterpret_cast<uint4*>(work);
  float* a_sum_g = reinterpret_cast<float*>(a_frag_g + (F / 32) * NF * 32);
  float* part = a_sum_g + (F / 32) * MP;
  unsigned* row_cnt = counters;
  unsigned* ready = counters + H / 16;
  unsigned* seen = ready + n_fs;
  const int n1 = K / D_KS, n2 = FS / D_KS;  // stages of phase 1, of a phase-2 item
  const int f0 = blockIdx.x * D_FB + 8 * warp;  // this warp's 8 gate (and up) rows
  auto item = [&](int q) { return blockIdx.x + gridDim.x * (q / n2); };  // of phase-2 stage q

  // A lane's copies of a stage: code rows rq + 4k (k < 4), chunk pq; scale
  // and min row rs, half ps. Phase 1: stage row r is gate row f0 + r, or up
  // row F + f0 + r - 8 for r >= 8; phase 2: the warp's 16 rows of an item
  // over 256 codes of its slice.
  const int rq = lane >> 3, pq = lane & 7, rs = lane >> 1, ps = lane & 1;
  auto gu_row = [&](int r) { return (size_t)(r < 8 ? f0 + r : F + f0 + r - 8); };
  const uint8_t* q1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q1[k] = gq + gu_row(rq + 4 * k) * (K / 2) + 16 * pq;
  const float* s1 = gs + gu_row(rs) * (K / 32) + 4 * ps;
  const float* m1 = gm + gu_row(rs) * (K / 32) + 4 * ps;
  auto issue = [&](int i) {  // stage i of this warp into its ring
    if (i >= n1 + mine * n2) return;
    unsigned char* st = ring + (i % S) * D_STAGE;
    if (i < n1) {  // codes 256 i .. of the 16 gate | up rows
#pragma unroll
      for (int k = 0; k < 4; ++k) cp_async16(st + (rq + 4 * k) * D_QP + 16 * pq, q1[k] + 128 * (size_t)i);
      cp_async16(st + D_ST_S + rs * 32 + 16 * ps, s1 + 8 * i);
      cp_async16(st + D_ST_M + rs * 32 + 16 * ps, m1 + 8 * i);
    } else {
      const int q = i - n1, it = item(q);
      const size_t r0 = (size_t)(it / n_fs) * D_RB + 16 * warp;
      const int c0 = (it % n_fs) * FS + D_KS * (q % n2);  // the stage's first code
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cp_async16(st + (rq + 4 * k) * D_QP + 16 * pq, dq + (r0 + rq + 4 * k) * (F / 2) + c0 / 2 + 16 * pq);
      cp_async16(st + D_ST_S + rs * 32 + 16 * ps, ds + (r0 + rs) * (F / 32) + c0 / 32 + 4 * ps);
      cp_async16(st + D_ST_M + rs * 32 + 16 * ps, dm + (r0 + rs) * (F / 32) + c0 / 32 + 4 * ps);
    }
  };

  // the ring's first S - 1 stages, then x's B fragments (rows past M zero)
  // and their 32-block sums while those land
  for (int s = 0; s < S - 1; ++s) {
    issue(s);
    cp_async_commit();
  }
  for (int e = tid; e < (K / 32) * NF * 32; e += D_THREADS) {
    const int blk = e / (NF * 32), m = 8 * ((e / 32) % NF) + ((e & 31) >> 2), c = 32 * blk + 4 * (e & 3);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m < M) {
      const __nv_bfloat16* row = x + (size_t)m * K + c;
      v = b_frag(__ldg(reinterpret_cast<const uint2*>(row)), __ldg(reinterpret_cast<const uint2*>(row + 16)));
    }
    xfr[e] = v;
  }
  __syncthreads();
  for (int e = tid; e < (K / 32) * MP; e += D_THREADS)  // [blk][MP]
    xsum[e] = frag_sum(xfr + ((e / MP) * NF + (e % MP) / 8) * 32 + 4 * (e % 8));
  __syncthreads();

  // ---- phase 1: g | u of this warp's 8 ffn columns
  float acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int i = 0; i < n1; ++i) {
    issue(i + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncwarp();
    stage_product<NF>(ring + (i % S) * D_STAGE, xfr, 8 * i, xsum, lane, acc);
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
  // a = bf16(act(g) u) (row g of the fragment is gate, row g + 8 up), then
  // its two 32-blocks as B fragments and sums into work, and the slice counted
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int m = 8 * j + 2 * t, c = 8 * warp + g;
    a_own[m * D_FB + c] = __float2bfloat16(activation(acc[j][0], gelu) * acc[j][2]);
    a_own[(m + 1) * D_FB + c] = __float2bfloat16(activation(acc[j][1], gelu) * acc[j][3]);
  }
  __syncthreads();
  for (int e = tid; e < 2 * NF * 32; e += D_THREADS) {
    const int blk = e / (NF * 32), m = 8 * ((e / 32) % NF) + ((e & 31) >> 2);
    const __nv_bfloat16* row = a_own + m * D_FB + 32 * blk + 4 * (e & 3);
    a_frag_g[(size_t)2 * blockIdx.x * NF * 32 + e] =
        b_frag(*reinterpret_cast<const uint2*>(row), *reinterpret_cast<const uint2*>(row + 16));
  }
  for (int e = tid; e < 2 * MP; e += D_THREADS) {  // [blk][MP]
    const __nv_bfloat16* row = a_own + (e % MP) * D_FB + 32 * (e / MP);
    float sum = 0.f;
    for (int i = 0; i < 32; ++i) sum += __bfloat162float(row[i]);
    a_sum_g[(size_t)2 * blockIdx.x * MP + e] = sum;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) atomicAdd(ready + blockIdx.x * D_FB / FS, 1u);

  // ---- phase 2: items (128 output rows, an F slice), this block's in turn;
  // warp w the rows 16 w .. of the item. A row group's partial is counted
  // after the next stage's product, so its stores have landed by then.
  auto count = [&](int hg) {  // the partial of rows hg .. hg + 15 is stored
    fence_acq_rel_gpu();  // releases each lane's stores
    __syncwarp();
    unsigned last = 0;
    if (lane == 0) {
      last = atomicAdd(row_cnt + hg / 16, 1u) == (unsigned)(n_fs - 1);
      if (last) fence_acq_rel_gpu();
    }
    if (!__shfl_sync(0xffffffffu, last, 0)) return;
    __syncwarp();  // the lanes' loads after lane 0's acquire
    // every slice's partial of these rows is stored: their sum in slice order
    const size_t step = (size_t)M * H / 4;  // float4s from one slice's partial to the next
    for (int e = lane; e < M * 4; e += 32) {
      const float4* src = reinterpret_cast<const float4*>(part + (size_t)(e >> 2) * H + hg + 4 * (e & 3));
      float4 sum = __ldcg(src);
      for (int k = 1; k < n_fs; ++k) {
        const float4 v = __ldcg(src + k * step);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      *reinterpret_cast<uint2*>(y + (size_t)(e >> 2) * H + hg + 4 * (e & 3)) =
          make_uint2(bf16x2(sum.x, sum.y), bf16x2(sum.z, sum.w));
    }
    if (lane == 0) row_cnt[hg / 16] = 0u;  // ready for the next launch
  };
  int pending = -1;  // the row group whose partial waits to be counted
  float pa[NF][4];
  for (int q = 0; q < mine * n2; ++q) {
    const int it = item(q), fs = it % n_fs, i = n1 + q;
    if (q % n2 == 0) {  // a new item: its slice of a, once every producer has stored it
      __syncthreads();  // the previous item's slice is no longer read
      if (tid == 0)
        while (ld_acquire(ready + fs) < (unsigned)(FS / D_FB)) __nanosleep(64);
      __syncthreads();
      const uint4* fsrc = a_frag_g + (size_t)(fs * FS / 32) * NF * 32;
      for (int e = tid; e < (FS / 32) * NF * 32; e += D_THREADS) afr[e] = __ldcg(fsrc + e);
      const float* ssrc = a_sum_g + (size_t)(fs * FS / 32) * MP;
      for (int e = tid; e < (FS / 32) * MP; e += D_THREADS) asum[e] = __ldcg(ssrc + e);
      __syncthreads();
      // the last of the slice's readers leaves its counters zero for the next launch
      if (tid == 0 && atomicAdd(seen + fs, 1u) == (unsigned)(H / D_RB - 1)) {
        ready[fs] = 0u;
        seen[fs] = 0u;
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) pa[j][0] = pa[j][1] = pa[j][2] = pa[j][3] = 0.f;
    }
    issue(i + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncwarp();
    stage_product<NF>(ring + (i % S) * D_STAGE, afr, 8 * (q % n2), asum, lane, pa);
    __syncwarp();
    if (pending >= 0) {
      count(pending);
      pending = -1;
    }
    if (q % n2 == n2 - 1) {  // the item's 16 rows of this warp are summed over the slice
      const int hg = (it / n_fs) * D_RB + 16 * warp;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 8 * j + 2 * t + (e & 1), h = hg + g + 8 * (e >> 1);
          if (m < M) part[((size_t)fs * M + m) * H + h] = pa[j][e];
        }
      }
      pending = hg;
    }
  }
  if (pending >= 0) count(pending);
}

template <int NF, int S>
cudaError_t launch_decode(const void* x, const void* gq, const void* gs, const void* gm,
                          const void* dq, const void* ds, const void* dm, void* work,
                          unsigned* counters, void* y, int M, int K, int F, int H, int gelu,
                          cudaStream_t st) {
  static bool sized = false;  // above 48 KB of shared memory needs the opt-in
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(fused_mlp_decode_kernel<NF, S>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, D_SMEM_MAX);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  // cooperative: every block resident at once (a phase-2 item waits for the
  // blocks of phase 1 that make its slice of a), or the launch is refused
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(F / D_FB);
  cfg.blockDim = dim3(D_THREADS);
  cfg.dynamicSmemBytes = d_smem(NF, S, K, F);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fused_mlp_decode_kernel<NF, S>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(gq), static_cast<const float*>(gs), static_cast<const float*>(gm),
      static_cast<const uint8_t*>(dq), static_cast<const float*>(ds), static_cast<const float*>(dm),
      static_cast<unsigned char*>(work), counters, static_cast<__nv_bfloat16*>(y), M, K, F, H, gelu);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int NF>
cudaError_t decode(const void* x, const void* gq, const void* gs, const void* gm, const void* dq,
                   const void* ds, const void* dm, void* work, unsigned* counters, void* y, int M,
                   int K, int F, int H, int gelu, cudaStream_t st) {
  if (d_smem(NF, 4, K, F) <= D_SMEM_MAX)
    return launch_decode<NF, 4>(x, gq, gs, gm, dq, ds, dm, work, counters, y, M, K, F, H, gelu, st);
  if (d_smem(NF, 3, K, F) <= D_SMEM_MAX)
    return launch_decode<NF, 3>(x, gq, gs, gm, dq, ds, dm, work, counters, y, M, K, F, H, gelu, st);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// tiles (16 < M <= 1024): K1's wgmma tiles twice in one launch, a through L2

constexpr int T_TN = 128, T_TK = 128;        // weight rows a block, codes a stage
constexpr int T_THREADS = 2 * 128 + 32;      // two consumer warpgroups, one producer warp

template <int BM>
struct TShape {
  static constexpr int STAGES = BM == 128 ? 4 : 6;
  static constexpr int X_BYTES = BM * 128;        // one of the stage's two 64-code x (a) tiles
  static constexpr int W_OFF = 2 * X_BYTES;       // codes: 128 rows of 64 bytes
  static constexpr int S_OFF = W_OFF + T_TN * 64;  // scales: 128 rows of 4 f32
  static constexpr int M_OFF = S_OFF + T_TN * 16;  // mins: the same
  static constexpr int STAGE = M_OFF + T_TN * 16;  // a multiple of 1024
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + alignment slack
  static constexpr int UP = BM + 4;               // f32 a row of the up tile (phase 1's epilogue)
  static constexpr int AP = 64 + 8;               // bf16 a row of the a tile
  static constexpr int OP = T_TN + 8;             // bf16 a row of the y tile
};

// Grid: phase-1 tiles (F / 64 ffn tiles x ceil(M / BM) row tiles; a tile's
// 128 weight rows are its 64 gate and 64 up rows), then phase-2 tiles (ks
// slices of F x H / 128 x the row tiles), each grid's row tiles side by
// side. A phase-2 tile starts once every phase-1 tile of its rows has
// stored a (blocks start in index order, so those are running or done).
// With ks > 1 the slices' f32 sums go to part [ks][row tiles][H / 128]
// [BM / 2][256 threads], and the last slice to arrive at a tile adds them in
// slice order. counters u32: [row tiles] phase-1 tiles done, [row tiles]
// phase-2 tiles that saw them, [row tiles][H / 128] slices arrived; zero at
// launch and left zero.
template <int BM>
__global__ void __launch_bounds__(T_THREADS, 1)
fused_mlp_tiles_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gqmap,
                       const __grid_constant__ CUtensorMap gsmap, const __grid_constant__ CUtensorMap gmmap,
                       const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap dqmap,
                       const __grid_constant__ CUtensorMap dsmap, const __grid_constant__ CUtensorMap dmmap,
                       __nv_bfloat16* __restrict__ a, float* __restrict__ part,
                       unsigned* __restrict__ counters, __nv_bfloat16* __restrict__ y, int M, int K,
                       int F, int H, int ks, int gelu) {
  using S = TShape<BM>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char tsm_raw[];
  unsigned char* tsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tsm_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_m = (M + BM - 1) / BM, n_f = F / D_FB, n_p1 = n_f * n_m, n_h = H / T_TN;
  const bool p1 = (int)blockIdx.x < n_p1;
  const int b = p1 ? blockIdx.x : blockIdx.x - n_p1;
  // row tile; ffn tile (phase 1) or y's 128 columns (phase 2); phase 2's F slice
  const int mt = b % n_m, wt = p1 ? b / n_m : (b / n_m) % n_h, slice = p1 ? 0 : b / (n_m * n_h);
  const int m0 = mt * BM;
  const int kt_n = p1 ? K / T_TK : F / T_TK / ks, kt0 = slice * kt_n;
  unsigned* ready = counters;
  unsigned* seen = counters + n_m;
  unsigned* arrived = counters + 2 * n_m;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // expect_tx
      mbar_init(&empty[s], 2);  // one thread of each group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp: every operand by TMA from lane 0
    if (lane == 0) {
      if (!p1) {  // a of these rows is complete; the last reader resets the counts
        while (ld_acquire(ready + mt) < (unsigned)n_f) __nanosleep(128);
        asm volatile("fence.proxy.async.global;\n" ::: "memory");  // TMA reads after the acquire
        if (atomicAdd(seen + mt, 1u) == (unsigned)(n_h * ks - 1)) {
          ready[mt] = 0u;
          seen[mt] = 0u;
        }
      }
      constexpr int TX = 2 * S::X_BYTES + T_TN * 64 + 2 * T_TN * 16;
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        unsigned char* st = tsm + s * S::STAGE;
        mbar_expect_tx(&full[s], TX);
        if (p1) {  // x; the 64 gate rows, then the 64 up rows
          tma_load_2d(st, &xmap, kt * T_TK, m0, &full[s]);
          tma_load_2d(st + S::X_BYTES, &xmap, kt * T_TK + 64, m0, &full[s]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = h * F + wt * D_FB;
            tma_load_2d(st + S::W_OFF + h * 64 * 64, &gqmap, kt * (T_TK / 2), row, &full[s]);
            tma_load_2d(st + S::S_OFF + h * 64 * 16, &gsmap, kt * 4, row, &full[s]);
            tma_load_2d(st + S::M_OFF + h * 64 * 16, &gmmap, kt * 4, row, &full[s]);
          }
        } else {  // a; 128 rows of the down weight
          const int k = kt0 + kt;
          tma_load_2d(st, &amap, k * T_TK, m0, &full[s]);
          tma_load_2d(st + S::X_BYTES, &amap, k * T_TK + 64, m0, &full[s]);
          tma_load_2d(st + S::W_OFF, &dqmap, k * (T_TK / 2), wt * T_TN, &full[s]);
          tma_load_2d(st + S::S_OFF, &dsmap, k * 4, wt * T_TN, &full[s]);
          tma_load_2d(st + S::M_OFF, &dmmap, k * 4, wt * T_TN, &full[s]);
        }
      }
    }
    return;
  }

  // consumers (K1's row split): group wg owns rows 64 wg .. 64 wg + 63 of
  // the block's 128 (phase 1: gate, then up)
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + g;  // this lane's rows r0 and r0 + 8
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  // a stage is two halves of two 32-blocks, four k16 products each; a
  // half's A registers are read while its products run, so the group waits
  // for them before it decodes the next half
  auto half = [&](const unsigned char* st, int hb, const float4 (&q)[4]) {
    uint32_t af[4][4];  // k16 step 2 jj + h: block 2 hb + jj, half h
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int jb = 2 * hb + jj;
      // lane t keeps bytes 2t, 2t+1, 2t+8, 2t+9 of the block's 16 of rows r0, r0 + 8
      const uint4 c0 = *reinterpret_cast<const uint4*>(st + S::W_OFF + r0 * 64 + 16 * jb);
      const uint4 c1 = *reinterpret_cast<const uint4*>(st + S::W_OFF + (r0 + 8) * 64 + 16 * jb);
      const uint32_t sel = (t & 1) ? 0x7632 : 0x5410;
      const uint32_t w0 = prmt(t & 2 ? c0.y : c0.x, t & 2 ? c0.w : c0.z, sel);
      const uint32_t w1 = prmt(t & 2 ? c1.y : c1.x, t & 2 ? c1.w : c1.z, sel);
      const float s0 = comp(q[0], jb), s1 = comp(q[1], jb);
      const float cc0 = -fmaf(128.f, s0, comp(q[2], jb)), cc1 = -fmaf(128.f, s1, comp(q[3], jb));
      decode_a<0>(w0, w1, s0, cc0, s1, cc1, af[2 * jj]);
      decode_a<1>(w0, w1, s0, cc0, s1, cc1, af[2 * jj + 1]);
    }
    uint64_t desc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      desc[j] = sw128_desc(st + hb * S::X_BYTES + 32 * j);
      pin(af[j], desc[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs<BM>(acc, af[j], desc[j]);
    wgmma_commit();
    wgmma_wait<0>();
  };
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* st = tsm + s * S::STAGE;
    const float4 q[4] = {*reinterpret_cast<const float4*>(st + S::S_OFF + r0 * 16),
                         *reinterpret_cast<const float4*>(st + S::S_OFF + (r0 + 8) * 16),
                         *reinterpret_cast<const float4*>(st + S::M_OFF + r0 * 16),
                         *reinterpret_cast<const float4*>(st + S::M_OFF + (r0 + 8) * 16)};
    half(st, 0, q);
    half(st, 1, q);
    if ((warp & 3) == 0 && lane == 0) mbar_arrive(&empty[s]);
  }
  fence_regs(acc);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both groups are done with the stages
  // D fragment: acc[4i + e] = row r0 (+8 for e >= 2), column m = 8i + 2t (+1 for odd e)
  if (p1) {  // a = bf16(act(g) u) for the tile's 64 ffn columns, into a's rows
    float* up = reinterpret_cast<float*>(tsm);  // [64][UP]
    __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(tsm + 64 * S::UP * 4);  // [BM][AP]
    const int rl = r0 - 64 * wg;
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) {
        const int m = 8 * i + 2 * t;
        up[rl * S::UP + m] = acc[4 * i];
        up[rl * S::UP + m + 1] = acc[4 * i + 1];
        up[(rl + 8) * S::UP + m] = acc[4 * i + 2];
        up[(rl + 8) * S::UP + m + 1] = acc[4 * i + 3];
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) {
        const int m = 8 * i + 2 * t;
        at[m * S::AP + rl] = __float2bfloat16(activation(acc[4 * i], gelu) * up[rl * S::UP + m]);
        at[(m + 1) * S::AP + rl] = __float2bfloat16(activation(acc[4 * i + 1], gelu) * up[rl * S::UP + m + 1]);
        at[m * S::AP + rl + 8] = __float2bfloat16(activation(acc[4 * i + 2], gelu) * up[(rl + 8) * S::UP + m]);
        at[(m + 1) * S::AP + rl + 8] =
            __float2bfloat16(activation(acc[4 * i + 3], gelu) * up[(rl + 8) * S::UP + m + 1]);
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    for (int e = tid; e < BM * 8; e += 256) {  // 16 bytes (8 columns) a thread
      const int m = e >> 3, c = 8 * (e & 7);
      if (m0 + m < M)
        *reinterpret_cast<uint4*>(a + (size_t)(m0 + m) * F + wt * D_FB + c) =
            *reinterpret_cast<const uint4*>(at + m * S::AP + c);
    }
    // release a to the phase-2 tiles, whose TMA (the async proxy) reads it
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    __threadfence();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (tid == 0) atomicAdd(ready + mt, 1u);
  } else {  // y's rows: the tile transposed through shared memory
    if (ks > 1) {  // this slice's sums stored; the last slice at the tile adds all in order
      const size_t tile = (size_t)mt * n_h + wt;
      float* mine = part + ((size_t)slice * n_m * n_h + tile) * (BM / 2) * 256 + tid;
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) mine[i * 256] = acc[i];
      __threadfence();
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      unsigned* flag = reinterpret_cast<unsigned*>(tsm + S::STAGE);  // past the y tile
      if (tid == 0) *flag = atomicAdd(arrived + tile, 1u) == (unsigned)(ks - 1);
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (!*flag) return;
      __threadfence();
      const float* all = part + tile * (BM / 2) * 256 + tid;
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) acc[i] = __ldcg(all + i * 256);
      for (int k = 1; k < ks; ++k) {
        const float* sl = all + (size_t)k * n_m * n_h * (BM / 2) * 256;
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) acc[i] += __ldcg(sl + i * 256);
      }
      if (tid == 0) arrived[tile] = 0u;  // ready for the next launch
    }
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(tsm);  // [BM][OP]
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const int m = 8 * i + 2 * t;
      out[m * S::OP + r0] = __float2bfloat16(acc[4 * i]);
      out[(m + 1) * S::OP + r0] = __float2bfloat16(acc[4 * i + 1]);
      out[m * S::OP + r0 + 8] = __float2bfloat16(acc[4 * i + 2]);
      out[(m + 1) * S::OP + r0 + 8] = __float2bfloat16(acc[4 * i + 3]);
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int n0 = wt * T_TN;
    for (int e = tid; e < BM * (T_TN / 8); e += 256) {
      const int m = e / (T_TN / 8), c = 8 * (e % (T_TN / 8));
      if (m0 + m < M && n0 + c < H)
        *reinterpret_cast<uint4*>(y + (size_t)(m0 + m) * H + n0 + c) =
            *reinterpret_cast<const uint4*>(out + m * S::OP + c);
    }
  }
}

template <int BM>
cudaError_t launch_tiles(const void* x, const void* gq, const void* gs, const void* gm, const void* dq,
                         const void* ds, const void* dm, void* a, float* part, unsigned* counters,
                         void* y, int M, int K, int F, int H, int ks, int gelu, cudaStream_t st) {
  static bool sized = false;  // one per instantiation: above 48 KB needs the opt-in
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_tiles_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, TShape<BM>::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  constexpr CUtensorMapDataType U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8, F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B, NO = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap xm, gqm, gsm, gmm, am, dqm, dsm, dmm;
  cudaError_t err = tensor_map(&xm, BF, 2, x, M, K, 64, BM, SW);
  if (err == cudaSuccess) err = tensor_map(&gqm, U8, 1, gq, 2 * F, K / 2, T_TK / 2, 64, NO);
  if (err == cudaSuccess) err = tensor_map(&gsm, F32, 4, gs, 2 * F, K / 32, 4, 64, NO);
  if (err == cudaSuccess) err = tensor_map(&gmm, F32, 4, gm, 2 * F, K / 32, 4, 64, NO);
  if (err == cudaSuccess) err = tensor_map(&am, BF, 2, a, M, F, 64, BM, SW);
  if (err == cudaSuccess) err = tensor_map(&dqm, U8, 1, dq, H, F / 2, T_TK / 2, T_TN, NO);
  if (err == cudaSuccess) err = tensor_map(&dsm, F32, 4, ds, H, F / 32, 4, T_TN, NO);
  if (err == cudaSuccess) err = tensor_map(&dmm, F32, 4, dm, H, F / 32, 4, T_TN, NO);
  if (err != cudaSuccess) return err;
  const int n_m = (M + BM - 1) / BM;
  const int grid = (F / D_FB) * n_m + ks * (H / T_TN) * n_m;
  fused_mlp_tiles_kernel<BM><<<grid, T_THREADS, TShape<BM>::SMEM, st>>>(
      xm, gqm, gsm, gmm, am, dqm, dsm, dmm, static_cast<__nv_bfloat16*>(a), part, counters,
      static_cast<__nv_bfloat16*>(y), M, K, F, H, ks, gelu);
  return cudaGetLastError();
}

// the tile width: the least of 16, 32, 64, 128 that holds M (larger M
// takes several 128-row tiles), as K1's; ks F slices for phase 2, set by
// the wrapper (`tiles_plan`), part its f32 sums where ks > 1
cudaError_t tiles(const void* x, const void* gq, const void* gs, const void* gm, const void* dq,
                  const void* ds, const void* dm, void* a, float* part, unsigned* counters, void* y,
                  int M, int K, int F, int H, int ks, int gelu, cudaStream_t st) {
#define K5_TILES(BM) launch_tiles<BM>(x, gq, gs, gm, dq, ds, dm, a, part, counters, y, M, K, F, H, ks, gelu, st)
  if (M <= 16) return K5_TILES(16);
  if (M <= 32) return K5_TILES(32);
  if (M <= 64) return K5_TILES(64);
  return K5_TILES(128);
#undef K5_TILES
}

}  // namespace

// Both entry points: x [M, K] bf16; gate_up qs [2F, K/2] u8 + scales/mins
// [2F, K/32] f32; down qs [H, F/2] u8 + scales/mins [H, F/32] f32; y [M, H]
// bf16; gelu 0 = silu, 1 = tanh-gelu.
//
// The decode kernel, 1 <= M <= 16. work (bytes): a's B
// fragments [F/32][M <= 8 ? 1 : 2][32] x 16, a's 32-block sums [F/32][8 or
// 16] f32, the partials [F/FS][M][H] f32 (FS = 1024, or 256 where F % 1024
// != 0; each written before it is read); counters u32 [H/16 + 2 F/FS],
// zero, and left zero by the launch. Needs K % 256 == 0, F % 256 == 0,
// H % 128 == 0, F / 64 blocks resident at once, 16-byte aligned tensors,
// and x's fragments beside the ring in shared memory (K <= 3072 at M > 8).
extern "C" int nfai_fused_mlp_decode(const void* x, const void* gq, const void* gs,
                                     const void* gm, const void* dq, const void* ds,
                                     const void* dm, void* work, void* counters, void* y, int M,
                                     int K, int F, int H, int gelu, void* stream) {
  if (M < 1 || M > 16 || K % D_KS || F % D_KS || H % D_RB)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* c = static_cast<unsigned*>(counters);
  return static_cast<int>(M <= 8 ? decode<1>(x, gq, gs, gm, dq, ds, dm, work, c, y, M, K, F, H, gelu, st)
                                 : decode<2>(x, gq, gs, gm, dq, ds, dm, work, c, y, M, K, F, H, gelu, st));
}

// The tiles, 1 <= M <= 1024. work: a bf16 [M, F], then
// (ks > 1) the f32 sums of phase 2's slices [ks][tiles of y][BM / 2][256]
// (written before they are read); counters u32 [ceil(M / BM) (2 + H / 128)],
// zero, and left zero by the launch. ks: 1, 2, 4 or 8 dividing F / 128.
// Needs K % 128 == 0, F % 128 == 0, H % 128 == 0 and 16-byte aligned
// tensors.
extern "C" int nfai_fused_mlp_tiles(const void* x, const void* gq, const void* gs,
                                    const void* gm, const void* dq, const void* ds,
                                    const void* dm, void* work, void* counters, void* y, int M,
                                    int K, int F, int H, int ks, int gelu, void* stream) {
  if (M < 1 || K % T_TK || F % T_TK || H % T_TN || ks < 1 || ks > 8 || (F / T_TK) % ks)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* a = static_cast<__nv_bfloat16*>(work);
  float* part = reinterpret_cast<float*>(a + (size_t)M * F);
  return static_cast<int>(tiles(x, gq, gs, gm, dq, ds, dm, a, part, static_cast<unsigned*>(counters),
                                y, M, K, F, H, ks, gelu, static_cast<cudaStream_t>(stream)));
}
