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
// across grid steps; here blocks own F tiles and run in parallel, so the sum
// over F is a reduction across blocks, made in a fixed order so that equal
// inputs give equal bits on every run (the TPU kernel's sum is ordered too).
//
// Weight layout: the port's Q4Tensor (nfai_tpu_torch/ops/qtensor.py) in
// natural order, N-major: qs uint8 [N, K/2] (32-block b of row n is bytes
// [16b, 16b+16), byte j = element 32b+j low nibble, 32b+16+j high), f32
// scales and mins [N, K/32]; w = s*q - m. gate_up rows [0, F) are gate,
// [F, 2F) up; down rows are output columns h, its F-slice of a block is a
// short strided read per row (2 x 16 bytes at TF = 64).
//
// What bounds it on an H100: at decode (M <= 8) the weights, 0.75 B each
// (25.2 MB gate_up + 12.6 MB down at Llama-3.2-1B widths, 0.011 ms at 3.35
// TB/s); the [M, F] activation never leaves the SM. At M = 1024 the
// operations (103 GFLOP, 0.104 ms at 989 TF/s bf16).
//
// Design. Grid (F / TF, ceil(M / TM)), 512 threads; TM = 16 rows for
// M <= 16, else 64. A block
//   1. computes g, u for its TM rows and TF ffn columns, 64 columns at a
//      time: each step dequantizes a 128-row x 128-deep tile of gate|up (one
//      32-block per thread, f32 scale product, one bf16 rounding) into
//      shared memory and multiplies it with the x tile on tensor cores (WMMA
//      16x16x16 bf16, f32 accumulate; each warp takes 16 columns over half
//      the depth, the halves meet in shared memory); the next step's raw
//      block is loaded into registers while the current one multiplies.
//      a = act(g) * u goes to shared memory as bf16 [TM, TF];
//   2. multiplies a with the down weight's F-slice, 256 output columns at a
//      time, and stores its [TM, 256] partial into its own slice of an f32
//      workspace [F / TF, M, H] (plain stores, no atomics);
//   3. counts itself done for that (row tile, 256-column chunk); the last
//      block to arrive there (threadfence reduction) sums the F / TF
//      partials of the chunk in F-tile order and writes the bf16 result
//      (with few rows, up to 8 sets of its threads each sum a run of tiles
//      in order, and the runs are added in order). Blocks walk the chunks
//      starting at chunk blockIdx.x, so the last arrivals, and with them
//      the final sums, fall to different blocks instead of all to the
//      slowest one.
// At decode a block is one of ~128, one per SM, and its serial steps
// (dequantize, barrier, WMMA, barrier) set its time rather than the bytes:
// 16 warps and deep steps (24 steps at the 1B widths) keep more of them in
// flight than 8 warps and 48 steps did.
// TF (ffn columns per block) is 64 at decode, so F = 8192 makes 128 blocks
// on the 132 SMs; the wrapper widens it at prefill row counts (up to 512) to
// keep the partials, M * H * F / TF floats written and read back once each,
// near 34 M. The sum over F tiles is deterministic: each output element is
// the f32 sum of its F / TF partials in tile order, whichever block makes
// it (f32 atomics here would make 16-layer runs differ by ~1.7e-2). wgmma,
// TMA and a deeper pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int KC1 = 128;       // phase 1 depth per step: four 32-blocks
constexpr int LDW1 = KC1 + 8;  // bf16 row stride of the gate|up and x tiles
constexpr int NW1 = 128;       // phase 1 weight rows per step: 64 gate + 64 up
constexpr int KC2 = 64;        // phase 2 depth per step: two 32-blocks of F
constexpr int LDW2 = KC2 + 8;  // bf16 row stride of the down tile
constexpr int NW2 = 256;       // phase 2 weight rows (output columns) per step
constexpr int HALF = 136;      // f32 column offset of the second k-half's g|u
constexpr int LDO = 264;       // f32 row stride of the staging tile
constexpr int TF_MAX = 512;
constexpr int WS_ELEMS = NW2 * LDW2 > NW1 * LDW1 ? NW2 * LDW2 : NW1 * LDW1;

struct RawBlock {  // one 32-block of one weight row
  uint4 q;
  float s, m;
};

__device__ __forceinline__ RawBlock load_block(const uint8_t* __restrict__ qs,
                                               const float* __restrict__ sc,
                                               const float* __restrict__ mn,
                                               size_t row, int row_blocks, int blk) {
  RawBlock r;
  const size_t b = row * row_blocks + blk;
  r.q = __ldg(reinterpret_cast<const uint4*>(qs) + b);
  r.s = __ldg(sc + b);
  r.m = __ldg(mn + b);
  return r;
}

__device__ __forceinline__ float nib(uint32_t v) {
  // v in [0, 15] -> exactly (float)v
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

// 32 dequantized weights s*q - m (f32) -> 32 bf16 at dst (4-byte aligned)
__device__ __forceinline__ void store_block(__nv_bfloat16* dst, const RawBlock& r) {
  const uint32_t wv[4] = {r.q.x, r.q.y, r.q.z, r.q.w};
  const float mi = -r.m;
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
#pragma unroll
  for (int h = 0; h < 2; ++h)  // h = 0: elements 0..15 (low nibbles), 1: 16..31
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const float a = fmaf(r.s, nib((wv[i >> 2] >> (8 * (i & 3) + 4 * h)) & 0xFu), mi);
      const float b = fmaf(r.s, nib((wv[(i + 1) >> 2] >> (8 * ((i + 1) & 3) + 4 * h)) & 0xFu), mi);
      d2[(16 * h + i) >> 1] = __floats2bfloat162_rn(a, b);
    }
}

__device__ __forceinline__ float activation(float g, int gelu) {
  if (gelu) {  // tanh approximation, as jax.nn.gelu(approximate=True)
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return g / (1.f + __expf(-g));  // silu
}

template <int TM>
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ gq, const float* __restrict__ gs,
                 const float* __restrict__ gm, const uint8_t* __restrict__ dq,
                 const float* __restrict__ ds, const float* __restrict__ dm,
                 float* __restrict__ part, unsigned* __restrict__ arrivals,
                 __nv_bfloat16* __restrict__ y, int M, int K, int F, int H,
                 int TF, int gelu) {
  using namespace nvcuda;
  constexpr int RF = TM / 16;  // row fragments per warp
  constexpr int XV = (TM * (KC1 / 8) + THREADS - 1) / THREADS;  // x uint4 loads per thread
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [NW1][LDW1] or [NW2][LDW2]
  __nv_bfloat16* xs = ws + WS_ELEMS;                            // [TM][LDW1]
  float* os = reinterpret_cast<float*>(xs + TM * LDW1);         // [TM][LDO]
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(os + TM * LDO);  // [TM][TF + 8]
  __shared__ unsigned last_arrival;
  const int lda = TF + 8;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int f0 = blockIdx.x * TF, m0 = blockIdx.y * TM;
  const int gu_blocks = K >> 5, dn_blocks = F >> 5;

  // ---- phase 1: as[TM, TF] = bf16(act(x Wg^T) * (x Wu^T)), 64 ffn columns per sub-tile.
  // Thread: row r1 of the 128, 32-block b1 of the step's four. Warp: 16 of
  // the 128 columns (cs) over one half of the step's depth (kh); the two
  // halves' sums meet in the staging tile.
  const int r1 = tid >> 2, b1 = tid & 3, cs = warp & 7, kh = warp >> 3;
  const int ksteps = K / KC1, steps1 = (TF / 64) * ksteps;
  auto gu_load = [&](int t) -> RawBlock {
    const int c = f0 + (t / ksteps) * 64 + (r1 & 63);
    const size_t row = r1 < 64 ? (size_t)c : (size_t)(F + c);
    return load_block(gq, gs, gm, row, gu_blocks, (t % ksteps) * (KC1 >> 5) + b1);
  };
  auto load_x = [&](uint4* xr, int t) {
    const int kc = (t % ksteps) * KC1;
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int idx = tid + v * THREADS, r = idx >> 4, c8 = idx & 15;
      xr[v] = make_uint4(0, 0, 0, 0);
      if (idx < TM * 16 && m0 + r < M)
        xr[v] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + kc + c8 * 8));
    }
  };
  // ---- phase 2 mapping: row r2 of the step's 256, 32-block b2 of its two;
  // warp: 16 of the 256 output columns. Chunk order starts at blockIdx.x.
  const int r2 = tid >> 1, b2 = tid & 1;
  const int fsteps = TF / KC2, chunks = H / NW2, steps2 = chunks * fsteps;
  auto chunk0 = [&](int t) { return ((t / fsteps + blockIdx.x) % chunks) * NW2; };
  auto dn_load = [&](int t) -> RawBlock {
    const int h0 = chunk0(t), fs = (t % fsteps) * KC2;
    return load_block(dq, ds, dm, (size_t)(h0 + r2), dn_blocks, ((f0 + fs) >> 5) + b2);
  };
  // the first down block is fetched now and held through phase 1
  RawBlock rd = dn_load(0);
  RawBlock rg = gu_load(0);
  uint4 xr[XV];
  load_x(xr, 0);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc[RF];
  for (int t = 0; t < steps1; ++t) {
    const int sub = t / ksteps, kc = (t % ksteps) * KC1;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < RF; ++i) wmma::fill_fragment(fc[i], 0.f);
    }
    store_block(ws + r1 * LDW1 + b1 * 32, rg);
#pragma unroll
    for (int v = 0; v < XV; ++v) {
      const int idx = tid + v * THREADS;
      if (idx < TM * 16)
        *reinterpret_cast<uint4*>(&xs[(idx >> 4) * LDW1 + (idx & 15) * 8]) = xr[v];
    }
    __syncthreads();
    if (t + 1 < steps1) {  // prefetch the next step while this one multiplies
      rg = gu_load(t + 1);
      load_x(xr, t + 1);
    }
#pragma unroll
    for (int kk = kh * (KC1 / 2); kk < (kh + 1) * (KC1 / 2); kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, ws + cs * 16 * LDW1 + kk, LDW1);
#pragma unroll
      for (int i = 0; i < RF; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, xs + i * 16 * LDW1 + kk, LDW1);
        wmma::mma_sync(fc[i], fa, fb, fc[i]);
      }
    }
    __syncthreads();
    if (kc + KC1 == K) {  // sub-tile done: g in staging columns [0, 64), u in [64, 128),
                          // the second k-half's at +HALF
#pragma unroll
      for (int i = 0; i < RF; ++i)
        wmma::store_matrix_sync(os + i * 16 * LDO + kh * HALF + cs * 16, fc[i], LDO,
                                wmma::mem_row_major);
      __syncthreads();
      for (int e = tid; e < TM * 64; e += THREADS) {
        const int r = e >> 6, c = e & 63;
        const float* o = os + r * LDO;
        const float a = activation(o[c] + o[HALF + c], gelu) * (o[64 + c] + o[HALF + 64 + c]);
        as[r * lda + sub * 64 + c] = __float2bfloat16(a);
      }
      __syncthreads();
    }
  }

  // ---- phase 2: part[blockIdx.x, m0 + r, :] = as[r, :] Wd[:, f0:f0+TF]^T, 256 output
  // columns per chunk; the last block at a chunk sums its partials in F-tile order
  const int rows = min(TM, M - m0), n_ft = gridDim.x;
  for (int t = 0; t < steps2; ++t) {
    const int h0 = chunk0(t), fs = (t % fsteps) * KC2;
    if (fs == 0) {
#pragma unroll
      for (int i = 0; i < RF; ++i) wmma::fill_fragment(fc[i], 0.f);
    }
    store_block(ws + r2 * LDW2 + b2 * 32, rd);
    __syncthreads();
    if (t + 1 < steps2) rd = dn_load(t + 1);
#pragma unroll
    for (int kk = 0; kk < KC2; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, ws + warp * 16 * LDW2 + kk, LDW2);
#pragma unroll
      for (int i = 0; i < RF; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, as + i * 16 * lda + fs + kk, lda);
        wmma::mma_sync(fc[i], fa, fb, fc[i]);
      }
    }
    __syncthreads();
    if (fs + KC2 == TF) {  // chunk done: store the [rows, 256] partial, then count arrivals
#pragma unroll
      for (int i = 0; i < RF; ++i)
        wmma::store_matrix_sync(os + i * 16 * LDO + warp * 16, fc[i], LDO, wmma::mem_row_major);
      __syncthreads();
      float* dst = part + ((size_t)blockIdx.x * M + m0) * H + h0;
      for (int e = tid; e < rows * (NW2 / 4); e += THREADS) {
        const int r = e / (NW2 / 4), c = (e % (NW2 / 4)) * 4;
        __stcg(reinterpret_cast<float4*>(dst + (size_t)r * H + c),
               *reinterpret_cast<const float4*>(os + r * LDO + c));
      }
      __threadfence();
      __syncthreads();
      if (tid == 0)
        last_arrival = atomicAdd(arrivals + blockIdx.y * chunks + h0 / NW2, 1u) == n_ft - 1;
      __syncthreads();
      if (last_arrival) {  // every partial of this chunk is stored: sum them in tile order
        __threadfence();
        // few rows (decode): `groups` sets of threads each sum a run of F
        // tiles in order, then the runs are added in order (gsum over the
        // free staging tile); the order depends on M alone
        const int items = rows * (NW2 / 4);  // float4 columns of the chunk
        const int groups = items >= THREADS ? 1 : min(8, THREADS / items);
        const int per = (n_ft + groups - 1) / groups;
        float4* gsum = reinterpret_cast<float4*>(os);  // [groups][items]
        for (int e = tid; e < items * groups; e += THREADS) {
          const int it = e % items, g = e / items;
          const int r = it / (NW2 / 4), c = (it % (NW2 / 4)) * 4;
          const float* src = part + (size_t)(m0 + r) * H + h0 + c;
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
          const int ft_end = min(n_ft, (g + 1) * per);
#pragma unroll 8
          for (int ft = g * per; ft < ft_end; ++ft) {
            const float4 v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)ft * M * H));
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
          }
          if (groups == 1) {
            __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + r) * H + h0 + c);
            out[0] = __floats2bfloat162_rn(sum.x, sum.y);
            out[1] = __floats2bfloat162_rn(sum.z, sum.w);
          } else {
            gsum[g * items + it] = sum;
          }
        }
        if (groups > 1) {
          __syncthreads();
          for (int it = tid; it < items; it += THREADS) {
            float4 sum = gsum[it];
            for (int g = 1; g < groups; ++g) {
              const float4 v = gsum[g * items + it];
              sum.x += v.x;
              sum.y += v.y;
              sum.z += v.z;
              sum.w += v.w;
            }
            const int r = it / (NW2 / 4), c = (it % (NW2 / 4)) * 4;
            __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + r) * H + h0 + c);
            out[0] = __floats2bfloat162_rn(sum.x, sum.y);
            out[1] = __floats2bfloat162_rn(sum.z, sum.w);
          }
        }
      }
    }
  }
}

template <int TM>
int launch(const void* x, const void* gq, const void* gs, const void* gm,
           const void* dq, const void* ds, const void* dm, float* part,
           unsigned* arrivals, void* y, int M, int K, int F, int H, int TF,
           int gelu, cudaStream_t st) {
  static bool configured = false;  // idempotent: a race only repeats the call
  auto smem_bytes = [](int tf) {
    return (size_t)WS_ELEMS * 2 + (size_t)TM * LDW1 * 2 + (size_t)TM * LDO * 4 +
           (size_t)TM * (tf + 8) * 2;
  };
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(fused_mlp_kernel<TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(TF_MAX));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const size_t smem = smem_bytes(TF);
  dim3 grid(F / TF, (M + TM - 1) / TM), block(THREADS);
  fused_mlp_kernel<TM><<<grid, block, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(gq),
      static_cast<const float*>(gs), static_cast<const float*>(gm),
      static_cast<const uint8_t*>(dq), static_cast<const float*>(ds),
      static_cast<const float*>(dm), part, arrivals, static_cast<__nv_bfloat16*>(y),
      M, K, F, H, TF, gelu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] bf16; gate_up qs [2F, K/2] u8 + scales/mins [2F, K/32] f32; down
// qs [H, F/2] u8 + scales/mins [H, F/32] f32; work f32 [(F/TF)*M*H] (the
// partials, written before they are read) followed by ceil(M/TM) * H/256
// zeroed arrival counters (one per row tile and 256-column chunk); y [M, H]
// bf16. TF ffn columns per block (64..512, a multiple of 64 dividing F);
// gelu 0 = silu, 1 = tanh-gelu. Needs K % 128 == 0 and H % 256 == 0.
extern "C" int nfai_fused_mlp(const void* x, const void* gq, const void* gs,
                              const void* gm, const void* dq, const void* ds,
                              const void* dm, void* work, void* y, int M, int K,
                              int F, int H, int TF, int gelu, void* stream) {
  if (M < 1 || K % KC1 || H % NW2 || TF % 64 || TF > TF_MAX || F % TF)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(work);
  unsigned* arrivals = reinterpret_cast<unsigned*>(part + (size_t)(F / TF) * M * H);
  if (M <= 16)
    return launch<16>(x, gq, gs, gm, dq, ds, dm, part, arrivals, y, M, K, F, H, TF, gelu, st);
  return launch<64>(x, gq, gs, gm, dq, ds, dm, part, arrivals, y, M, K, F, H, TF, gelu, st);
}
