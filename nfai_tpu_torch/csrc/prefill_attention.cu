// K4: flash prefill attention over one layer of the KV cache, causal by
//     absolute position (the chunk's K/V are already written):
//
//   out[b, t, hq, :] = softmax_s(cap(q[b, t, hq] . k_s * scale)) @ v_s
//   over cache slots qpos - window < s <= qpos = offsets[b] + t of kv head
//   hq / r (no lower end without a window; cap(x) = softcap * tanh(x /
//   softcap) where a softcap is given).
//
// Replaces nfai_tpu/ops/prefill_attention.py::flash_prefill_attention with
// kv_layout="full" (_prefill_kernel_full), softcap (:232-233) and sliding
// window (tile skip :200-202, mask :217-219) included: q [B, T, Hq, D],
// cache [B, S, Hkv*D] read in place (no head-major transpose). The same
// kernel serves its kv_layout="headmajor" and "merged" calls (_prefill_kernel,
// the pallas_call at :414): only the K/V tensor maps differ (a run-time
// flag), the block code is one. "headmajor" reads a [B, Hkv, S, D] cache
// (entry points nfai_prefill_attention_hm and _hm_i8, their own launch
// counters); "merged" reads the native merged-lane rows one head at a time,
// which is what every block here already does (one block per query tile, kv
// head and batch row, loading that head's D columns of each key row: the
// merged BlockSpec's grid (bb, kk, h)), so it launches the merged-lane
// instance, counted under its own variant label by the wrapper. Every
// layout runs the same arithmetic on the same values: the same bits.
//
// What bounds it on an H100: operations once T is large (4 * T * span * D
// flops per head against one read of the span's K/V, 989 TF/s bf16); at
// T = 16 the bytes.
//
// Design (Hopper: TMA, mbarriers, wgmma, the softmax in registers). One
// block per (query tile, kv head, batch row): NG consumer warpgroups of 64
// query rows each and one producer warp. NG = 2 (the groups share each K/V
// tile) where such blocks number at least the SMs, as in a batch-8 chunk;
// else NG = 1, twice the blocks, two or three of them an SM (a batch-1
// chunk of 256 tokens ran 11-24% faster so; measured, PERF.md §6). D = 256
// takes NG = 1 always: its output is 128 f32 registers a thread. The r
// query heads of the kv head are packed into the rows (row i = token i /
// r, head i % r), so each K/V tile serves the whole GQA group; a tile
// holds 64 NG / r tokens, and where r does not divide 64 NG (r = 3) its
// last rows are padding: zero queries, never written.
// - Q: each group loads its 64 rows with 16-byte loads, folds the scale in
//   as bf16 (the JAX "full" kernel's q * scale), and stores them under the
//   128-byte swizzle, 64 columns a sub-tile, for the SS wgmma.
// - K and V: the producer's lane 0 brings each 64-key tile by TMA (3-D
//   maps: merged-lane [B, S, Hkv*D] at column h*D + 64c, or head-major
//   [B*Hkv, S, D]; 64-column boxes under the 128-byte swizzle) into a ring
//   of stages under full/empty mbarriers; tiles wholly in the causal future
//   of the block's last query, or before the window of its first, are never
//   loaded.
// - S = Q K^T: SS wgmma m64n64k16, both operands K-major in shared memory,
//   D/16 steps, the accumulators in registers (lane (g, t) of warp w holds
//   rows 16w + g and + 8, keys 8i + 2t and + 1).
// - The online softmax runs on those registers: the k scale (int8) on the
//   column, softcap by tanhf, the causal and window masks only on tiles
//   that cross the diagonal or the window's edge, the row max and sum over
//   the quad by two shuffles (the sum kept per lane until the end), the
//   output rescaled in registers.
// - O += P V: RS wgmma m64nDk16: P's A fragments are S's accumulator pairs
//   rounded to bf16 (the int8 v scale first, after the denominator took the
//   unscaled p); V is the B operand straight from its TMA tile, MN-major (d
//   contiguous) through wgmma's transpose-B immediate, its descriptor's
//   leading offset the 64-column sub-tiles' stride.
// - A group whose tile holds no visible key skips its products; a group
//   with no real row leaves at once (the empty barriers count the groups
//   that read).
// - Epilogue: the rows normalised and rounded to bf16 through the group's
//   Q tile in shared memory, then 16-byte stores down each row.
// int8 cache (nfai_prefill_attention_i8, counter prefill_attention_i8): kc/vc
// hold int8 codes and ks/vs the layer's per-(kv head, token) f32 scales
// [B, Hkv, S], as the JAX kernel's k_scales/v_scales. The codes come by TMA
// (half the bytes of a bf16 tile), the tile's 64 k and v scales by the
// producer lanes' cp.async onto the same mbarrier; the consumers turn the
// codes into bf16 tiles under the swizzle in one of two buffers (codes of
// |q| <= 127 are exact in bf16, the JAX `_to_mxu` note; wgmma has no
// int8 x bf16 form), release the stage, and meet at a barrier before the
// products; the k scale goes on S's column before the softmax, which sums
// the unscaled p, and the v scale on P (nfai_tpu/ops/prefill_attention.py:
// 120-148).
// No atomics: every output is one block's, summed in a fixed order; the
// same bits on every launch.
// D = 64, 96, 128 or 256, r <= 64, S % 64 == 0, 16-byte aligned tensors.
//
// Softcap and sliding window (EXT, a template flag: the Llama and Qwen
// launches compile none of it, as the JAX kernel makes them static).
#include "sm90.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int BS = 64;  // keys a tile

// NG consumer warpgroups of 64 query rows (NG = 1 at D = 256). A row is
// KC sub-tiles of 64 columns, DP = 64 KC wide: D = 96 takes two, the second
// half used (its columns past D hold the next head's values, or TMA's zeros
// past the tensor's edge: QK^T reads only D columns, P V computes DP output
// columns, and the epilogue stores D of them)
template <int D, int NG, bool Q8>
struct Shape {
  static constexpr int THREADS = NG * 128 + 32;      // and the producer warp
  static constexpr int KC = (D + 63) / 64;           // 64-column sub-tiles a row
  static constexpr int DP = KC * 64;                 // their columns
  static constexpr int Q_BYTES = NG * 64 * DP * 2;   // the groups' Q tiles
  static constexpr int TILE = BS * DP * 2;           // a bf16 K or V tile
  static constexpr int CODES = BS * DP;              // an int8 K or V tile
  static constexpr int CONV = Q8 ? 2 * 2 * TILE : 0;  // two buffers of converted K and V
  static constexpr int SC_OFF = 2 * CODES;            // the int8 stage's scales: BS k, BS v
  static constexpr int STAGE = Q8 ? SC_OFF + 2 * BS * 4 : 2 * TILE;
  static constexpr int STAGES = DP == 64 ? 4 : (NG == 1 ? 2 : (Q8 ? 3 : 4));
  static constexpr int SMEM = Q_BYTES + CONV + STAGES * STAGE + 1024;  // + alignment slack
  // blocks an SM (what shared memory and 64K registers allow): at NG = 1
  // D = 64 three (two int8), D = 96 and 128 two (one int8); at NG = 2 D = 64 two
  static constexpr int MIN_BLOCKS =
      NG == 1 ? (DP == 64 ? (Q8 ? 2 : 3) : (DP == 128 && !Q8 ? 2 : 1)) : (DP == 64 && !Q8 ? 2 : 1);
};

__device__ __forceinline__ void named_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// generic-proxy writes to shared memory made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 int8 codes → 16 bf16 (exact), as two uint4
__device__ __forceinline__ void i8x16_bf16(const uint4& u, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t x = w[i >> 1] >> (16 * (i & 1));
    o[i] = bf16x2(static_cast<float>(static_cast<int8_t>(x & 0xFFu)),
                  static_cast<float>(static_cast<int8_t>((x >> 8) & 0xFFu)));
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// byte offset of 16-byte chunk c8 (of D / 8) of row rr in a tile of `rows`
// rows stored as 64-column sub-tiles of [rows][128 B] under the 128-byte swizzle
__device__ __forceinline__ int sw_off(int rows, int rr, int c8) {
  return (c8 >> 3) * rows * 128 + rr * 128 + (((c8 & 7) ^ (rr & 7)) << 4);
}

// KV: the cache element, __nv_bfloat16 or int8_t (then ks/vs are read);
// EXT: softcap (> 0) and window (> 0) are read; hm: the maps are head-major
template <int D, int NG, typename KV, bool EXT>
__global__ void __launch_bounds__(Shape<D, NG, std::is_same<KV, int8_t>::value>::THREADS,
                                  Shape<D, NG, std::is_same<KV, int8_t>::value>::MIN_BLOCKS)
prefill_attn_wgmma(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                     const __nv_bfloat16* __restrict__ q,   // [B, T, Hq, D]
                     const float* __restrict__ ks,          // [B, Hkv, S] (int8 only)
                     const float* __restrict__ vs,
                     const int* __restrict__ offsets,       // [B]
                     __nv_bfloat16* __restrict__ out,       // [B, T, Hq, D]
                     int T, int S, int hkv, int r, int hm, float scale, float softcap, int window) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  using L = Shape<D, NG, Q8>;
  constexpr int KC = L::KC, DP = L::DP, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* stages = sm + L::Q_BYTES + L::CONV;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tt = NG * 64 / r, rows_used = tt * r;  // tokens a tile; the rest of the rows are padding
  const int t0 = blockIdx.x * tt, h = blockIdx.y, b = blockIdx.z;
  const int hq = hkv * r;
  const int offset = offsets[b];
  const int t_last = min(t0 + tt, T) - 1;
  const int n_tiles = min(S / BS, (offset + t_last) / BS + 1);
  int kt0 = 0;  // tiles wholly before the window of the tile's first query are skipped
  if constexpr (EXT)
    if (window > 0) kt0 = max(offset + t0 - window + 1, 0) / BS;
  int n_active = 0;  // the groups with a real row (group w's first row is token t0 + 64 w / r)
#pragma unroll
  for (int w = 0; w < NG; ++w) n_active += 64 * w < rows_used && t0 + 64 * w / r < T;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], Q8 ? 1 + 32 : 1);  // expect_tx (and the lanes' scale copies)
      mbar_init(&empty[s], 4 * n_active);    // every warp that reads the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NG) {  // the producer warp: K and V by TMA from lane 0, int8 scales by cp.async
    const int x0 = hm ? 0 : h * D, z = hm ? b * hkv + h : b;
    constexpr int SUB = BS * 64 * (int)sizeof(KV);  // one 64-column box
    for (int kt = kt0; kt < n_tiles; ++kt) {
      const int i = kt - kt0, s = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
      unsigned char* st = stages + s * L::STAGE;
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * KC * SUB);
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          tma_load_3d(st + c * SUB, &kmap, x0 + 64 * c, kt * BS, z, &full[s]);
          tma_load_3d(st + KC * SUB + c * SUB, &vmap, x0 + 64 * c, kt * BS, z, &full[s]);
        }
      }
      if constexpr (Q8) {  // BS k scales, then BS v scales: 2 * BS / 4 pieces of 16 bytes
        const size_t row = ((size_t)b * hkv + h) * S + kt * BS;
        for (int e = lane; e < BS / 2; e += 32) {
          const int which = e >= BS / 4, piece = e - which * (BS / 4);
          cp_async16(st + L::SC_OFF + which * BS * 4 + 16 * piece, (which ? vs : ks) + row + 4 * piece);
        }
        cp_async_arrive(&full[s]);
      }
    }
    if constexpr (Q8) asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives its thread
    return;
  }

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3, ctid = tid & 127;
  if (wg >= n_active) return;
  unsigned char* qs = sm + wg * (64 * DP * 2);  // this group's Q tile (later its output)
  for (int e = ctid; e < 64 * (D / 8); e += 128) {
    const int rr = e / (D / 8), c8 = e % (D / 8), row = 64 * wg + rr, tk = t0 + row / r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < rows_used && tk < T) {
      float f[8];
      bf16x8(__ldg(reinterpret_cast<const uint4*>(
                 q + (((size_t)b * T + tk) * hq + h * r + row % r) * D + 8 * c8)), f);
      v = make_uint4(bf16x2(f[0] * scale, f[1] * scale), bf16x2(f[2] * scale, f[3] * scale),
                     bf16x2(f[4] * scale, f[5] * scale), bf16x2(f[6] * scale, f[7] * scale));
    }
    *reinterpret_cast<uint4*>(qs + sw_off(64, rr, c8)) = v;
  }
  fence_async_smem();
  named_bar(1 + wg, 128);

  // this lane's rows: 16 wl + g and + 8 of the group; the group's first and
  // last query positions
  const int row0 = 64 * wg + 16 * wl + g;
  const int qpos[2] = {offset + t0 + row0 / r, offset + t0 + (row0 + 8) / r};
  const int g_first = offset + t0 + 64 * wg / r;
  const int g_last = offset + min(t0 + min(64 * wg + 63, rows_used - 1) / r, T - 1);
  const float inv_cap = EXT && softcap > 0.f ? 1.f / softcap : 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};  // l: this lane's share of the row's sum
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  for (int kt = kt0; kt < n_tiles; ++kt) {
    const int i = kt - kt0, s = i % STAGES, s0 = kt * BS;
    mbar_wait(&full[s], (i / STAGES) & 1);
    unsigned char* st = stages + s * L::STAGE;
    const unsigned char *ktile = st, *vtile = st + L::TILE;
    float ksc[Q8 ? BS / 4 : 1], vsc[Q8 ? BS / 4 : 1];  // the scales of this lane's columns
    if constexpr (Q8) {
#pragma unroll
      for (int c = 0; c < BS / 8; ++c) {
        const float2 k2 = *reinterpret_cast<const float2*>(st + L::SC_OFF + 4 * (8 * c + 2 * t4));
        const float2 v2 = *reinterpret_cast<const float2*>(st + L::SC_OFF + BS * 4 + 4 * (8 * c + 2 * t4));
        ksc[2 * c] = k2.x;
        ksc[2 * c + 1] = k2.y;
        vsc[2 * c] = v2.x;
        vsc[2 * c + 1] = v2.y;
      }
      // the codes → bf16 tiles in buffer i % 2 (free: every group passed the
      // barrier below at tile i - 1, after its products on tile i - 2)
      unsigned char* cb = sm + L::Q_BYTES + (i & 1) * 2 * L::TILE;
      const int n_thr = 128 * n_active;
      for (int e = 128 * wg + ctid; e < 2 * KC * BS * 4; e += n_thr) {  // (K | V, sub-tile, row, 16 codes)
        const int which = e / (KC * BS * 4), rem = e % (KC * BS * 4);
        const int c = rem / (BS * 4), rr = (rem >> 2) % BS, p = rem & 3;
        uint4 lo, hi;
        i8x16_bf16(*reinterpret_cast<const uint4*>(st + which * L::CODES + c * BS * 64 + rr * 64 + 16 * p),
                   lo, hi);
        unsigned char* dst = cb + which * L::TILE + c * BS * 128 + rr * 128;
        *reinterpret_cast<uint4*>(dst + (((2 * p) ^ (rr & 7)) << 4)) = lo;
        *reinterpret_cast<uint4*>(dst + (((2 * p + 1) ^ (rr & 7)) << 4)) = hi;
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp has read the stage
      named_bar(3, n_thr);
      ktile = cb;
      vtile = cb + L::TILE;
    }
    const bool active = s0 <= g_last && (!EXT || window <= 0 || s0 + BS - 1 > g_first - window);
    if (active) {
      float sacc[BS / 2];
#pragma unroll
      for (int j = 0; j < BS / 2; ++j) sacc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BS>(sacc, sw128_desc(qs + (kk >> 2) * 64 * 128 + 32 * (kk & 3)),
                     sw128_desc(ktile + (kk >> 2) * BS * 128 + 32 * (kk & 3)));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      // sacc[4c + 2hh + e]: row qpos[hh], key s0 + 8c + 2 t4 + e
      const bool masked = s0 + BS - 1 > g_first || (EXT && window > 0 && s0 <= g_last - window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BS / 2; ++j) {
        const int hh = (j >> 1) & 1, col = 8 * (j >> 2) + 2 * t4 + (j & 1);
        float x = sacc[j];
        if constexpr (Q8) x *= ksc[2 * (j >> 2) + (j & 1)];  // the k scale of the column
        if constexpr (EXT)
          if (inv_cap > 0.f) x = softcap * tanhf(x * inv_cap);
        if (masked) {
          const int key = s0 + col;
          bool vis = key <= qpos[hh];
          if constexpr (EXT) vis = vis && (window <= 0 || key > qpos[hh] - window);
          x = vis ? x : -INFINITY;
        }
        sacc[j] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m_run[hh], mx[hh]);
        corr[hh] = __expf(m_run[hh] - m_new);
        m_run[hh] = m_new;
        l_run[hh] *= corr[hh];
      }
#pragma unroll
      for (int j = 0; j < BS / 2; ++j) {
        const int hh = (j >> 1) & 1;
        const float p = __expf(sacc[j] - m_run[hh]);
        l_run[hh] += p;  // the denominator takes the unscaled p, P the v scale of its column
        sacc[j] = Q8 ? p * vsc[2 * (j >> 2) + (j & 1)] : p;
      }
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) o[j] *= corr[(j >> 1) & 1];
      // P's A fragments, k16 step k: (row g, keys 2t, 2t+1), (g + 8, the
      // same), (g, 2t + 8, 2t + 9), (g + 8, the same) = sacc[8k .. 8k + 7]
      uint32_t pf[BS / 16][4];
#pragma unroll
      for (int k = 0; k < BS / 16; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) pf[k][e] = bf16x2(sacc[8 * k + 2 * e], sacc[8 * k + 2 * e + 1]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BS / 16; ++k)
        wgmma_rs<DP, 1>(o, pf[k], sw128_mn_desc(vtile + k * 16 * 128, BS * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    if constexpr (!Q8) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp's products on the stage are done
    }
  }

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hh] = 1.f / fmaxf(l, 1e-30f);
  }
  named_bar(1 + wg, 128);  // every warp of the group is done with its Q tile
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = 16 * wl + g + 8 * hh;
      *reinterpret_cast<uint32_t*>(qs + sw_off(64, rr, c) + 4 * t4) =
          bf16x2(o[4 * c + 2 * hh] * inv[hh], o[4 * c + 2 * hh + 1] * inv[hh]);
    }
  named_bar(1 + wg, 128);
  for (int e = ctid; e < 64 * (D / 8); e += 128) {
    const int rr = e / (D / 8), c8 = e % (D / 8), row = 64 * wg + rr, tk = t0 + row / r;
    if (row < rows_used && tk < T)
      *reinterpret_cast<uint4*>(out + (((size_t)b * T + tk) * hq + h * r + row % r) * D + 8 * c8) =
          *reinterpret_cast<const uint4*>(qs + sw_off(64, rr, c8));
  }
}

template <int D, int NG, typename KV, bool EXT>
int launch(const void* q, const void* kc, const void* vc, const void* ks, const void* vs,
           const void* offsets, void* out, int B, int T, int S, int hkv, int r, bool hm, float scale,
           float softcap, int window, cudaStream_t st) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  using L = Shape<D, NG, Q8>;
  // once per instantiation: above the default 48 KB of shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_attn_wgmma<D, NG, KV, EXT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // [B, S, Hkv*D] merged-lane rows, or [B*Hkv, S, D] head-major; 64-column boxes of BS keys
  const uint64_t dims[3] = {static_cast<uint64_t>(hm ? D : hkv * D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(hm ? B * hkv : B)};
  const uint32_t box[3] = {64, BS, 1};
  const CUtensorMapDataType type = Q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle swz = Q8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap km, vm;
  cudaError_t err = tensor_map_nd(&km, type, sizeof(KV), kc, 3, dims, box, swz);
  if (err == cudaSuccess) err = tensor_map_nd(&vm, type, sizeof(KV), vc, 3, dims, box, swz);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tt = NG * 64 / r;
  const dim3 grid((T + tt - 1) / tt, hkv, B);
  prefill_attn_wgmma<D, NG, KV, EXT><<<grid, L::THREADS, L::SMEM, st>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(out),
      T, S, hkv, r, hm ? 1 : 0, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, bool EXT>
int dispatch_d(const void* q, const void* kc, const void* vc, const void* ks, const void* vs,
               const void* offsets, void* out, int B, int T, int S, int hkv, int r, int d, bool hm,
               float scale, float softcap, int window, cudaStream_t st) {
  // 128 query rows a block (two groups share each K/V tile) where such
  // blocks fill the SMs, else 64 (twice the blocks: a batch-1 chunk)
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool two = (long)(T + 128 / r - 1) / (128 / r) * hkv * B >= sms;
#define NFAI_LAUNCH(DD, NG)                                                                         \
  return launch<DD, NG, KV, EXT>(q, kc, vc, ks, vs, offsets, out, B, T, S, hkv, r, hm, scale, softcap, \
                                 window, st)
  if (d == 64) {
    if (two) NFAI_LAUNCH(64, 2);
    NFAI_LAUNCH(64, 1);
  }
  if (d == 96) {
    if (two) NFAI_LAUNCH(96, 2);
    NFAI_LAUNCH(96, 1);
  }
  if (d == 128) {
    if (two) NFAI_LAUNCH(128, 2);
    NFAI_LAUNCH(128, 1);
  }
  if (d == 256) NFAI_LAUNCH(256, 1);  // 128 f32 of output a thread: one group a block
#undef NFAI_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename KV>
int dispatch(const void* q, const void* kc, const void* vc, const void* ks, const void* vs,
             const void* offsets, void* out, int B, int T, int S, int hkv, int r, int d, bool hm,
             float scale, float softcap, int window, void* stream) {
  const auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  if (r <= 0 || r > 64 || S % BS != 0 || softcap < 0.f || window < 0 || misaligned(q) ||
      misaligned(kc) || misaligned(vc) || misaligned(out) || (ks && (misaligned(ks) || misaligned(vs))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (softcap > 0.f || window > 0)
    return dispatch_d<KV, true>(q, kc, vc, ks, vs, offsets, out, B, T, S, hkv, r, d, hm, scale, softcap,
                                window, st);
  return dispatch_d<KV, false>(q, kc, vc, ks, vs, offsets, out, B, T, S, hkv, r, d, hm, scale, 0.f, 0,
                               st);
}

}  // namespace

// q/out [B, T, Hkv*r, D], kc/vc [B, S, Hkv*D] (one layer), offsets [B]
// int32; bf16 except offsets. D in {64, 96, 128, 256}; needs r <= 64,
// S % 64 == 0 and 16-byte aligned tensors; softcap 0 = none, window 0 =
// unlimited.
extern "C" int nfai_prefill_attention(const void* q, const void* kc,
                                      const void* vc, const void* offsets,
                                      void* out, int B, int T, int S, int hkv,
                                      int r, int d, float scale, float softcap,
                                      int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, kc, vc, nullptr, nullptr, offsets, out, B, T, S, hkv, r, d, false,
                                 scale, softcap, window, stream);
}

// The int8 cache: kc/vc [B, S, Hkv*D] int8 codes, ks/vs [B, Hkv, S] f32
// scales (one layer's views); the rest as above.
extern "C" int nfai_prefill_attention_i8(const void* q, const void* kc,
                                         const void* vc, const void* ks,
                                         const void* vs, const void* offsets,
                                         void* out, int B, int T, int S, int hkv,
                                         int r, int d, float scale, float softcap,
                                         int window, void* stream) {
  return dispatch<int8_t>(q, kc, vc, ks, vs, offsets, out, B, T, S, hkv, r, d, false, scale, softcap,
                          window, stream);
}

// kv_layout "headmajor": kc/vc [B, Hkv, S, D] bf16; the rest as
// nfai_prefill_attention.
extern "C" int nfai_prefill_attention_hm(const void* q, const void* kc,
                                         const void* vc, const void* offsets,
                                         void* out, int B, int T, int S, int hkv,
                                         int r, int d, float scale, float softcap,
                                         int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, kc, vc, nullptr, nullptr, offsets, out, B, T, S, hkv, r, d, true,
                                 scale, softcap, window, stream);
}

// kv_layout "headmajor" on the int8 cache: kc/vc [B, Hkv, S, D] int8 codes,
// ks/vs [B, Hkv, S] f32 scales; the rest as nfai_prefill_attention_i8.
extern "C" int nfai_prefill_attention_hm_i8(const void* q, const void* kc,
                                            const void* vc, const void* ks,
                                            const void* vs, const void* offsets,
                                            void* out, int B, int T, int S, int hkv,
                                            int r, int d, float scale, float softcap,
                                            int window, void* stream) {
  return dispatch<int8_t>(q, kc, vc, ks, vs, offsets, out, B, T, S, hkv, r, d, true, scale, softcap,
                          window, stream);
}
