// K7: paged decode attention. One new token per row attends the keys of its
//     sequence, which live in a shared page pool and are found through the
//     row's block table (the row's own K/V were written before the call).
//
//   out[b, h*r + j, :] = softmax_s(cap(q[b, h*r+j] . k_s * scale)) @ v_s
//   over lo <= s < lengths[b] (lo = 0, or lengths[b] - window with a
//   sliding window; cap(x) = softcap * tanh(x / softcap) where a softcap is
//   given), where key s of row b is slot s % ps of page tables[b, s / ps]
//   in the layer's pool [Hkv, P, ps, D] (kv head h).
//
// Replaces nfai_tpu/ops/paged_attention.py::paged_flash_decode_attention
// (_paged_kernel), softcap (:75-76) and sliding window (page skip :59-61,
// mask :80-84) included, for the bf16 pool (nfai_paged_attention, counter
// paged_attention) and the int8 pool (nfai_paged_attention_i8, counter
// paged_attention_i8).
//
// What bounds it on an H100: bytes. Every valid key and value row of a
// sequence is read once (2 * lengths[b] * D * 2 bytes per kv head); the
// arithmetic is ~4 flops per byte, far under the card's ~295 flops/byte
// ridge.
//
// Design: one block per (kv head, batch row); the r = Hq/Hkv query heads of
// the group share each K/V load (GQA). The TPU kernel walks the pages as a
// sequential grid axis, with the page id prefetched as a scalar into the
// BlockSpec index map and pages past the length skipped; here a block walks
// only the tiles below lengths[b] (the same page skip) and loads its own
// row of the table. Sixteen warps (eight at D = 256) take 32-key tiles in
// turn. In
// a tile each lane owns one key: it looks up the key's page in the table,
// reads the key's head row and computes the r scores against the scaled
// queries kept in shared memory; the warp runs the online-softmax update,
// and for P @ V lane l owns dims (2l, 2l+1) and reads each value row (its
// pool offset shuffled from the lane that owns the key) as one coalesced
// 128-byte line. Keys past lengths[b] (the ragged last page) are masked.
// The warps' (max, sum, acc) states merge through shared memory, the acc
// buffer (64 KB at D = 128 or 256, r = 8) in dynamic shared memory, as in
// K2. r in {1, 2, 3, 4, 8}, any page size; D = 64, 128 or 256, a template
// parameter, as in K2: at D = 128 a key row is 256 bytes and lane l owns
// dims 4l..4l+3, at D = 256 dims 8l..8l+7 with eight warps, and D = 64 does
// the arithmetic it did before. Page ids outside [0, P) are clamped into
// the pool, as XLA clamps a gather index. A split over S for small
// B * Hkv (flash-decoding) is later work.
//
// Softcap and sliding window as in K2 (EXT, a template flag; tanhf on the
// score after the scale and the k scale, before the softmax): a window
// w > 0 keeps the keys lengths[b] - w <= s < lengths[b] (the current token
// is the last of them); the 32-key tiles wholly before it are never
// visited, so their pages are not read, and in the first visited tile the
// keys before it are masked and their values not loaded.
//
// int8 pool: kp/vp hold int8 codes and ks/vs the per-(kv head, token) f32
// scales [Hkv, P, ps], found through the same table: a lane reads the scale
// at (h, page, slot) beside its key row (D bytes), puts the k scale
// on its score and, after the online-softmax update, the v scale on its
// weight for the accumulator only (the denominator sums unscaled weights),
// as the JAX kernel does (nfai_tpu/ops/paged_attention.py:70-93). There is
// no new-token fold: the current token was written to the pool, quantized,
// before the call. Bound: bytes, keys * Hkv * (2 * D + 8), half the bf16
// stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;

// warps per block: 16, or 8 at D = 256 (as in K2)
template <int D>
struct Warps {
  static constexpr int N = D == 256 ? 8 : 16;
};

__device__ __forceinline__ void bf16x8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// 16 int8 codes of a uint4, as floats
__device__ __forceinline__ void i8x16(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xFFu));
}

// sc[j] = qs[j] . row for a bf16 key row of D dims
template <int D, int R>
__device__ __forceinline__ void scores(const __nv_bfloat16* row, const float (*qs)[D], float* sc) {
  const uint4* k4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    float kf[8];
    bf16x8(__ldg(k4 + c), kf);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float a = sc[j];
#pragma unroll
      for (int i = 0; i < 8; ++i) a = fmaf(qs[j][c * 8 + i], kf[i], a);
      sc[j] = a;
    }
  }
}

// the same for an int8 key row (codes; the caller applies the scale)
template <int D, int R>
__device__ __forceinline__ void scores(const int8_t* row, const float (*qs)[D], float* sc) {
  const uint4* k4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    float kf[16];
    i8x16(__ldg(k4 + c), kf);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float a = sc[j];
#pragma unroll
      for (int i = 0; i < 16; ++i) a = fmaf(qs[j][c * 16 + i], kf[i], a);
      sc[j] = a;
    }
  }
}

// lane l's DL = D / 32 consecutive dims of an int8 value row, as floats
template <int D>
__device__ __forceinline__ void load_dims(const int8_t* row, int lane, float* v) {
  if constexpr (D == 64) {
    const char2 c = reinterpret_cast<const char2*>(row)[lane];
    v[0] = c.x;
    v[1] = c.y;
  } else if constexpr (D == 128) {
    const char4 c = reinterpret_cast<const char4*>(row)[lane];
    v[0] = c.x;
    v[1] = c.y;
    v[2] = c.z;
    v[3] = c.w;
  } else {
    const uint2 u = reinterpret_cast<const uint2*>(row)[lane];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = static_cast<float>(static_cast<int8_t>(((i < 4 ? u.x : u.y) >> (8 * (i & 3))) & 0xFFu));
  }
}

// lane l's DL = D / 32 consecutive dims of a value row, as floats
template <int D>
__device__ __forceinline__ void load_dims(const __nv_bfloat16* row, int lane, float* v) {
  if constexpr (D == 64) {
    const __nv_bfloat162 v2 = reinterpret_cast<const __nv_bfloat162*>(row)[lane];
    v[0] = __low2float(v2);
    v[1] = __high2float(v2);
  } else if constexpr (D == 128) {
    const uint2 u = reinterpret_cast<const uint2*>(row)[lane];
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xFFFF0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xFFFF0000u);
  } else {
    bf16x8(reinterpret_cast<const uint4*>(row)[lane], v);
  }
}

// KV: the pool element, __nv_bfloat16 or int8_t (then ks/vs are read);
// EXT: softcap (> 0) and window (> 0) are read
template <int D, int R, typename KV, bool EXT>
__global__ void __launch_bounds__(Warps<D>::N * 32)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q,   // [B, Hq, D]
                  const KV* __restrict__ kp,             // [Hkv, P, ps, D]
                  const KV* __restrict__ vp,
                  const float* __restrict__ ks,          // [Hkv, P, ps] (int8 only)
                  const float* __restrict__ vs,
                  const int* __restrict__ tables,        // [B, max_pages]
                  const int* __restrict__ lengths,       // [B]
                  __nv_bfloat16* __restrict__ out,       // [B, Hq, D]
                  int n_pages, int ps, int max_pages, int hkv, float scale, float softcap,
                  int window) {
  constexpr bool Q = std::is_same<KV, int8_t>::value;
  constexpr int DL = D / 32, WARPS = Warps<D>::N;
  __shared__ float qs[R][D];
  __shared__ float wm_s[WARPS][R], wl_s[WARPS][R];
  extern __shared__ float wacc[];  // [WARPS][R][D]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hq = hkv * R;
  for (int e = tid; e < R * D; e += WARPS * 32) {
    const int j = e / D, d = e % D;
    qs[j][d] = __bfloat162float(q[((size_t)b * hq + h * R + j) * D + d]) * scale;
  }
  __syncthreads();

  const int cap = max_pages * ps;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int n_tiles = (len + 31) / 32;
  // the first visible key: s >= len - window
  int lo = 0;
  if constexpr (EXT)
    if (window > 0) lo = max(len - window, 0);
  const float inv_cap = EXT && softcap > 0.f ? 1.f / softcap : 0.f;
  const int* trow = tables + (size_t)b * max_pages;
  const size_t head_rows = (size_t)h * n_pages * ps;  // first pool row of kv head h

  float m_run[R], l_run[R], acc[R][DL];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    m_run[j] = NEG;
    l_run[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[j][i] = 0.f;
  }

  for (int t = lo / 32 + warp; t < n_tiles; t += WARPS) {
    const int s = t * 32 + lane;
    const bool valid = s < len && (!EXT || s >= lo);
    int row = 0;  // the key's row within kv head h's [P * ps] pool rows
    float sc[R];
    float vsc = 1.f;  // this lane's value scale (int8 pool)
#pragma unroll
    for (int j = 0; j < R; ++j) sc[j] = 0.f;
    if (valid) {
      int page = __ldg(trow + s / ps);
      page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
      row = page * ps + s % ps;
      scores<D, R>(kp + (head_rows + row) * D, qs, sc);
      if constexpr (Q) {
        const float ksc = __ldg(ks + head_rows + row);
        vsc = __ldg(vs + head_rows + row);
#pragma unroll
        for (int j = 0; j < R; ++j) sc[j] *= ksc;
      }
      if constexpr (EXT)
        if (inv_cap > 0.f) {
#pragma unroll
          for (int j = 0; j < R; ++j) sc[j] = softcap * tanhf(sc[j] * inv_cap);
        }
    }
    float p[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float mx = valid ? sc[j] : NEG;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[j], mx);
      const float corr = __expf(m_run[j] - m_new);
      p[j] = valid ? __expf(sc[j] - m_new) : 0.f;
      float psum = p[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run[j] = l_run[j] * corr + psum;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[j][i] *= corr;
      m_run[j] = m_new;
      if constexpr (Q) p[j] *= vsc;  // after the denominator: the accumulator's weight only
    }
    const int n_in = min(32, len - t * 32);
    const int i0 = EXT ? max(0, lo - t * 32) : 0;  // keys before the window: not loaded
    for (int i = i0; i < n_in; ++i) {
      const int row_i = __shfl_sync(0xffffffffu, row, i);
      float v[DL];
      load_dims<D>(vp + (head_rows + row_i) * D, lane, v);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p[j], i);
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[j][e] = fmaf(pj, v[e], acc[j][e]);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      wm_s[warp][j] = m_run[j];
      wl_s[warp][j] = l_run[j];
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < DL; ++i) wacc[(warp * R + j) * D + DL * lane + i] = acc[j][i];
  __syncthreads();
  for (int e = tid; e < R * D; e += WARPS * 32) {
    const int j = e / D, d = e % D;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm_s[w][j]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = __expf(wm_s[w][j] - mx);
      num += wacc[(w * R + j) * D + d] * f;
      den += wl_s[w][j] * f;
    }
    out[((size_t)b * hq + h * R + j) * D + d] = __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

template <int D, int R, typename KV, bool EXT>
int launch_r(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
             const void* tables, const void* lengths, void* out, int B, int hkv, int n_pages,
             int ps, int max_pages, float scale, float softcap, int window, cudaStream_t st) {
  constexpr int warps = Warps<D>::N;
  constexpr int smem = warps * R * D * (int)sizeof(float);
  // once per instantiation: D = 128 or 256 at r = 8 is above the default 48 KB
  static const cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<D, R, KV, EXT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attn_kernel<D, R, KV, EXT><<<dim3(hkv, B), warps * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), n_pages, ps, max_pages, hkv, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename KV, bool EXT>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
           const void* tables, const void* lengths, void* out, int B, int hkv, int r,
           int n_pages, int ps, int max_pages, float scale, float softcap, int window,
           cudaStream_t st) {
#define NFAI_LAUNCH(RR)                                                                        \
  return launch_r<D, RR, KV, EXT>(q, kp, vp, ks, vs, tables, lengths, out, B, hkv, n_pages, ps, \
                                  max_pages, scale, softcap, window, st)
  switch (r) {
    case 1: NFAI_LAUNCH(1);
    case 2: NFAI_LAUNCH(2);
    case 3: NFAI_LAUNCH(3);
    case 4: NFAI_LAUNCH(4);
    case 8: NFAI_LAUNCH(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NFAI_LAUNCH
}

template <typename KV, bool EXT>
int dispatch_d(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
               const void* tables, const void* lengths, void* out, int B, int hkv, int r,
               int n_pages, int ps, int max_pages, int d, float scale, float softcap, int window,
               cudaStream_t st) {
  if (d == 64)
    return launch<64, KV, EXT>(q, kp, vp, ks, vs, tables, lengths, out, B, hkv, r, n_pages, ps,
                               max_pages, scale, softcap, window, st);
  if (d == 128)
    return launch<128, KV, EXT>(q, kp, vp, ks, vs, tables, lengths, out, B, hkv, r, n_pages, ps,
                                max_pages, scale, softcap, window, st);
  if (d == 256)
    return launch<256, KV, EXT>(q, kp, vp, ks, vs, tables, lengths, out, B, hkv, r, n_pages, ps,
                                max_pages, scale, softcap, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename KV>
int dispatch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
             const void* tables, const void* lengths, void* out, int B, int hkv, int r,
             int n_pages, int ps, int max_pages, int d, float scale, float softcap, int window,
             void* stream) {
  if (softcap < 0.f || window < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (softcap > 0.f || window > 0)
    return dispatch_d<KV, true>(q, kp, vp, ks, vs, tables, lengths, out, B, hkv, r, n_pages, ps,
                                max_pages, d, scale, softcap, window, st);
  return dispatch_d<KV, false>(q, kp, vp, ks, vs, tables, lengths, out, B, hkv, r, n_pages, ps,
                               max_pages, d, scale, 0.f, 0, st);
}

}  // namespace

// q [B, Hq, D] bf16, kp/vp [Hkv, P, ps, D] bf16 (one layer's pool),
// tables [B, max_pages] int32, lengths [B] int32, out [B, Hq, D] bf16.
// D in {64, 128, 256}, r = Hq/Hkv in {1, 2, 3, 4, 8}; softcap 0 = none,
// window 0 = unlimited.
extern "C" int nfai_paged_attention(const void* q, const void* kp,
                                    const void* vp, const void* tables,
                                    const void* lengths, void* out, int B,
                                    int hkv, int r, int n_pages, int ps,
                                    int max_pages, int d, float scale, float softcap,
                                    int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, kp, vp, nullptr, nullptr, tables, lengths, out, B, hkv, r,
                                 n_pages, ps, max_pages, d, scale, softcap, window, stream);
}

// The int8 pool: kp/vp [Hkv, P, ps, D] int8 codes, ks/vs [Hkv, P, ps] f32
// scales (one layer's views); the rest as above.
extern "C" int nfai_paged_attention_i8(const void* q, const void* kp,
                                       const void* vp, const void* ks,
                                       const void* vs, const void* tables,
                                       const void* lengths, void* out, int B,
                                       int hkv, int r, int n_pages, int ps,
                                       int max_pages, int d, float scale, float softcap,
                                       int window, void* stream) {
  return dispatch<int8_t>(q, kp, vp, ks, vs, tables, lengths, out, B, hkv, r, n_pages, ps,
                          max_pages, d, scale, softcap, window, stream);
}
