// K2: decode attention of one new token per row against one layer of the
//     merged-lane KV cache, with the new K/V row folded in (not yet written).
//
//   out[b, h*r + j, :] = softmax_s(cap(q[b, h*r+j] . k_s * scale)) @ v_s
//   over s in cache[b, lo:starts[b]] (head h's D columns) and the new row,
//   where lo = 0, or starts[b] - window + 1 with a sliding window, and
//   cap(x) = softcap * tanh(x / softcap) where a softcap is given.
//
// Replaces nfai_tpu/ops/fused_decode.py::layered_decode_attention_slab
// (_fused_slab_kernel) and its fallback ::layered_decode_attention
// (_fused_kernel): same function, softcap and sliding window included
// (the gemma2/3 paths: softcap :128-129, window skip :104-106 and mask
// :130-134). The layer index is a pointer offset on the GPU, so the wrapper
// passes cache[layer] ([B, S, Hkv*D] bf16).
//
// What bounds it on an H100: bytes. Every visible old key and value of a row
// is read once (2 * keys * D * 2 bytes per kv head); the arithmetic is ~4
// flops per byte, far under the card's ~295 flops/byte ridge.
//
// Design: one block per (kv head, batch row); the r = Hq/Hkv query heads of
// the group share each K/V load (GQA). Sixteen warps (eight at D = 256) take
// 32-key tiles in turn. In a tile each lane owns one key: it reads the key's
// head slice and computes the r scores against the scaled queries kept in
// shared memory; the warp then runs the online-softmax update, and for P @ V
// lane l owns dims (2l, 2l+1) and reads each value row as one coalesced
// 128-byte line. Key index starts[b] is the new token, read from
// k_new/v_new. The warps' (max, sum, acc) states merge through shared
// memory; the acc buffer (WARPS * r * D floats, 64 KB at D = 128, r = 8 and
// at D = 256, r = 8) is dynamic shared memory, its limit raised once per
// instantiation.
// r in {1, 2, 3, 4, 8} (3: Llama-3.2-3B, 8: Gemma 2B's multi-query heads);
// D = 64, 128 or 256, a template parameter. At D = 128 a key row is 256
// bytes and lane l owns dims 4l..4l+3 in P @ V (one 8-byte load per lane
// and value row); at D = 256 (every Gemma) dims 8l..8l+7 (one 16-byte
// load), and the block runs eight warps so that a thread may hold the r x 8
// accumulators (64 at r = 8) in registers; D = 64 does the arithmetic it did
// before the head width became a parameter.
// Splitting long rows across blocks (flash-decoding) is later work.
//
// Softcap and sliding window (EXT, a template flag: the Llama and Qwen
// launches compile none of it, as the JAX kernel makes `windowed` and
// `softcap` static). The score of each key, after the scale and (int8) the
// k scale, becomes softcap * tanhf(score / softcap) (tanhf, not an
// approximation) before the online softmax; the new token's score too. A
// window w > 0 (per layer, at run time; 0 = unlimited) keeps the old keys
// s > starts[b] - w and the new token: the tiles wholly before that are
// never visited, so none of their bytes are read, and in the first visited
// tile the keys before it are masked and their values not loaded.
//
// int8 cache (nfai_decode_attention_i8, launch counter decode_attention_i8):
// kc/vc hold int8 codes and ks/vs the per-(kv head, token) f32 scales of the
// layer, [B, Hkv, S] (time-minor), as the JAX kernel's k_scales/v_scales.
// The scale factors out of the D contraction, so a lane reads its int8 key
// row (64, 128 or 256 bytes, 16-byte loads), multiplies the dot by
// ks[b, h, s] (32 lanes read 32 consecutive floats), and after the
// online-softmax update multiplies its weight by vs[b, h, s] for the
// accumulator only: the denominator sums the unscaled weights
// (nfai_tpu/ops/fused_decode.py:116-151, the int8 branch of _fused_kernel /
// _fused_slab_kernel). A lane owns 2 (D = 64), 4 (D = 128) or 8 (D = 256)
// bytes of each int8 value row. The new token still comes from the bf16
// k_new/v_new at factor 1 (it is quantized for storage after the layer
// loop). Bound: bytes, B * keys * Hkv * (2 * D + 8), about half the bf16
// stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;

// warps per block: 16, or 8 at D = 256 (a thread then holds 8 dims of each
// of the r accumulators, and may use up to 255 registers)
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

// KV: the cache element, __nv_bfloat16 or int8_t (then ks/vs are read);
// EXT: softcap (> 0) and window (> 0) are read
template <int D, int R, typename KV, bool EXT>
__global__ void __launch_bounds__(Warps<D>::N * 32)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hq, D]
                   const __nv_bfloat16* __restrict__ k_new,  // [B, KVD]
                   const __nv_bfloat16* __restrict__ v_new,
                   const KV* __restrict__ kc,                // [B, S, KVD]
                   const KV* __restrict__ vc,
                   const float* __restrict__ ks,             // [B, Hkv, S] (int8 only)
                   const float* __restrict__ vs,
                   const int* __restrict__ starts,           // [B]
                   __nv_bfloat16* __restrict__ out,          // [B, Hq, D]
                   int S, int hkv, float scale, float softcap, int window) {
  constexpr bool Q = std::is_same<KV, int8_t>::value;
  constexpr int DL = D / 32, WARPS = Warps<D>::N;
  __shared__ float qs[R][D];
  __shared__ float wm_s[WARPS][R], wl_s[WARPS][R];
  extern __shared__ float wacc[];  // [WARPS][R][D]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvd = hkv * D, hq = hkv * R;
  for (int e = tid; e < R * D; e += WARPS * 32) {
    const int j = e / D, d = e % D;
    qs[j][d] = __bfloat162float(q[((size_t)b * hq + h * R + j) * D + d]) * scale;
  }
  __syncthreads();

  int start = starts[b];
  const int n_old = start < S ? (start < 0 ? 0 : start) : S;
  const int n_keys = n_old + 1;  // old tokens + the new one
  const int n_tiles = (n_keys + 31) / 32;
  // the first visible key: old keys s > start - window, the new one always
  int lo = 0;
  if constexpr (EXT)
    if (window > 0) lo = min(max(start - window + 1, 0), n_old);
  const float inv_cap = EXT && softcap > 0.f ? 1.f / softcap : 0.f;

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
    const bool valid = s < n_keys && (!EXT || s >= lo);
    float sc[R];
    float vsc = 1.f;  // this lane's value scale (int8 cache, old keys)
#pragma unroll
    for (int j = 0; j < R; ++j) sc[j] = 0.f;
    if (valid) {
      if constexpr (Q) {
        if (s < n_old) {
          scores<D, R>(kc + ((size_t)b * S + s) * kvd + h * D, qs, sc);
          const size_t si = ((size_t)b * hkv + h) * S + s;
          const float ksc = __ldg(ks + si);
          vsc = __ldg(vs + si);
#pragma unroll
          for (int j = 0; j < R; ++j) sc[j] *= ksc;
        } else {
          scores<D, R>(k_new + (size_t)b * kvd + h * D, qs, sc);
        }
      } else {
        const __nv_bfloat16* krow = s < n_old
            ? kc + ((size_t)b * S + s) * kvd + h * D
            : k_new + (size_t)b * kvd + h * D;
        scores<D, R>(krow, qs, sc);
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
      float ps = p[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run[j] = l_run[j] * corr + ps;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[j][i] *= corr;
      m_run[j] = m_new;
      if constexpr (Q) p[j] *= vsc;  // after the denominator: the accumulator's weight only
    }
    const int n_in = min(32, n_keys - t * 32);
    const int i0 = EXT ? max(0, lo - t * 32) : 0;  // keys before the window: not loaded
    for (int i = i0; i < n_in; ++i) {
      const int si = t * 32 + i;
      float v[DL];
      if constexpr (Q) {
        if (si < n_old)
          load_dims<D>(vc + ((size_t)b * S + si) * kvd + h * D, lane, v);
        else
          load_dims<D>(v_new + (size_t)b * kvd + h * D, lane, v);
      } else {
        const __nv_bfloat16* vrow = si < n_old
            ? vc + ((size_t)b * S + si) * kvd + h * D
            : v_new + (size_t)b * kvd + h * D;
        load_dims<D>(vrow, lane, v);
      }
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
int launch_r(const void* q, const void* k_new, const void* v_new, const void* kc,
             const void* vc, const void* ks, const void* vs, const void* starts, void* out,
             int B, int S, int hkv, float scale, float softcap, int window, cudaStream_t st) {
  constexpr int warps = Warps<D>::N;
  constexpr int smem = warps * R * D * (int)sizeof(float);
  // once per instantiation: D = 128 or 256 at r = 8 is above the default 48 KB
  static const cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<D, R, KV, EXT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attn_kernel<D, R, KV, EXT><<<dim3(hkv, B), warps * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const KV*>(kc),
      static_cast<const KV*>(vc), static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(starts), static_cast<__nv_bfloat16*>(out), S, hkv, scale, softcap,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename KV, bool EXT>
int launch(const void* q, const void* k_new, const void* v_new, const void* kc,
           const void* vc, const void* ks, const void* vs, const void* starts, void* out,
           int B, int S, int hkv, int r, float scale, float softcap, int window, cudaStream_t st) {
#define NFAI_LAUNCH(RR)                                                                        \
  return launch_r<D, RR, KV, EXT>(q, k_new, v_new, kc, vc, ks, vs, starts, out, B, S, hkv, scale, \
                                  softcap, window, st)
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
int dispatch_d(const void* q, const void* k_new, const void* v_new, const void* kc,
               const void* vc, const void* ks, const void* vs, const void* starts, void* out,
               int B, int S, int hkv, int r, int d, float scale, float softcap, int window,
               cudaStream_t st) {
  if (d == 64)
    return launch<64, KV, EXT>(q, k_new, v_new, kc, vc, ks, vs, starts, out, B, S, hkv, r, scale,
                               softcap, window, st);
  if (d == 128)
    return launch<128, KV, EXT>(q, k_new, v_new, kc, vc, ks, vs, starts, out, B, S, hkv, r, scale,
                                softcap, window, st);
  if (d == 256)
    return launch<256, KV, EXT>(q, k_new, v_new, kc, vc, ks, vs, starts, out, B, S, hkv, r, scale,
                                softcap, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename KV>
int dispatch(const void* q, const void* k_new, const void* v_new, const void* kc,
             const void* vc, const void* ks, const void* vs, const void* starts, void* out,
             int B, int S, int hkv, int r, int d, float scale, float softcap, int window,
             void* stream) {
  if (softcap < 0.f || window < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (softcap > 0.f || window > 0)
    return dispatch_d<KV, true>(q, k_new, v_new, kc, vc, ks, vs, starts, out, B, S, hkv, r, d,
                                scale, softcap, window, st);
  return dispatch_d<KV, false>(q, k_new, v_new, kc, vc, ks, vs, starts, out, B, S, hkv, r, d,
                               scale, 0.f, 0, st);
}

}  // namespace

// q [B, Hq, D], k_new/v_new [B, Hkv*D], kc/vc [B, S, Hkv*D] (one layer),
// starts [B] int32, out [B, Hq, D]; all bf16 except starts. D in {64, 128,
// 256}, r = Hq/Hkv in {1, 2, 3, 4, 8}; softcap 0 = none, window 0 =
// unlimited.
extern "C" int nfai_decode_attention(const void* q, const void* k_new,
                                     const void* v_new, const void* kc,
                                     const void* vc, const void* starts,
                                     void* out, int B, int S, int hkv, int r,
                                     int d, float scale, float softcap, int window,
                                     void* stream) {
  return dispatch<__nv_bfloat16>(q, k_new, v_new, kc, vc, nullptr, nullptr, starts, out, B, S,
                                 hkv, r, d, scale, softcap, window, stream);
}

// The int8 cache: kc/vc [B, S, Hkv*D] int8 codes, ks/vs [B, Hkv, S] f32
// scales (one layer's views); q, k_new, v_new and out bf16 as above.
extern "C" int nfai_decode_attention_i8(const void* q, const void* k_new,
                                        const void* v_new, const void* kc,
                                        const void* vc, const void* ks,
                                        const void* vs, const void* starts,
                                        void* out, int B, int S, int hkv, int r,
                                        int d, float scale, float softcap, int window,
                                        void* stream) {
  return dispatch<int8_t>(q, k_new, v_new, kc, vc, ks, vs, starts, out, B, S, hkv, r, d, scale,
                          softcap, window, stream);
}
