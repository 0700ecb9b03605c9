// K4: flash prefill attention over one layer of the merged-lane KV cache,
//     causal by absolute position (the chunk's K/V are already written):
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
// the pallas_call at :414): the K/V tile loads are a template on the
// addressing (HM). "headmajor" reads a [B, Hkv, S, D] cache, a key row at
// ((b * Hkv + h) * S + s) * D (entry points nfai_prefill_attention_hm and
// _hm_i8, their own launch counters); "merged" reads the native merged-lane
// rows one head at a time, which is what every block here already does (one
// block per query tile, kv head and batch row, loading that head's D
// columns of each key row: _prefill_kernel's grid over the merged BlockSpec
// (bb, kk, h)), so it launches this merged-lane instance, counted under its
// own variant label by the wrapper. A head-major K or V tile is one
// contiguous 64 * D * 2-byte run (a TMA candidate; later work).
//
// What bounds it on an H100: operations once T is large (4*T*span*D flops
// per head against one read of the span's K/V); at T = 16 bytes.
//
// Design: one block per (64-row query tile, kv head, batch row). The r query
// heads of the kv head are packed into the rows (row i = token i / r,
// head i % r), so each K/V tile is loaded once for the whole GQA group;
// a tile holds 64 / r tokens, and where r does not divide 64 (r = 3 at
// Llama-3.2-3B) its last 64 mod r rows are padding: zero queries, never
// written.
// Per 64-key tile: K and V go to shared memory as bf16, S = Q K^T on tensor
// cores (WMMA bf16, f32 accumulate), then an online-softmax pass (two
// threads per row, 32 keys each) writes P as bf16 over the K tile, and P V
// runs on tensor cores again; at D = 64 and 128 the f32 output rows (D/2
// dims per thread) live in registers and are rescaled per tile. At D = 256
// (every Gemma) D/2 = 128 floats a thread would spill, so the running output
// stays in an f32 shared tile [64, D]: each thread rescales its half row by
// the tile's correction, then the P V fragments are loaded from it as the
// accumulator, multiplied into and stored back, 64 columns at a time. Key
// tiles wholly in the causal future of the query tile are never visited.
// D = 64, 128 or 256 (a template parameter), r <= 64, S % 64 == 0. The
// tiles sit in dynamic shared memory: 44 KB at D = 64, 84 KB at D = 128 (a
// key row is 256 bytes there), 181 KB at D = 256 (one block per SM), past
// the 48 KB default, so the launcher raises the kernel's limit first;
// D = 64 and 128 run the arithmetic they ran before D = 256 came. Double
// buffering, TMA and wgmma are later work.
//
// Softcap and sliding window (EXT, a template flag: the Llama and Qwen
// launches compile none of it, as the JAX kernel makes them static). The
// score, after the scale (folded into q) and (int8) the k scale, becomes
// softcap * tanhf(score / softcap) before the mask and the online softmax.
// A window w > 0 (per layer, at run time; 0 = unlimited) masks the keys
// s <= qpos - w of each query, and the key tiles wholly before the window
// of the tile's first query are never loaded.
//
// int8 cache (nfai_prefill_attention_i8, counter prefill_attention_i8): kc/vc
// hold int8 codes and ks/vs the layer's per-(kv head, token) f32 scales
// [B, Hkv, S], as the JAX kernel's k_scales/v_scales. The K and V tiles are
// converted to bf16 on their way into shared memory (codes of |q| <= 127 are
// exact in bf16, the JAX `_to_mxu` note), the tile's 64 k and v scales go to
// shared memory beside them, the scores are multiplied by the k scale of
// their column before the online softmax, which sums the unscaled p, and P
// is multiplied by the v scale of its column before it is written as bf16
// over the K tile (nfai_tpu/ops/prefill_attention.py:230-251). The tiles read
// half the bytes of the bf16 cache.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROWS = 64, BS = 64;
constexpr float NEG = -1e30f;

// shared-memory strides (elements) and size at head width D
template <int D>
struct Tiles {
  static constexpr bool OSM = D > 128;                  // the running output in shared memory
  static constexpr int LDH = D + 8;                     // bf16 rows of Q, K|P, V
  static constexpr int LDF = (OSM ? BS : (D > BS ? D : BS)) + 4;  // f32 rows of S (and P V)
  static constexpr int LDO = D + 4;                     // f32 rows of the output (OSM)
  static constexpr size_t BYTES =
      3 * ROWS * LDH * 2 + ROWS * LDF * 4 + (OSM ? ROWS * LDO * 4 : 0);
};

// 16 int8 codes of a uint4 → 16 bf16 at dst (32 bytes, 16-byte aligned)
__device__ __forceinline__ void i8x16_to_bf16(const uint4& u, __nv_bfloat16* dst) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  __align__(16) __nv_bfloat162 h2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a = static_cast<float>(static_cast<int8_t>((w[i >> 1] >> (16 * (i & 1))) & 0xFFu));
    const float b = static_cast<float>(static_cast<int8_t>((w[i >> 1] >> (16 * (i & 1) + 8)) & 0xFFu));
    h2[i] = __floats2bfloat162_rn(a, b);
  }
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(h2)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(h2)[1];
}

// the element offset of key row s of kv head h, batch row b: merged-lane
// rows (b, s, h * D) or head-major rows ((b * Hkv + h) * S + s) * D
template <bool HM, int D>
__device__ __forceinline__ size_t key_offset(int b, int h, int s, int S, int hkv, int kvd) {
  if constexpr (HM) return (((size_t)b * hkv + h) * S + s) * D;
  return ((size_t)b * S + s) * kvd + (size_t)h * D;
}

// KV: the cache element, __nv_bfloat16 or int8_t (then ks/vs are read);
// EXT: softcap (> 0) and window (> 0) are read; HM: the cache is head-major
template <int D, typename KV, bool EXT, bool HM>
__global__ void __launch_bounds__(128)
prefill_attn_kernel(const __nv_bfloat16* __restrict__ q,   // [B, T, Hq, D]
                    const KV* __restrict__ kc,             // [B, S, KVD] ([B, Hkv, S, D] if HM)
                    const KV* __restrict__ vc,
                    const float* __restrict__ ks,          // [B, Hkv, S] (int8 only)
                    const float* __restrict__ vs,
                    const int* __restrict__ offsets,       // [B]
                    __nv_bfloat16* __restrict__ out,       // [B, T, Hq, D]
                    int T, int S, int hkv, int r, float scale, float softcap, int window) {
  using namespace nvcuda;
  constexpr bool Q = std::is_same<KV, int8_t>::value;
  constexpr bool OSM = Tiles<D>::OSM;
  __shared__ float kss[BS], vss[BS];  // the tile's scales (int8 cache)
  constexpr int LDH = Tiles<D>::LDH, LDF = Tiles<D>::LDF, LDO = Tiles<D>::LDO, DH = D / 2;
  extern __shared__ __align__(32) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* KPs = Qs + ROWS * LDH;  // K tile, then P
  __nv_bfloat16* Vs = KPs + BS * LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BS * LDH);  // scores (then P V, below D = 256)
  float* Os = Ss + ROWS * LDF;                          // the running output (D = 256)
  const int tt = ROWS / r;  // tokens per query tile
  const int rows_used = tt * r;  // the rest of the 64 rows are padding
  const int t0 = blockIdx.x * tt, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int hq = hkv * r, kvd = hkv * D;
  const int offset = offsets[b];

  for (int e = tid; e < ROWS * D; e += 128) {
    const int i = e / D, d = e % D, t = t0 + i / r;
    float v = 0.f;
    if (i < rows_used && t < T)
      v = __bfloat162float(q[(((size_t)b * T + t) * hq + h * r + i % r) * D + d]) * scale;
    Qs[i * LDH + d] = __float2bfloat16(v);
  }
  // the row this thread softmaxes / accumulates, and which half of it
  const int row = tid >> 1, half = tid & 1;
  const int qpos = offset + t0 + row / r;
  float m_run = NEG, l_run = 0.f, o[OSM ? 1 : DH];
  if constexpr (OSM) {
#pragma unroll 8
    for (int c = 0; c < DH; ++c) Os[row * LDO + half * DH + c] = 0.f;
  } else {
#pragma unroll
    for (int c = 0; c < DH; ++c) o[c] = 0.f;
  }
  const float inv_cap = EXT && softcap > 0.f ? 1.f / softcap : 0.f;

  const int t_last = min(t0 + tt, T) - 1;
  const int n_tiles = min(S / BS, (offset + t_last) / BS + 1);
  // tiles wholly before the window of the tile's first query are skipped
  int kt0 = 0;
  if constexpr (EXT)
    if (window > 0) kt0 = max(offset + t0 - window + 1, 0) / BS;
  for (int kt = kt0; kt < n_tiles; ++kt) {
    const int s0 = kt * BS;
    if constexpr (Q) {
      for (int e = tid; e < BS * (D / 16); e += 128) {
        const int sr = e / (D / 16), c = (e % (D / 16)) * 16;
        const size_t g = key_offset<HM, D>(b, h, s0 + sr, S, hkv, kvd) + c;
        i8x16_to_bf16(__ldg(reinterpret_cast<const uint4*>(kc + g)), &KPs[sr * LDH + c]);
        i8x16_to_bf16(__ldg(reinterpret_cast<const uint4*>(vc + g)), &Vs[sr * LDH + c]);
      }
      if (tid < BS) {
        const size_t g = ((size_t)b * hkv + h) * S + s0 + tid;
        kss[tid] = __ldg(ks + g);
        vss[tid] = __ldg(vs + g);
      }
    } else {
      for (int e = tid; e < BS * (D / 8); e += 128) {
        const int sr = e / (D / 8), c = (e % (D / 8)) * 8;
        const size_t g = key_offset<HM, D>(b, h, s0 + sr, S, hkv, kvd) + c;
        *reinterpret_cast<uint4*>(&KPs[sr * LDH + c]) = __ldg(reinterpret_cast<const uint4*>(kc + g));
        *reinterpret_cast<uint4*>(&Vs[sr * LDH + c]) = __ldg(reinterpret_cast<const uint4*>(vc + g));
      }
    }
    __syncthreads();
    {  // S = Q K^T: warp w owns rows [16w, 16w + 16)
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BS / 16];
#pragma unroll
      for (int j = 0; j < BS / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, &Qs[warp * 16 * LDH + kk], LDH);
#pragma unroll
        for (int j = 0; j < BS / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, &KPs[j * 16 * LDH + kk], LDH);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BS / 16; ++j)
        wmma::store_matrix_sync(&Ss[warp * 16 * LDF + j * 16], acc[j], LDF, wmma::mem_row_major);
    }
    __syncthreads();
    float corr;
    {  // online softmax over this thread's 32 keys of its row
      float sv[BS / 2], mx = NEG;
#pragma unroll
      for (int c = 0; c < BS / 2; ++c) {
        const int s = s0 + half * (BS / 2) + c;
        float x = Ss[row * LDF + half * (BS / 2) + c];
        if constexpr (Q) x *= kss[half * (BS / 2) + c];  // the k scale of the column
        if constexpr (EXT) {
          if (inv_cap > 0.f) x = softcap * tanhf(x * inv_cap);
          sv[c] = s <= qpos && (window <= 0 || s > qpos - window) ? x : -INFINITY;
        } else {
          sv[c] = s <= qpos ? x : -INFINITY;
        }
        mx = fmaxf(mx, sv[c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);
      corr = __expf(m_run - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < BS / 2; ++c) {
        const float p = __expf(sv[c] - m_new);
        ps += p;  // the denominator takes the unscaled p, P the v scale of its column
        KPs[row * LDH + half * (BS / 2) + c] = __float2bfloat16(Q ? p * vss[half * (BS / 2) + c] : p);
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      l_run = l_run * corr + ps;
      m_run = m_new;
      if constexpr (OSM) {
#pragma unroll 8
        for (int c = 0; c < DH; ++c) Os[row * LDO + half * DH + c] *= corr;
      }
    }
    __syncthreads();
    if constexpr (OSM) {  // O += P V: warp w owns rows [16w, 16w + 16), 64 columns at a time
#pragma unroll 1
      for (int n0 = 0; n0 < D; n0 += 64) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(acc[j], &Os[warp * 16 * LDO + n0 + j * 16], LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BS; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, &KPs[warp * 16 * LDH + kk], LDH);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, &Vs[kk * LDH + n0 + j * 16], LDH);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::store_matrix_sync(&Os[warp * 16 * LDO + n0 + j * 16], acc[j], LDO, wmma::mem_row_major);
      }
    } else {  // P V: warp w owns rows [16w, 16w + 16), all D dims
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < BS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, &KPs[warp * 16 * LDH + kk], LDH);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, &Vs[kk * LDH + j * 16], LDH);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        wmma::store_matrix_sync(&Ss[warp * 16 * LDF + j * 16], acc[j], LDF, wmma::mem_row_major);
    }
    __syncthreads();
    if constexpr (!OSM) {
#pragma unroll
      for (int c = 0; c < DH; ++c) o[c] = o[c] * corr + Ss[row * LDF + half * DH + c];
    }
    __syncthreads();
  }

  const int t = t0 + row / r;
  if (row < rows_used && t < T) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    __nv_bfloat16* dst = out + (((size_t)b * T + t) * hq + h * r + row % r) * D + half * DH;
    if constexpr (OSM) {
#pragma unroll 8
      for (int c = 0; c < DH; ++c) dst[c] = __float2bfloat16(Os[row * LDO + half * DH + c] * inv);
    } else {
#pragma unroll
      for (int c = 0; c < DH; ++c) dst[c] = __float2bfloat16(o[c] * inv);
    }
  }
}

template <int D, typename KV, bool EXT, bool HM>
int launch(const void* q, const void* kc, const void* vc, const void* ks, const void* vs,
           const void* offsets, void* out, int B, int T, int S, int hkv, int r, float scale,
           float softcap, int window, cudaStream_t st) {
  constexpr size_t smem = Tiles<D>::BYTES;
  if constexpr (smem > 48 * 1024) {  // once per process: above the default limit
    static const cudaError_t err = cudaFuncSetAttribute(
        prefill_attn_kernel<D, KV, EXT, HM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tt = ROWS / r;
  dim3 grid((T + tt - 1) / tt, hkv, B), block(128);
  prefill_attn_kernel<D, KV, EXT, HM><<<grid, block, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kc),
      static_cast<const KV*>(vc), static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(out), T, S, hkv, r, scale,
      softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, bool EXT, bool HM>
int dispatch_d(const void* q, const void* kc, const void* vc, const void* ks, const void* vs,
               const void* offsets, void* out, int B, int T, int S, int hkv, int r, int d,
               float scale, float softcap, int window, cudaStream_t st) {
  if (d == 64)
    return launch<64, KV, EXT, HM>(q, kc, vc, ks, vs, offsets, out, B, T, S, hkv, r, scale, softcap,
                               window, st);
  if (d == 128)
    return launch<128, KV, EXT, HM>(q, kc, vc, ks, vs, offsets, out, B, T, S, hkv, r, scale, softcap,
                                window, st);
  if (d == 256)
    return launch<256, KV, EXT, HM>(q, kc, vc, ks, vs, offsets, out, B, T, S, hkv, r, scale, softcap,
                                window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename KV, bool HM>
int dispatch(const void* q, const void* kc, const void* vc, const void* ks, const void* vs,
             const void* offsets, void* out, int B, int T, int S, int hkv, int r, int d,
             float scale, float softcap, int window, void* stream) {
  if (r <= 0 || r > ROWS || S % BS != 0 || softcap < 0.f || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (softcap > 0.f || window > 0)
    return dispatch_d<KV, true, HM>(q, kc, vc, ks, vs, offsets, out, B, T, S, hkv, r, d, scale,
                                softcap, window, st);
  return dispatch_d<KV, false, HM>(q, kc, vc, ks, vs, offsets, out, B, T, S, hkv, r, d, scale, 0.f,
                               0, st);
}

}  // namespace

// q/out [B, T, Hkv*r, D], kc/vc [B, S, Hkv*D] (one layer), offsets [B]
// int32; bf16 except offsets. D in {64, 128, 256}; needs r <= 64 and
// S % 64 == 0; softcap 0 = none, window 0 = unlimited.
extern "C" int nfai_prefill_attention(const void* q, const void* kc,
                                      const void* vc, const void* offsets,
                                      void* out, int B, int T, int S, int hkv,
                                      int r, int d, float scale, float softcap,
                                      int window, void* stream) {
  return dispatch<__nv_bfloat16, false>(q, kc, vc, nullptr, nullptr, offsets, out, B, T, S, hkv,
                                        r, d, scale, softcap, window, stream);
}

// The int8 cache: kc/vc [B, S, Hkv*D] int8 codes, ks/vs [B, Hkv, S] f32
// scales (one layer's views); the rest as above.
extern "C" int nfai_prefill_attention_i8(const void* q, const void* kc,
                                         const void* vc, const void* ks,
                                         const void* vs, const void* offsets,
                                         void* out, int B, int T, int S, int hkv,
                                         int r, int d, float scale, float softcap,
                                         int window, void* stream) {
  return dispatch<int8_t, false>(q, kc, vc, ks, vs, offsets, out, B, T, S, hkv, r, d, scale,
                                 softcap, window, stream);
}

// kv_layout "headmajor": kc/vc [B, Hkv, S, D] bf16; the rest as
// nfai_prefill_attention.
extern "C" int nfai_prefill_attention_hm(const void* q, const void* kc,
                                         const void* vc, const void* offsets,
                                         void* out, int B, int T, int S, int hkv,
                                         int r, int d, float scale, float softcap,
                                         int window, void* stream) {
  return dispatch<__nv_bfloat16, true>(q, kc, vc, nullptr, nullptr, offsets, out, B, T, S, hkv,
                                       r, d, scale, softcap, window, stream);
}

// kv_layout "headmajor" on the int8 cache: kc/vc [B, Hkv, S, D] int8 codes,
// ks/vs [B, Hkv, S] f32 scales; the rest as nfai_prefill_attention_i8.
extern "C" int nfai_prefill_attention_hm_i8(const void* q, const void* kc,
                                            const void* vc, const void* ks,
                                            const void* vs, const void* offsets,
                                            void* out, int B, int T, int S, int hkv,
                                            int r, int d, float scale, float softcap,
                                            int window, void* stream) {
  return dispatch<int8_t, true>(q, kc, vc, ks, vs, offsets, out, B, T, S, hkv, r, d, scale,
                                softcap, window, stream);
}
