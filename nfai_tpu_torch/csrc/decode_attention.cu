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
// Design: decode_attn.cuh's split body (K7 runs the same one), the keys of
// each (batch row, kv head) across a cluster of c blocks (c from the grid:
// `decode_split`), 64-key K/V tiles by cp.async into a ring, both products
// on tensor cores, the partials merged through distributed shared memory.
// Here a key's row is its cache slot: key s of row b, kv head h is
// kc[b, s, h*D : (h+1)*D] (rows Hkv*D elements apart), visible for
// lo <= s < starts[b]. Key index starts[b], the new token, is not in the
// cache: it is the body's last key (k_new/v_new at full precision, no int8
// scale), merged after the blocks' partials, so every block streams cache
// rows only; K7 takes its row's last key the same way, so the dense and
// the paged decode give the same bits on the same keys. With a window, tiles wholly before lo are never read and the
// first visited tile's keys before lo are zero-filled, not loaded.
// 1 <= r <= 16 (a run-time value: the products take 8 head columns, or 16
// in two groups past r = 8, zero past r); D = 64, 96, 128 or 256, a
// template parameter.
//
// Softcap and sliding window (EXT, a template flag: the Llama and Qwen
// launches compile none of it, as the JAX kernel makes `windowed` and
// `softcap` static): the score of each key, after the scale and (int8) the
// k scale, becomes softcap * tanhf(score / softcap) before the online
// softmax; the new token's too. A window w > 0 (per layer, at run time;
// 0 = unlimited) keeps the old keys s > starts[b] - w and the new token.
//
// int8 cache (nfai_decode_attention_i8, launch counter decode_attention_i8):
// kc/vc hold int8 codes and ks/vs the per-(kv head, token) f32 scales of the
// layer, [B, Hkv, S] (time-minor), as the JAX kernel's k_scales/v_scales.
// The codes come into the ring (half the bytes), with each key's two scales
// beside them; the k scale goes on the score, the v scale on p after the
// denominator took the unscaled p (nfai_tpu/ops/fused_decode.py:116-151).
// The new token comes from the bf16 k_new/v_new at factor 1 (it is
// quantized for storage after the layer loop). Bound: bytes, B * keys * Hkv
// * (2 * D + 8), about half the bf16 stream.
#include "decode_attn.cuh"

namespace {

// key s of a (batch row, kv head) is row s of its cache rows
template <typename KV>
struct CacheRows {
  const KV* k;
  const KV* v;
  const float* ks;
  const float* vs;
  int pitch;
  __device__ __forceinline__ int row(int s) const { return s; }
};

// KV: the cache element, __nv_bfloat16 or int8_t (then ks/vs are read);
// EXT: softcap (> 0) and window (> 0) are read; c: the blocks of a cluster
template <int D, typename KV, bool EXT, int HG>
__global__ void __launch_bounds__(DA_THREADS)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hq, D]
                   const __nv_bfloat16* __restrict__ k_new,  // [B, KVD]
                   const __nv_bfloat16* __restrict__ v_new,
                   const KV* __restrict__ kc,                // [B, S, KVD]
                   const KV* __restrict__ vc,
                   const float* __restrict__ ks,             // [B, Hkv, S] (int8 only)
                   const float* __restrict__ vs,
                   const int* __restrict__ starts,           // [B]
                   __nv_bfloat16* __restrict__ out,          // [B, Hq, D]
                   int S, int hkv, int r, float scale, float softcap, int window, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x / c, b = blockIdx.y;
  const int kvd = hkv * D;
  const int start = starts[b];
  const int n_old = start < S ? (start < 0 ? 0 : start) : S;
  int lo = 0;  // the first visible old key: s > start - window
  if constexpr (EXT)
    if (window > 0) lo = min(max(start - window + 1, 0), n_old);
  const size_t head = (size_t)b * S * kvd + h * D, srow = ((size_t)b * hkv + h) * S;
  const CacheRows<KV> rows{kc + head, vc + head, ks ? ks + srow : nullptr, vs ? vs + srow : nullptr, kvd};
  const size_t qo = ((size_t)b * hkv + h) * r * D, no = (size_t)b * kvd + h * D;
  const LastKey<__nv_bfloat16> last{k_new + no, v_new + no, 1.f, 1.f};  // the new token, at full precision
  decode_attn_body<D, KV, EXT, HG>(rows, last, q + qo, out + qo, r, lo, n_old, scale, softcap, c, smem);
}

template <int D, typename KV, bool EXT, int HG>
int launch(const void* q, const void* k_new, const void* v_new, const void* kc, const void* vc,
           const void* ks, const void* vs, const void* starts, void* out, int B, int S, int hkv, int r,
           float scale, float softcap, int window, int c, cudaStream_t st) {
  constexpr int smem = DaShape<D, std::is_same<KV, int8_t>::value, HG>::SMEM;
  const auto kernel = decode_attn_kernel<D, KV, EXT, HG>;
  static const cudaError_t attr = da_attributes(kernel, smem);  // once per instantiation
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* knp = static_cast<const __nv_bfloat16*>(k_new);
  const auto* vnp = static_cast<const __nv_bfloat16*>(v_new);
  const auto* kcp = static_cast<const KV*>(kc);
  const auto* vcp = static_cast<const KV*>(vc);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* stp = static_cast<const int*>(starts);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (c == 1) {
    kernel<<<dim3(hkv, B), DA_THREADS, smem, st>>>(qp, knp, vnp, kcp, vcp, ksp, vsp, stp, op, S, hkv, r, scale,
                                                   softcap, window, 1);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t lerr = launch_clustered(kernel, dim3(hkv * c, B), DA_THREADS, smem, c, st, qp, knp, vnp, kcp,
                                            vcp, ksp, vsp, stp, op, S, hkv, r, scale, softcap, window, c);
  return static_cast<int>(lerr != cudaSuccess ? lerr : cudaGetLastError());
}

template <typename KV, bool EXT>
int dispatch_d(const void* q, const void* k_new, const void* v_new, const void* kc, const void* vc,
               const void* ks, const void* vs, const void* starts, void* out, int B, int S, int hkv, int r,
               int d, float scale, float softcap, int window, int c, cudaStream_t st) {
#define NFAI_LAUNCH(DD, HG)                                                                              \
  return launch<DD, KV, EXT, HG>(q, k_new, v_new, kc, vc, ks, vs, starts, out, B, S, hkv, r, scale, softcap, \
                                 window, c, st)
  // one group of 8 head columns for r <= 8, two for 9 <= r <= 16
#define NFAI_LAUNCH_D(DD)     \
  if (d == DD) {              \
    if (r > 8) NFAI_LAUNCH(DD, 2); \
    NFAI_LAUNCH(DD, 1);       \
  }
  NFAI_LAUNCH_D(64)
  NFAI_LAUNCH_D(96)
  NFAI_LAUNCH_D(128)
  NFAI_LAUNCH_D(256)
#undef NFAI_LAUNCH_D
#undef NFAI_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename KV>
int dispatch(const void* q, const void* k_new, const void* v_new, const void* kc, const void* vc,
             const void* ks, const void* vs, const void* starts, void* out, int B, int S, int hkv, int r,
             int d, float scale, float softcap, int window, int c, void* stream) {
  const auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  if (softcap < 0.f || window < 0 || r < 1 || r > 16 || !da_valid_split(c) || misaligned(q) ||
      misaligned(k_new) || misaligned(v_new) || misaligned(kc) || misaligned(vc) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || hkv <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (softcap > 0.f || window > 0)
    return dispatch_d<KV, true>(q, k_new, v_new, kc, vc, ks, vs, starts, out, B, S, hkv, r, d, scale, softcap,
                                window, c, st);
  return dispatch_d<KV, false>(q, k_new, v_new, kc, vc, ks, vs, starts, out, B, S, hkv, r, d, scale, 0.f, 0, c,
                               st);
}

}  // namespace

// q [B, Hq, D], k_new/v_new [B, Hkv*D], kc/vc [B, S, Hkv*D] (one layer),
// starts [B] int32, out [B, Hq, D]; all bf16 except starts, 16-byte
// aligned. D in {64, 96, 128, 256}, r = Hq/Hkv in 1..16; softcap 0 = none,
// window 0 = unlimited; c the blocks a (row, kv head) pair's keys are
// split across (1, 2, 4, 8 or 16: `decode_split`).
extern "C" int nfai_decode_attention(const void* q, const void* k_new, const void* v_new, const void* kc,
                                     const void* vc, const void* starts, void* out, int B, int S, int hkv,
                                     int r, int d, float scale, float softcap, int window, int c,
                                     void* stream) {
  return dispatch<__nv_bfloat16>(q, k_new, v_new, kc, vc, nullptr, nullptr, starts, out, B, S, hkv, r, d,
                                 scale, softcap, window, c, stream);
}

// The int8 cache: kc/vc [B, S, Hkv*D] int8 codes, ks/vs [B, Hkv, S] f32
// scales (one layer's views); q, k_new, v_new and out bf16 as above.
extern "C" int nfai_decode_attention_i8(const void* q, const void* k_new, const void* v_new, const void* kc,
                                        const void* vc, const void* ks, const void* vs, const void* starts,
                                        void* out, int B, int S, int hkv, int r, int d, float scale,
                                        float softcap, int window, int c, void* stream) {
  return dispatch<int8_t>(q, k_new, v_new, kc, vc, ks, vs, starts, out, B, S, hkv, r, d, scale, softcap, window,
                          c, stream);
}
