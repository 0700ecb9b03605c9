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
// Design: decode_attn.cuh's split body (K2 runs the same one): the keys of
// each (batch row, kv head) across a cluster of c blocks (c from the grid:
// `decode_split`, with the capacity max_pages * ps), 64-key K/V tiles by
// cp.async into a ring, both products on tensor cores, the partials merged
// through distributed shared memory. Here a key's row is found through the
// table: key s is row page * ps + s % ps of kv head h's [P * ps] pool rows,
// page = tables[b, s / ps] clamped into [0, P) (as XLA clamps a gather
// index) before any address is formed. A 64-key tile spans 64 / ps pages at
// ps < 64 (four at ps = 16) and half a page at ps = 128; each key's row is
// looked up one tile ahead of its copy (the lookups of tile i + STAGES are
// in flight while tile i is multiplied), so a page change costs no stall.
// The TPU kernel walks the pages as a sequential grid axis with the page id
// prefetched as a scalar; here the blocks of a cluster take the row's tiles
// in runs and read only tiles below lengths[b] (the same page skip), the
// ragged last page's keys zero-filled and masked. Key lengths[b] - 1 (the
// current token) is the body's last key, merged after the tiles as K2
// merges its new token: the paged and the dense decode give the same bits. 1 <= r <= 16,
// page sizes 16/32/64/128, D = 64, 96, 128 or 256.
//
// Softcap and sliding window as in K2 (EXT, a template flag; tanhf on the
// score after the scale and the k scale, before the softmax): a window
// w > 0 keeps the keys lengths[b] - w <= s < lengths[b] (the current token
// is the last of them); the tiles wholly before it are never visited, so
// their pages are not read, and in the first visited tile the keys before
// it are zero-filled, not loaded.
//
// int8 pool: kp/vp hold int8 codes and ks/vs the per-(kv head, token) f32
// scales [Hkv, P, ps], found through the same table (one float a pool row):
// the k scale goes on the score and, after the denominator took the
// unscaled p, the v scale on p, as the JAX kernel does
// (nfai_tpu/ops/paged_attention.py:70-93). There is no new-token fold: the
// current token was written to the pool, quantized, before the call.
// Bound: bytes, keys * Hkv * (2 * D + 8), half the bf16 stream.
#include "decode_attn.cuh"

namespace {

// key s of a (batch row, kv head): its page through the row's table
template <typename KV>
struct PageRows {
  const KV* k;
  const KV* v;
  const float* ks;
  const float* vs;
  int pitch;
  const int* table;
  int n_pages, ps;
  __device__ __forceinline__ int row(int s) const {
    int page = __ldg(table + s / ps);
    page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
    return page * ps + s % ps;
  }
};

// KV: the pool element, __nv_bfloat16 or int8_t (then ks/vs are read);
// EXT: softcap (> 0) and window (> 0) are read; c: the blocks of a cluster
template <int D, typename KV, bool EXT, int HG>
__global__ void __launch_bounds__(DA_THREADS)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q,   // [B, Hq, D]
                  const KV* __restrict__ kp,             // [Hkv, P, ps, D]
                  const KV* __restrict__ vp,
                  const float* __restrict__ ks,          // [Hkv, P, ps] (int8 only)
                  const float* __restrict__ vs,
                  const int* __restrict__ tables,        // [B, max_pages]
                  const int* __restrict__ lengths,       // [B]
                  __nv_bfloat16* __restrict__ out,       // [B, Hq, D]
                  int n_pages, int ps, int max_pages, int hkv, int r, float scale, float softcap,
                  int window, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x / c, b = blockIdx.y;
  const int cap = max_pages * ps;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  int lo = 0;  // the first visible key: s >= len - window
  if constexpr (EXT)
    if (window > 0) lo = max(len - window, 0);
  const size_t head = (size_t)h * n_pages * ps;  // kv head h's first pool row
  const PageRows<KV> rows{kp + head * D, vp + head * D, ks ? ks + head : nullptr, vs ? vs + head : nullptr, D,
                          tables + (size_t)b * max_pages, n_pages, ps};
  // the last key, lengths[b] - 1 (the current token), as K2's new token: merged after the tiles
  LastKey<KV> last{nullptr, nullptr, 1.f, 1.f};
  if (len > 0) {
    const int row = rows.row(len - 1);
    last = {rows.k + (size_t)row * D, rows.v + (size_t)row * D, ks ? rows.ks[row] : 1.f, vs ? rows.vs[row] : 1.f};
  }
  const size_t qo = ((size_t)b * hkv + h) * r * D;
  decode_attn_body<D, KV, EXT, HG>(rows, last, q + qo, out + qo, r, lo, len > 0 ? len - 1 : 0, scale, softcap, c,
                               smem);
}

template <int D, typename KV, bool EXT, int HG>
int launch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs, const void* tables,
           const void* lengths, void* out, int B, int hkv, int r, int n_pages, int ps, int max_pages, float scale,
           float softcap, int window, int c, cudaStream_t st) {
  constexpr int smem = DaShape<D, std::is_same<KV, int8_t>::value, HG>::SMEM;
  const auto kernel = paged_attn_kernel<D, KV, EXT, HG>;
  static const cudaError_t attr = da_attributes(kernel, smem);  // once per instantiation
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kpp = static_cast<const KV*>(kp);
  const auto* vpp = static_cast<const KV*>(vp);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* tp = static_cast<const int*>(tables);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (c == 1) {
    kernel<<<dim3(hkv, B), DA_THREADS, smem, st>>>(qp, kpp, vpp, ksp, vsp, tp, lp, op, n_pages, ps, max_pages,
                                                   hkv, r, scale, softcap, window, 1);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t lerr = launch_clustered(kernel, dim3(hkv * c, B), DA_THREADS, smem, c, st, qp, kpp, vpp, ksp,
                                            vsp, tp, lp, op, n_pages, ps, max_pages, hkv, r, scale, softcap,
                                            window, c);
  return static_cast<int>(lerr != cudaSuccess ? lerr : cudaGetLastError());
}

template <typename KV, bool EXT>
int dispatch_d(const void* q, const void* kp, const void* vp, const void* ks, const void* vs, const void* tables,
               const void* lengths, void* out, int B, int hkv, int r, int n_pages, int ps, int max_pages, int d,
               float scale, float softcap, int window, int c, cudaStream_t st) {
#define NFAI_LAUNCH(DD, HG)                                                                                  \
  return launch<DD, KV, EXT, HG>(q, kp, vp, ks, vs, tables, lengths, out, B, hkv, r, n_pages, ps, max_pages, \
                                 scale, softcap, window, c, st)
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
int dispatch(const void* q, const void* kp, const void* vp, const void* ks, const void* vs, const void* tables,
             const void* lengths, void* out, int B, int hkv, int r, int n_pages, int ps, int max_pages, int d,
             float scale, float softcap, int window, int c, void* stream) {
  const auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  if (softcap < 0.f || window < 0 || r < 1 || r > 16 || !da_valid_split(c) || n_pages <= 0 || ps <= 0 ||
      misaligned(q) || misaligned(kp) || misaligned(vp) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || hkv <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (softcap > 0.f || window > 0)
    return dispatch_d<KV, true>(q, kp, vp, ks, vs, tables, lengths, out, B, hkv, r, n_pages, ps, max_pages, d,
                                scale, softcap, window, c, st);
  return dispatch_d<KV, false>(q, kp, vp, ks, vs, tables, lengths, out, B, hkv, r, n_pages, ps, max_pages, d,
                               scale, 0.f, 0, c, st);
}

}  // namespace

// q [B, Hq, D] bf16, kp/vp [Hkv, P, ps, D] bf16 (one layer's pool),
// tables [B, max_pages] int32, lengths [B] int32, out [B, Hq, D] bf16;
// 16-byte aligned. D in {64, 96, 128, 256}, r = Hq/Hkv in 1..16; softcap 0 =
// none, window 0 = unlimited; c the blocks a (row, kv head) pair's keys are
// split across (1, 2, 4, 8 or 16: `decode_split`).
extern "C" int nfai_paged_attention(const void* q, const void* kp, const void* vp, const void* tables,
                                    const void* lengths, void* out, int B, int hkv, int r, int n_pages, int ps,
                                    int max_pages, int d, float scale, float softcap, int window, int c,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, kp, vp, nullptr, nullptr, tables, lengths, out, B, hkv, r, n_pages, ps,
                                 max_pages, d, scale, softcap, window, c, stream);
}

// The int8 pool: kp/vp [Hkv, P, ps, D] int8 codes, ks/vs [Hkv, P, ps] f32
// scales (one layer's views); the rest as above.
extern "C" int nfai_paged_attention_i8(const void* q, const void* kp, const void* vp, const void* ks,
                                       const void* vs, const void* tables, const void* lengths, void* out, int B,
                                       int hkv, int r, int n_pages, int ps, int max_pages, int d, float scale,
                                       float softcap, int window, int c, void* stream) {
  return dispatch<int8_t>(q, kp, vp, ks, vs, tables, lengths, out, B, hkv, r, n_pages, ps, max_pages, d, scale,
                          softcap, window, c, stream);
}
