// K3 and K10, redesigned as one K/V store (the device body, its two row
// finders and its design: kv_store.cuh). Four entry points, each with its own
// launch counter in Python:
//
// - nfai_kv_store (ops/kv_store.py `kv_store`): the layer-stacked cache. One
//   launch a decode step stores K and V of all L layers ([L, B, Hkv*D] rows
//   at starts[b]); a prefill chunk's [B, T, Hkv*D] rows of one layer are one
//   launch a layer (L = 1, the layer's view). bf16 rows are copied, or, on
//   the int8 cache, quantized in registers into codes and time-minor scales.
// - nfai_kv_store_paged (`kv_store_paged`): one layer's page pool through the
//   block tables, rows [B, T, Hkv, D] for any T (decode and prefill chunks),
//   bf16 or quantized; one launch a layer.
// - nfai_kv_write (K3's contract, ops/fused_decode.py `write_all_layers`):
//   cache[l, b, starts[b]] = rows[l, b], a row of any multiple of 16 bytes
//   (bf16 rows or int8 codes) copied as it is: the store's copy mode, a warp
//   a 512-byte piece of the row (the whole row where 512 does not divide it).
// - nfai_kv_write_t (K10's contract, `write_all_layers_t`): arr[l, b, h,
//   starts[b]] = rows[l, b, h] for the f32 time-minor scales [L, B, H, S]: the
//   copy mode with rows of no bytes and a scale source, one thread a scale.
//
// K3 replaced nfai_tpu/ops/fused_decode.py::write_all_layers (_write_kernel),
// which rewrote the 8-row sublane tile around each row because a TPU kernel
// cannot store one sublane; K10 replaced write_all_layers_t, which rewrote the
// 128-lane tile around each scale. A GPU stores one row or one float, so each
// item writes exactly its row and its scale and nothing else is touched.
// Positions outside the cache (starts[b] + t outside [0, S), a page outside
// [0, P)) are dropped.
#include "kv_store.cuh"

// kc/vc [L, B, S, H*D] (bf16, or int8 codes with ks/vs [L, B, H, S] f32), k/v
// bf16 rows: item (l, b, t) at k + l*k_sl + b*k_sb + t*k_st (elements), the H
// heads of D contiguous; starts [B] int32. quant != 0: the int8 cache.
extern "C" int nfai_kv_store(void* kc, void* vc, void* ks, void* vs, const void* k, const void* v, int k_sl,
                             int k_sb, int k_st, int v_sl, int v_sb, int v_st, const void* starts, int L, int B,
                             int T, int S, int H, int D, int quant, void* stream) {
  StoreArgs a{};
  a.src[0] = static_cast<const uint8_t*>(k);
  a.src[1] = static_cast<const uint8_t*>(v);
  a.dst[0] = static_cast<uint8_t*>(kc);
  a.dst[1] = static_cast<uint8_t*>(vc);
  a.sdst[0] = static_cast<float*>(ks);
  a.sdst[1] = static_cast<float*>(vs);
  const long long e = sizeof(__nv_bfloat16);
  a.sl[0] = k_sl * e, a.sb[0] = k_sb * e, a.st[0] = k_st * e;
  a.sl[1] = v_sl * e, a.sb[1] = v_sb * e, a.st[1] = v_st * e;
  a.head = D * static_cast<int>(e);
  a.dst_row = quant ? D : a.head;
  a.chunks = a.head / 16;
  a.n_src = 2, a.L = L, a.B = B, a.T = T, a.H = H;
  const StoreStacked find{static_cast<const int*>(starts), B, S, H};
  return kv_store_heads(a, find, D, quant != 0, static_cast<cudaStream_t>(stream));
}

// kp/vp [H, P, ps, D] (one layer: bf16, or int8 codes with ks/vs [H, P, ps]
// f32), k/v bf16 [B, T, H, D] rows: item (b, t) at k + b*k_sb + t*k_st
// (elements); tables [B, max_pages] and positions [B, T] int32.
extern "C" int nfai_kv_store_paged(void* kp, void* vp, void* ks, void* vs, const void* k, const void* v, int k_sb,
                                   int k_st, int v_sb, int v_st, const void* tables, const void* positions, int B,
                                   int T, int H, int D, int n_pages, int ps, int max_pages, int quant,
                                   void* stream) {
  StoreArgs a{};
  a.src[0] = static_cast<const uint8_t*>(k);
  a.src[1] = static_cast<const uint8_t*>(v);
  a.dst[0] = static_cast<uint8_t*>(kp);
  a.dst[1] = static_cast<uint8_t*>(vp);
  a.sdst[0] = static_cast<float*>(ks);
  a.sdst[1] = static_cast<float*>(vs);
  const long long e = sizeof(__nv_bfloat16);
  a.sb[0] = k_sb * e, a.st[0] = k_st * e;
  a.sb[1] = v_sb * e, a.st[1] = v_st * e;
  a.head = D * static_cast<int>(e);
  a.dst_row = quant ? D : a.head;
  a.chunks = a.head / 16;
  a.n_src = 2, a.L = 1, a.B = B, a.T = T, a.H = H;
  const StorePaged find{static_cast<const int*>(tables), static_cast<const int*>(positions), T, max_pages, n_pages,
                        ps};
  return kv_store_heads(a, find, D, quant != 0, static_cast<cudaStream_t>(stream));
}

// K3: cache [L, B, S, row] and rows [L, B, row] of the same element type,
// row_bytes % 16 == 0; starts [B] int32.
extern "C" int nfai_kv_write(void* cache, const void* rows, const void* starts, int L, int B, int S,
                             int row_bytes, void* stream) {
  // a row as pieces of 512 bytes (a warp's 16-byte copies) where they divide
  // it, so that a wide row spreads over warps; else one warp a row
  const int piece = row_bytes % 512 == 0 ? 512 : row_bytes;
  StoreArgs a{};
  a.src[0] = static_cast<const uint8_t*>(rows);
  a.dst[0] = static_cast<uint8_t*>(cache);
  a.sl[0] = (long long)B * row_bytes, a.sb[0] = row_bytes;
  a.head = piece, a.dst_row = piece;
  a.chunks = piece / 16;
  a.n_src = 1, a.L = L, a.B = B, a.T = 1, a.H = row_bytes / piece;
  const StoreStacked find{static_cast<const int*>(starts), B, S, a.H};
  return kv_store_launch<false, 32>(a, find, static_cast<cudaStream_t>(stream));
}

// K10: arr [L, B, H, S] f32, rows [L, B, H] f32, starts [B] int32.
extern "C" int nfai_kv_write_t(void* arr, const void* rows, const void* starts, int L, int B, int H, int S,
                               void* stream) {
  StoreArgs a{};
  a.src[0] = static_cast<const uint8_t*>(rows);  // no row bytes: only the scale is read
  a.ssrc[0] = static_cast<const float*>(rows);
  a.sdst[0] = static_cast<float*>(arr);
  a.n_src = 1, a.L = L, a.B = B, a.T = 1, a.H = H;
  const StoreStacked find{static_cast<const int*>(starts), B, S, H};
  return kv_store_launch<false, 1>(a, find, static_cast<cudaStream_t>(stream));
}
