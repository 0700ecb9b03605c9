// The K/V store: the one device body through which every new K/V row reaches
// a cache (kv_write.cu's four entry points). It replaces the JAX package's
// write_all_layers (K3, nfai_tpu/ops/fused_decode.py:601) and
// write_all_layers_t (K10, :659), and takes over from the plain PyTorch glue
// around them: quantize_kv (nfai_tpu/models/llama.py:230), write_paged and
// write_paged_scales (nfai_tpu/runtime/paged_cache.py:199, :219) and the
// prefill's _write_cache (nfai_tpu/models/llama.py:945).
//
// An item is one (K or V, layer l, batch row b, token t, kv head h) row. A
// group of G lanes (G divides 32, aligned in the warp) stores it in one of
// two modes:
// - copy: the row's `chunks` 16-byte pieces are copied as they are (lane i
//   takes pieces i, i + G, ...), and, where a scale source is given, lane 0
//   copies the item's f32 scale (K10's contract: rows of no bytes);
// - quantize (G = D / 8, or 16 for D = 96: lanes 12-15 load nothing, add
//   0 to the amax and store nothing): each lane loads 8 bf16 values as one
//   16-byte vector, the group's amax meets by __shfl_xor_sync, scale =
//   fmaxf(amax, 1e-20) / 127 and q = clamp(rint(x / scale), -127, 127) with
//   IEEE division (__fdiv_rn: no reciprocal, no fast division) and rounding
//   half to even, so the codes and scales are the bits of the JAX and the
//   port's plain `quantize_kv` on the CPU. Each lane stores its 8 codes (8
//   bytes), lane 0 the scale.
//
// Where a row goes is a finder's business (`find(l, b, t, h, row, srow)`:
// false drops the item):
// - StoreStacked, the layer-stacked cache [L, B, S, Hkv, D] (the merged-lane
//   [L, B, S, Hkv*D]) with time-minor scales [L, B, Hkv, S]: token t of row
//   b goes to position starts[b] + t, dropped outside [0, S);
// - StorePaged, one layer's pool [Hkv, P, ps, D] with scales [Hkv, P, ps]:
//   token t of row b goes to page tables[b, positions[b, t] / ps], slot
//   positions[b, t] % ps; a position outside [0, max_pages * ps) or a page
//   outside [0, P) drops it.
// Starts, positions and tables are read on the device; the grid depends only
// on the shapes, so nothing is read back on the host.
//
// What bounds it on an H100: bytes (each new row read once, its codes or row
// and its scale written once: ~128 KB for a batch-8 decode step of the 1B's
// 16 layers) and, far above that, the launch (~0.003-0.006 ms). The design
// therefore does all of a step's stores in one launch: K and V of every
// layer (dense decode), or of one layer (a prefill chunk, the paged pool),
// with the quantization in registers instead of nine PyTorch kernels and
// their intermediates in device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS_THREADS = 256;

// the layer-stacked cache: row index in units of a head row, scale index in floats
struct StoreStacked {
  const int* starts;  // [B]
  int B, S, H;
  __device__ __forceinline__ bool find(int l, int b, int t, int h, size_t& row, size_t& srow) const {
    const int pos = __ldg(starts + b) + t;
    if (pos < 0 || pos >= S) return false;
    const size_t lb = (size_t)l * B + b;
    row = (lb * S + pos) * H + h;
    srow = (lb * H + h) * S + pos;
    return true;
  }
};

// one layer's page pool through the block tables
struct StorePaged {
  const int* tables;     // [B, max_pages]
  const int* positions;  // [B, T]
  int T, max_pages, n_pages, ps;
  __device__ __forceinline__ bool find(int, int b, int t, int h, size_t& row, size_t& srow) const {
    const int pos = __ldg(positions + (size_t)b * T + t);
    if (pos < 0 || pos >= max_pages * ps) return false;
    const int page = __ldg(tables + (size_t)b * max_pages + pos / ps);
    if (page < 0 || page >= n_pages) return false;
    row = srow = ((size_t)h * n_pages + page) * ps + pos % ps;
    return true;
  }
};

// what a launch stores: n_src sources (K, then V), each L x B x T x H items;
// item (l, b, t, h) of source s reads src[s] + l * sl[s] + b * sb[s] + t * st[s]
// + h * head (bytes) and writes its row at dst[s] + row * dst_row, its scale
// at sdst[s][srow]
struct StoreArgs {
  const uint8_t* src[2];
  const float* ssrc[2];  // copy mode: scales [L, B, T, H] to copy (nullptr: none)
  uint8_t* dst[2];
  float* sdst[2];        // nullptr: no scale
  long long sl[2], sb[2], st[2];
  int head, dst_row, chunks;
  int n_src, L, B, T, H;
};

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t kv_code(float x, float scale) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f));
}

// the body: every thread is lane (gid % G) of item gid / G. Index math is
// 32-bit (the launch refuses grids of 2^31 threads or more): a 64-bit
// division is a long software routine, and a step's few thousand items pay
// it on the critical path. The source row is loaded before the finder reads
// its index (starts / positions / tables), so the two reads overlap.
template <bool QUANT, int G, typename Find>
__device__ __forceinline__ void kv_store_body(const StoreArgs& a, const Find& find) {
  const unsigned gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(gid % G);
  const unsigned per_src = static_cast<unsigned>(a.L * a.B * a.T * a.H);
  unsigned item = gid / G;
  const bool valid = item < per_src * a.n_src;
  if (!valid) item = 0;  // quantize: the lanes past the end still take part in the shuffles
  const bool v = item >= per_src;  // the source: K (false) or V
  const unsigned i = v ? item - per_src : item;  // ((l * B + b) * T + t) * H + h
  const int h = static_cast<int>(i % a.H);
  unsigned r = i / a.H;
  const int t = static_cast<int>(r % a.T);
  r /= a.T;
  const int b = static_cast<int>(r % a.B);
  const int l = static_cast<int>(r / a.B);
  // the source's fields by select, not by a dynamic index into the parameter arrays (local memory)
  const uint8_t* src = (v ? a.src[1] : a.src[0]) + l * (v ? a.sl[1] : a.sl[0]) + b * (v ? a.sb[1] : a.sb[0]) +
                       t * (v ? a.st[1] : a.st[0]) + (long long)h * a.head;
  uint8_t* dst = v ? a.dst[1] : a.dst[0];
  float* sdst = v ? a.sdst[1] : a.sdst[0];
  const uint4* from = reinterpret_cast<const uint4*>(src);
  uint4 u = make_uint4(0, 0, 0, 0);  // quantize: the lane's 8 values; copy: its first piece
  if (valid && lane < a.chunks) u = __ldg(from + lane);
  size_t row = 0, srow = 0;
  const bool keep = valid && find.find(l, b, t, h, row, srow);
  if constexpr (QUANT) {
    float x[8];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
      m = fmaxf(m, fmaxf(fabsf(x[2 * j]), fabsf(x[2 * j + 1])));
    }
    m = group_max<G>(m);
    if (!keep) return;
    const float scale = __fdiv_rn(fmaxf(m, 1e-20f), 127.f);
    uint32_t packed[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) word |= (uint32_t)(uint8_t)kv_code(x[4 * j + k], scale) << (8 * k);
      packed[j] = word;
    }
    if (lane < a.chunks) reinterpret_cast<uint2*>(dst + row * a.dst_row)[lane] = make_uint2(packed[0], packed[1]);
    if (lane == 0) sdst[srow] = scale;
  } else {
    if (!keep) return;
    uint4* to = reinterpret_cast<uint4*>(dst + row * a.dst_row);
    if (lane < a.chunks) to[lane] = u;
    for (int c = lane + G; c < a.chunks; c += G) to[c] = __ldg(from + c);
    const float* ssrc = v ? a.ssrc[1] : a.ssrc[0];
    if (lane == 0 && ssrc != nullptr) sdst[srow] = __ldg(ssrc + i);
  }
}

template <bool QUANT, int G, typename Find>
__global__ void __launch_bounds__(KS_THREADS) kv_store_kernel(const StoreArgs a, const Find find) {
  kv_store_body<QUANT, G, Find>(a, find);
}

// one launch of every item of `a` (n_src * L * B * T * H of them, G lanes each)
template <bool QUANT, int G, typename Find>
int kv_store_launch(const StoreArgs& a, const Find& find, cudaStream_t stream) {
  const long long threads = (long long)a.n_src * a.L * a.B * a.T * a.H * G;
  if (threads == 0) return 0;
  if (threads >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);  // the body's 32-bit index math
  const unsigned blocks = static_cast<unsigned>((threads + KS_THREADS - 1) / KS_THREADS);
  kv_store_kernel<QUANT, G, Find><<<blocks, KS_THREADS, 0, stream>>>(a, find);
  return static_cast<int>(cudaGetLastError());
}

// the quantizing and the copying store of D-wide head rows (G = D / 8 lanes,
// one 16-byte piece each; D = 96 takes G = 16, a group must divide the warp);
// D outside 64 / 96 / 128 / 256 is refused
template <typename Find>
int kv_store_heads(const StoreArgs& a, const Find& find, int D, bool quant, cudaStream_t stream) {
  switch (D) {
    case 64:
      return quant ? kv_store_launch<true, 8>(a, find, stream) : kv_store_launch<false, 8>(a, find, stream);
    case 96:
    case 128:
      return quant ? kv_store_launch<true, 16>(a, find, stream) : kv_store_launch<false, 16>(a, find, stream);
    case 256:
      return quant ? kv_store_launch<true, 32>(a, find, stream) : kv_store_launch<false, 32>(a, find, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
