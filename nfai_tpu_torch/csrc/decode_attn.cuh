// The device body that K2 (decode_attention.cu: the merged-lane cache and the
// new token) and K7 (paged_attention.cu: the page pool through a block
// table) share: one query token of r heads against the visible keys of one
// (batch row, kv head), split across a thread-block cluster: the keys
// [lo, hi) in tiles, then the row's last key (the current token: K2's new
// token from k_new/v_new, K7's key lengths[b] - 1 from its page) as one
// more partial. The two kernels differ only in how key s's row is found (a
// `Rows` policy) and where the last key comes from; on the same keys and c
// they give the same bits (paged and dense decode agree exactly).
//
// What bounds it on an H100: bytes (each visible K and V row read once;
// ~4 flops a byte against the card's ~295). So the design is about bytes in
// flight and SM coverage:
// - Split: the (row, kv head) pair's keys go to a cluster of c blocks
//   (c = 1, 2, 4 or 8, chosen by the wrapper from the grid alone:
//   `decode_split` in ops/fused_decode.py; 16, non-portable, is taken too
//   and measured slower: 16 free SMs of one GPC are scarcer than 8). Each
//   block reads lengths / starts from device memory and takes its share of
//   the visible range in whole 64-key tiles (`da_share` below; mirrored by
//   `decode_share` in Python): no host read, so a CUDA graph can capture
//   the launch. A block with no tile contributes m = -1e30, l = 0.
// - Ring: four warps, each of which issues its share of the 16-byte
//   cp.async copies of a tile's K and V rows (one row address a key: the
//   policy's row index, computed for tile i + STAGES while tile i is
//   multiplied, so K7's table lookups hide behind the products) into a
//   ring of STAGES stages (4 at D = 64 and 96, 3 at D = 128 bf16 and 4
//   int8, 3 at D = 256: 34-207 KB a block; at D = 256 three ran 3-7% faster than two,
//   six at D = 64 and four at D = 128 slower than these). Keys outside
//   [lo, hi) are zero-filled (cp.async with no source bytes): a masked
//   key's value is 0, never a stale NaN. cp.async and not TMA: one row
//   address a key serves the merged-lane rows and the pages alike, and the
//   host encodes no tensor map a launch.
// - Products on tensor cores (mma.sync m16n8k16, bf16 in, f32 sums), each
//   warp on 16 keys of the tile: S^T [16 keys, 8 heads] = K Q^T, the heads
//   as N in HG groups of 8 (a template parameter: HG = 1 for r <= 8, 2 for
//   9 <= r <= 16; each group shares the key fragments and the V tile's
//   ldmatrix, and the heads past r are zero queries whose outputs are never
//   written). Lane (g, t) reads 16 bytes of
//   key rows g and g + 8 (chunk 4p + t of the row) and uses them as the A
//   fragments of KPC = 16 / (4 * bytes an element) k16 steps: the D order
//   inside a product is free, so slots (2t, 2t + 1, 2t + 8, 2t + 9) of
//   step (p, j) are dims 4j..4j + 3 of the chunk (int8: dims (4j, 4j + 2),
//   (4j + 1, 4j + 3), the exact bf16 of the codes by two lop3 and a packed
//   subtract), and the queries' B fragments are loaded once in the same
//   order. The K tile's 16-byte chunks are stored at chunk ^ 4 on odd rows
//   (conflict-free reads). D = 96: a bf16 row is 12 chunks (three quads of
//   lanes, six k16 steps), an int8 row 6 (the second quad's lanes t >= 2
//   feed zero A and B fragments: eight k16 steps, two of them zero).
// - The online softmax on S's fragments: lane (g, t) holds keys g, g + 8
//   and heads 2t, 2t + 1; scale, int8 k scale, softcap (tanhf), the mask;
//   the max over the warp's keys by three shuffles; p summed unscaled, then
//   the int8 v scale on p.
// - O^T [D, 8 heads] += V^T P^T: A = V^T by ldmatrix.trans from the V tile
//   (chunk ^ (row & 7): conflict-free), B = P^T: S's fragment pairs rounded
//   to bf16 and transposed by movmatrix. An int8 V tile is first turned
//   into bf16 rows by its warp (16 rows a warp, its own buffer).
// - Merge: the four warps' (m, l, O) meet in the block's shared memory, then
//   the cluster's blocks through distributed shared memory: rank k merges
//   a k-th share of the r x D outputs over the ranks in rank order, the
//   last key after them (its score q . k in f32, its value unrounded). No
//   atomics, no scratch in global memory: the same bits on every launch.
#pragma once

#include "sm90.cuh"

namespace {

constexpr int DA_KEYS = 64;   // keys a tile, 16 a warp
constexpr int DA_WARPS = 4;
constexpr int DA_THREADS = DA_WARPS * 32;
constexpr int DA_MAX_SPLIT = 16;
constexpr float DA_NEG = -1e30f;

template <int D, bool Q8, int HG>
struct DaShape {
  static constexpr int NH = 8 * HG;                // head columns of the products (r <= NH)
  static constexpr int RB = D * (Q8 ? 1 : 2);      // bytes of a K or V row
  static constexpr int NC = RB / 16;               // 16-byte chunks a row
  static constexpr int NP = (NC + 3) / 4;          // chunk quads a row (int8 D = 96: the last is half)
  static constexpr int KPC = Q8 ? 4 : 2;           // k16 steps a chunk
  static constexpr int TILE = DA_KEYS * RB;        // a K or V tile
  static constexpr int STAGE = 2 * TILE + (Q8 ? 2 * DA_KEYS * 4 : 0);  // + the k and v scales
  static constexpr int STAGES = D == 256 ? 3 : (D == 128 && !Q8 ? 3 : 4);
  static constexpr int CONV = Q8 ? DA_WARPS * 16 * D * 2 : 0;  // each warp's V rows as bf16
  static constexpr int ROWS_OFF = STAGES * STAGE + CONV;       // the ring of key rows
  static constexpr int LAST_OFF = ROWS_OFF + STAGES * DA_KEYS * 4;  // the last key's scores [NH]
  static constexpr int LQ_OFF = LAST_OFF + NH * 4;                  // the query rows [NH][D] bf16
  static constexpr int LK_OFF = LQ_OFF + NH * D * 2;                // the last key's K row (bf16 room)
  static constexpr int LV_OFF = LK_OFF + D * 2;                     // and its V row
  static constexpr int SMEM = LV_OFF + D * 2;
  // the merge reuses the stages: (m, l) and O of four warps, then the block's
  static constexpr int WACC_OFF = 2 * DA_WARPS * NH * 4;
  static constexpr int PART_OFF = WACC_OFF + DA_WARPS * NH * D * 4;
  static_assert(PART_OFF + 2 * NH * 4 + NH * D * 4 <= STAGES * STAGE, "merge buffers");
  static_assert(D % 32 == 0 && NC % 2 == 0, "head width");
};

// byte offset of 16-byte chunk ch of row `key` in a K tile (odd rows: ch ^ 4)
// (rows of a multiple of 8 chunks; at 12 or 6 chunks, D = 96, rows g and g +
// 1 already fall on the two halves of the 128-byte bank line)
template <int NC>
__device__ __forceinline__ int k_off(int key, int ch) {
  return key * NC * 16 + 16 * (NC % 8 == 0 ? ch ^ ((key & 1) << 2) : ch);
}

// the same in a bf16 V tile: ch ^ (row & 7), for ldmatrix; a row of 12
// chunks (D = 96) swizzles its first 8 so and its last 4 by ch ^ (row & 3)
template <int NC>
__device__ __forceinline__ int v_off(int key, int ch) {
  return key * NC * 16 + 16 * (NC % 8 == 0 || ch < (NC & ~7) ? ch ^ (key & 7) : ch ^ (key & 3));
}

// the int8 codes at bits 0-7 and 16-23 of w → their bf16x2, exactly:
// 0x4300 | (b & 0x7F) is 128 + (b & 0x7F), 0x4300 | (b & 0x80) is 128 or
// 256, their difference the signed code (K6's decode)
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w) {
  return bf16x2_sub(lop3_and_or(w, 0x007F007Fu, 0x43004300u), lop3_and_or(w, 0x00800080u, 0x43004300u));
}

// the first and one-past-last tile of block `rank` of `c` over the keys
// [lo, hi): the visible range's 64-key tiles cut into c nearly equal runs
// (ops/fused_decode.py::decode_share is the same rule)
__device__ __forceinline__ int2 da_share(int lo, int hi, int c, int rank) {
  const int t_lo = lo / DA_KEYS, n = max((hi + DA_KEYS - 1) / DA_KEYS - t_lo, 0);
  return make_int2(t_lo + rank * n / c, t_lo + (rank + 1) * n / c);
}

__device__ __forceinline__ float as_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float as_float(int8_t x) { return static_cast<float>(x); }

// The last key: its K and V rows (bf16, or int8 codes) and their scales (1
// for bf16), or k == nullptr where the row has no key.
template <typename T>
struct LastKey {
  const T* k;
  const T* v;
  float ks, vs;
};

// Rows: k, v (key row 0 of the (row, kv head)'s keys), ks, vs (their int8
// scales, one float a row), pitch (elements between rows) and row(s), the
// row index of visible key s.
template <int D, typename KV, bool EXT, int HG, typename Rows, typename KL>
__device__ __forceinline__ void decode_attn_body(const Rows& rows, const LastKey<KL>& last,
                                                 const __nv_bfloat16* __restrict__ q,  // [r, D]
                                                 __nv_bfloat16* __restrict__ out,      // [r, D]
                                                 int r, int lo, int hi, float scale, float softcap, int c,
                                                 unsigned char* smem) {
  namespace cg = cooperative_groups;
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  using L = DaShape<D, Q8, HG>;
  constexpr int STAGES = L::STAGES, NC = L::NC, NP = L::NP, KPC = L::KPC, RB = L::RB, NH = L::NH;
  constexpr int NACC = D / 16 < 4 ? D / 16 : 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rank = c > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int2 tiles = da_share(lo, hi, c, rank);
  const int t0 = tiles.x, nt = tiles.y - tiles.x;
  int* rowbuf = reinterpret_cast<int*>(smem + L::ROWS_OFF);  // [STAGES][DA_KEYS]
  float* slast = reinterpret_cast<float*>(smem + L::LAST_OFF);
  const float inv_cap = EXT && softcap > 0.f ? 1.f / softcap : 0.f;

  // the row of key i of relative tile `it`, or -1 (zero-filled, masked)
  const auto key_row = [&](int it, int i) {
    const int s = (t0 + it) * DA_KEYS + i;
    return it < nt && s >= lo && s < hi ? rows.row(s) : -1;
  };
  // relative tile `it` into stage it % STAGES, its rows from the ring slot of the same index
  const auto load = [&](int it) {
    unsigned char* st = smem + (it % STAGES) * L::STAGE;
    const int* rb = rowbuf + (it % STAGES) * DA_KEYS;
    const char* kb = reinterpret_cast<const char*>(rows.k);
    const char* vb = reinterpret_cast<const char*>(rows.v);
#pragma unroll 4
    for (int e = tid; e < DA_KEYS * NC; e += DA_THREADS) {
      const int key = e / NC, ch = e % NC, row = rb[key];
      const size_t off = static_cast<size_t>(row < 0 ? 0 : row) * rows.pitch * sizeof(KV) + 16 * ch;
      cp_async16_zfill(st + k_off<NC>(key, ch), kb + off, row >= 0);
      cp_async16_zfill(st + L::TILE + (Q8 ? key * RB + 16 * ch : v_off<NC>(key, ch)), vb + off, row >= 0);
    }
    if constexpr (Q8) {  // thread i < 64: key i's k scale; 64 + i: its v scale
      const int row = rb[tid & (DA_KEYS - 1)];
      cp_async4(st + 2 * L::TILE + 4 * tid, (tid < DA_KEYS ? rows.ks : rows.vs) + (row < 0 ? 0 : row), row >= 0);
    }
  };

  if (tid < DA_KEYS) {
#pragma unroll
    for (int it = 0; it < STAGES; ++it) rowbuf[it * DA_KEYS + tid] = key_row(it, tid);
  }
  __syncthreads();
  // the query rows and the last key's rows land with the first tile: its
  // scores are taken from shared memory after the tiles, off the loads' path
  constexpr int NL = D * (int)sizeof(KL) / 16;  // 16-byte chunks of a last-key row
  if (last.k) {
    for (int e = tid; e < r * D / 8; e += DA_THREADS) cp_async16(smem + L::LQ_OFF + 16 * e, q + 8 * e);
    for (int e = tid; e < 2 * NL; e += DA_THREADS) {
      const bool kv = e < NL;
      cp_async16(smem + (kv ? L::LK_OFF + 16 * e : L::LV_OFF + 16 * (e - NL)),
                 reinterpret_cast<const char*>(kv ? last.k : last.v) + 16 * (kv ? e : e - NL));
    }
  }
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < nt) load(it);
    cp_async_commit();
  }

  // the queries' B fragments, in the K fragments' D order: group hg holds
  // heads 8 hg .. 8 hg + 7 (heads >= r: zero; an int8 row of 6 chunks leaves
  // lanes t >= 2 of the second quad zero too)
  uint32_t qf[HG][NP * KPC][2];
#pragma unroll
  for (int hg = 0; hg < HG; ++hg) {
    const int head = 8 * hg + g;
    const __nv_bfloat16* qrow = q + (head < r ? head : 0) * D;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < KPC; ++j) {
        const int d0 = (4 * p + t) * (16 / (int)sizeof(KV)) + 4 * j;
        uint2 v = make_uint2(0u, 0u);
        if (head < r && 4 * p + t < NC) v = __ldg(reinterpret_cast<const uint2*>(qrow + d0));
        qf[hg][KPC * p + j][0] = Q8 ? prmt(v.x, v.y, 0x5410) : v.x;  // int8: dims (d0, d0 + 2)
        qf[hg][KPC * p + j][1] = Q8 ? prmt(v.x, v.y, 0x7632) : v.y;  //        (d0 + 1, d0 + 3)
      }
  }

  // heads 8 hg + 2t, + 1; l: this lane's keys
  float m_run[HG][2], l_run[HG][2];
  float acc[HG][D / 16][4];  // O^T: dims 16 mb + g (+ 8 for e >= 2), heads 8 hg + 2t + (e & 1)
#pragma unroll
  for (int hg = 0; hg < HG; ++hg) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_run[hg][hh] = DA_NEG;
      l_run[hg][hh] = 0.f;
    }
#pragma unroll
    for (int mb = 0; mb < D / 16; ++mb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hg][mb][e] = 0.f;
  }
  const int kr0 = 16 * warp + g, kr1 = kr0 + 8;  // this lane's keys in a tile

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it has landed; every warp is done with tile it - 1's stage
    if (it + STAGES - 1 < nt) load(it + STAGES - 1);
    cp_async_commit();
    // the row of key tid of tile it + STAGES: its lookup is in flight during the products
    const int nxt = tid < DA_KEYS ? key_row(it + STAGES, tid) : -1;
    const unsigned char* st = smem + (it % STAGES) * L::STAGE;
    const int s0 = (t0 + it) * DA_KEYS, w0 = s0 + 16 * warp;
    if (w0 < hi && w0 + 16 > lo) {  // this warp's 16 keys hold a visible one
      // S^T: keys kr0 (e < 2), kr1; heads 8 hg + 2t + (e & 1), in NACC
      // independent sums (a chain of D / 16 dependent products otherwise),
      // added at the end
      float part[HG][NACC][4];
#pragma unroll
      for (int hg = 0; hg < HG; ++hg)
#pragma unroll
        for (int a = 0; a < NACC; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[hg][a][e] = 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint4 u0 = make_uint4(0u, 0u, 0u, 0u), u1 = u0;
        if (4 * p + t < NC) {
          u0 = *reinterpret_cast<const uint4*>(st + k_off<NC>(kr0, 4 * p + t));
          u1 = *reinterpret_cast<const uint4*>(st + k_off<NC>(kr1, 4 * p + t));
        }
        const uint32_t x0[4] = {u0.x, u0.y, u0.z, u0.w}, x1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
        for (int j = 0; j < KPC; ++j) {
          uint32_t a[4];
          if constexpr (Q8) {
            a[0] = i8x2_bf16(x0[j]), a[1] = i8x2_bf16(x1[j]);
            a[2] = i8x2_bf16(x0[j] >> 8), a[3] = i8x2_bf16(x1[j] >> 8);
          } else {
            a[0] = x0[2 * j], a[1] = x1[2 * j], a[2] = x0[2 * j + 1], a[3] = x1[2 * j + 1];
          }
#pragma unroll
          for (int hg = 0; hg < HG; ++hg)
            mma_16816(part[hg][(KPC * p + j) % NACC], a[0], a[1], a[2], a[3], qf[hg][KPC * p + j][0],
                      qf[hg][KPC * p + j][1]);
        }
      }
      const float* ksc = reinterpret_cast<const float*>(st + 2 * L::TILE);  // int8: the tile's k scales
      const unsigned char* vt = st + L::TILE + 16 * warp * RB;  // this warp's 16 value rows
      if constexpr (Q8) {  // the codes → bf16 rows in the warp's buffer
        unsigned char* cb = smem + STAGES * L::STAGE + warp * 16 * (2 * D);
        __syncwarp();  // the previous tile's ldmatrix reads are done
#pragma unroll
        for (int e = lane; e < 16 * (D / 16); e += 32) {
          const int row = e / (D / 16), c16 = e % (D / 16);
          const uint4 u = *reinterpret_cast<const uint4*>(vt + row * RB + 16 * c16);
          const uint32_t w[4] = {prmt(u.x, u.x, 0x3120), prmt(u.y, u.y, 0x3120), prmt(u.z, u.z, 0x3120),
                                 prmt(u.w, u.w, 0x3120)};  // bytes (0, 2, 1, 3): codes in order below
          const uint4 lo4 = make_uint4(i8x2_bf16(w[0]), i8x2_bf16(w[0] >> 8), i8x2_bf16(w[1]), i8x2_bf16(w[1] >> 8));
          const uint4 hi4 = make_uint4(i8x2_bf16(w[2]), i8x2_bf16(w[2] >> 8), i8x2_bf16(w[3]), i8x2_bf16(w[3] >> 8));
          *reinterpret_cast<uint4*>(cb + v_off<D / 8>(row, 2 * c16)) = lo4;
          *reinterpret_cast<uint4*>(cb + v_off<D / 8>(row, 2 * c16 + 1)) = hi4;
        }
        __syncwarp();
        vt = cb;
      }
      // P^T's B fragments per group: keys 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of head 8 hg + g
      uint32_t b0[HG], b1[HG];
#pragma unroll
      for (int hg = 0; hg < HG; ++hg) {
        float sc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[e] = part[hg][0][e];
#pragma unroll
          for (int a = 1; a < NACC; ++a) sc[e] += part[hg][a][e];
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = e < 2 ? kr0 : kr1;
          float x = sc[e] * scale;
          if constexpr (Q8) x *= ksc[kr];
          if constexpr (EXT)
            if (inv_cap > 0.f) x = softcap * tanhf(x * inv_cap);
          x = s0 + kr >= lo && s0 + kr < hi ? x : -INFINITY;
          sc[e] = x;
          mx[e & 1] = fmaxf(mx[e & 1], x);
        }
        float corr[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], off));
          const float m_new = fmaxf(m_run[hg][hh], mx[hh]);
          corr[hh] = __expf(m_run[hg][hh] - m_new);
          m_run[hg][hh] = m_new;
          l_run[hg][hh] *= corr[hh];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(sc[e] - m_run[hg][e & 1]);
          l_run[hg][e & 1] += p;  // the denominator takes the unscaled p, P the v scale of its key
          sc[e] = Q8 ? p * ksc[DA_KEYS + (e < 2 ? kr0 : kr1)] : p;
        }
#pragma unroll
        for (int mb = 0; mb < D / 16; ++mb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[hg][mb][e] *= corr[e & 1];
        b0[hg] = movmatrix_trans(bf16x2(sc[0], sc[1]));
        b1[hg] = movmatrix_trans(bf16x2(sc[2], sc[3]));
      }
      const int vrow = (lane & 7) + 8 * (lane >> 4), vch = (lane >> 3) & 1;
#pragma unroll
      for (int mb = 0; mb < D / 16; ++mb) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, vt + v_off<D / 8>(vrow, 2 * mb + vch));
#pragma unroll
        for (int hg = 0; hg < HG; ++hg) mma_16816(acc[hg][mb], a[0], a[1], a[2], a[3], b0[hg], b1[hg]);
      }
    }
    if (tid < DA_KEYS) rowbuf[(it % STAGES) * DA_KEYS + tid] = nxt;  // read after the next barrier
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy has landed and every warp is done with the stages

  const KL* lk = reinterpret_cast<const KL*>(smem + L::LK_OFF);
  const KL* lv = reinterpret_cast<const KL*>(smem + L::LV_OFF);
  if (last.k) {  // the last key's scores (warp w: heads w, w + 4, ...), in f32
    const __nv_bfloat16* lq = reinterpret_cast<const __nv_bfloat16*>(smem + L::LQ_OFF);
    for (int j = warp; j < r; j += DA_WARPS) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot = fmaf(__bfloat162float(lq[j * D + d]), as_float(lk[d]), dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      float x = dot * scale * last.ks;
      if constexpr (EXT)
        if (inv_cap > 0.f) x = softcap * tanhf(x * inv_cap);
      if (lane == 0) slast[j] = x;
    }
  }

  // the warps' partials: (m, l) per head and O, into the stages' memory
  float* wm = reinterpret_cast<float*>(smem);  // [DA_WARPS][NH]
  float* wl = wm + DA_WARPS * NH;
  float* wacc = reinterpret_cast<float*>(smem + L::WACC_OFF);  // [DA_WARPS][NH][D]
  float* part = reinterpret_cast<float*>(smem + L::PART_OFF);  // m [NH], l [NH], O [NH][D]
#pragma unroll
  for (int hg = 0; hg < HG; ++hg) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) l_run[hg][hh] += __shfl_xor_sync(0xffffffffu, l_run[hg][hh], off);
      if (g == 0) {
        wm[warp * NH + 8 * hg + 2 * t + hh] = m_run[hg][hh];
        wl[warp * NH + 8 * hg + 2 * t + hh] = l_run[hg][hh];
      }
    }
#pragma unroll
    for (int mb = 0; mb < D / 16; ++mb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wacc[(warp * NH + 8 * hg + 2 * t + (e & 1)) * D + 16 * mb + g + 8 * (e >> 1)] = acc[hg][mb][e];
  }
  __syncthreads();
  for (int e = tid; e < r * D; e += DA_THREADS) {  // the block's partial, warps in order
    const int j = e / D, d = e % D;
    float mx = DA_NEG;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) mx = fmaxf(mx, wm[w * NH + j]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float f = __expf(wm[w * NH + j] - mx);
      num += wacc[(w * NH + j) * D + d] * f;
      den += wl[w * NH + j] * f;
    }
    part[2 * NH + e] = num;
    if (d == 0) {
      part[j] = mx;
      part[NH + j] = den;
    }
  }

  // the cluster's partials, rank by rank, and the last key: rank k writes
  // every c-th group of four outputs
  if (c > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
  for (int f = rank * DA_THREADS + tid; f < r * D / 4; f += c * DA_THREADS) {
    const int j = 4 * f / D, d = 4 * f % D;
    float mx = DA_NEG;
    for (int k = 0; k < c; ++k) {
      const float* pk = c > 1 ? cg::this_cluster().map_shared_rank(part, k) : part;
      mx = fmaxf(mx, pk[j]);
    }
    const float sl = last.k ? slast[j] : DA_NEG;
    mx = fmaxf(mx, sl);
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 0.f;
    for (int k = 0; k < c; ++k) {
      const float* pk = c > 1 ? cg::this_cluster().map_shared_rank(part, k) : part;
      const float fk = __expf(pk[j] - mx);
      const float4 a = *reinterpret_cast<const float4*>(pk + 2 * NH + 4 * f);
      num.x += a.x * fk;
      num.y += a.y * fk;
      num.z += a.z * fk;
      num.w += a.w * fk;
      den += pk[NH + j] * fk;
    }
    if (last.k) {  // the denominator takes the unscaled weight, the value the v scale
      const float fl = __expf(sl - mx), fv = fl * last.vs;
      num.x += as_float(lv[d]) * fv;
      num.y += as_float(lv[d + 1]) * fv;
      num.z += as_float(lv[d + 2]) * fv;
      num.w += as_float(lv[d + 3]) * fv;
      den += fl;
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    *reinterpret_cast<uint2*>(out + j * D + d) = make_uint2(bf16x2(num.x * inv, num.y * inv), bf16x2(num.z * inv, num.w * inv));
  }
  if (c > 1) cg::this_cluster().sync();  // no block leaves while another reads its partial
}

// the attributes a split kernel needs, once per instantiation: its dynamic
// shared memory and clusters of 16 (non-portable, above 8)
template <typename Kernel>
cudaError_t da_attributes(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// c in {1, 2, 4, 8, 16}
inline bool da_valid_split(int c) { return c >= 1 && c <= DA_MAX_SPLIT && (c & (c - 1)) == 0; }

}  // namespace
