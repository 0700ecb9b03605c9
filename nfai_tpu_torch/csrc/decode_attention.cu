// K2: decode attention of one new token per row against one layer of the
//     merged-lane KV cache, with the new K/V row folded in (not yet written).
//
//   out[b, h*r + j, :] = softmax_s(q[b, h*r+j] . k_s * scale) @ v_s
//   over s in cache[b, 0:starts[b]] (head h's D columns) and the new row.
//
// Replaces nfai_tpu/ops/fused_decode.py::layered_decode_attention_slab
// (_fused_slab_kernel) and its fallback ::layered_decode_attention
// (_fused_kernel): same function. The layer index is a pointer offset on
// the GPU, so the wrapper passes cache[layer] ([B, S, Hkv*D] bf16).
//
// What bounds it on an H100: bytes. Every old key and value of a row is read
// once (2 * starts * D * 2 bytes per kv head); the arithmetic is ~4 flops
// per byte, far under the card's ~295 flops/byte ridge.
//
// Design: one block per (kv head, batch row); the r = Hq/Hkv query heads of
// the group share each K/V load (GQA). Sixteen warps take 32-key tiles in
// turn. In a tile each lane owns one key: it reads the key's head slice and
// computes the r scores against the scaled queries kept in shared memory;
// the warp then runs the online-softmax update, and for P @ V lane l owns
// dims (2l, 2l+1) and reads each value row as one coalesced 128-byte line.
// Key index starts[b] is the new token, read from k_new/v_new. The warps'
// (max, sum, acc) states merge through shared memory; the acc buffer
// (WARPS * r * D floats, 64 KB at D = 128, r = 8) is dynamic shared memory,
// its limit raised once per instantiation.
// r in {1, 2, 3, 4, 8} (3: Llama-3.2-3B); D = 64 or 128, a template
// parameter. At D = 128 a key row is 256 bytes and lane l owns dims
// 4l..4l+3 in P @ V (one 8-byte load per lane and value row); D = 64 does
// the arithmetic it did before the head width became a parameter.
// Splitting long rows across blocks (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int WARPS = 16;

__device__ __forceinline__ void bf16x8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// lane l's DL = D / 32 consecutive dims of a value row, as floats
template <int D>
__device__ __forceinline__ void load_dims(const __nv_bfloat16* row, int lane, float* v) {
  if constexpr (D == 64) {
    const __nv_bfloat162 v2 = reinterpret_cast<const __nv_bfloat162*>(row)[lane];
    v[0] = __low2float(v2);
    v[1] = __high2float(v2);
  } else {
    const uint2 u = reinterpret_cast<const uint2*>(row)[lane];
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xFFFF0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xFFFF0000u);
  }
}

template <int D, int R>
__global__ void __launch_bounds__(WARPS * 32)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,      // [B, Hq, D]
                   const __nv_bfloat16* __restrict__ k_new,  // [B, KVD]
                   const __nv_bfloat16* __restrict__ v_new,
                   const __nv_bfloat16* __restrict__ kc,     // [B, S, KVD]
                   const __nv_bfloat16* __restrict__ vc,
                   const int* __restrict__ starts,           // [B]
                   __nv_bfloat16* __restrict__ out,          // [B, Hq, D]
                   int S, int hkv, float scale) {
  constexpr int DL = D / 32;
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

  float m_run[R], l_run[R], acc[R][DL];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    m_run[j] = NEG;
    l_run[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[j][i] = 0.f;
  }

  for (int t = warp; t < n_tiles; t += WARPS) {
    const int s = t * 32 + lane;
    const bool valid = s < n_keys;
    float sc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) sc[j] = 0.f;
    if (valid) {
      const __nv_bfloat16* krow = s < n_old
          ? kc + ((size_t)b * S + s) * kvd + h * D
          : k_new + (size_t)b * kvd + h * D;
      const uint4* k4 = reinterpret_cast<const uint4*>(krow);
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
    }
    const int n_in = min(32, n_keys - t * 32);
    for (int i = 0; i < n_in; ++i) {
      const int si = t * 32 + i;
      const __nv_bfloat16* vrow = si < n_old
          ? vc + ((size_t)b * S + si) * kvd + h * D
          : v_new + (size_t)b * kvd + h * D;
      float v[DL];
      load_dims<D>(vrow, lane, v);
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

template <int D, int R>
int launch_r(const void* q, const void* k_new, const void* v_new, const void* kc,
             const void* vc, const void* starts, void* out, int B, int S, int hkv,
             float scale, cudaStream_t st) {
  constexpr int smem = WARPS * R * D * (int)sizeof(float);
  // once per instantiation: D = 128, r = 8 is above the default 48 KB
  static const cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<D, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attn_kernel<D, R><<<dim3(hkv, B), WARPS * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int*>(starts),
      static_cast<__nv_bfloat16*>(out), S, hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k_new, const void* v_new, const void* kc,
           const void* vc, const void* starts, void* out, int B, int S, int hkv,
           int r, float scale, cudaStream_t st) {
#define NFAI_LAUNCH(RR) \
  return launch_r<D, RR>(q, k_new, v_new, kc, vc, starts, out, B, S, hkv, scale, st)
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

}  // namespace

// q [B, Hq, D], k_new/v_new [B, Hkv*D], kc/vc [B, S, Hkv*D] (one layer),
// starts [B] int32, out [B, Hq, D]; all bf16 except starts. D in {64, 128},
// r = Hq/Hkv in {1, 2, 3, 4, 8}.
extern "C" int nfai_decode_attention(const void* q, const void* k_new,
                                     const void* v_new, const void* kc,
                                     const void* vc, const void* starts,
                                     void* out, int B, int S, int hkv, int r,
                                     int d, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(q, k_new, v_new, kc, vc, starts, out, B, S, hkv, r, scale, st);
  if (d == 128) return launch<128>(q, k_new, v_new, kc, vc, starts, out, B, S, hkv, r, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
