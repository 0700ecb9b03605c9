// K3: per-step K/V row write into the layer-stacked cache, in place:
//     cache[l, b, starts[b], :] = rows[l, b, :] for every layer l; rows of
//     batch entries with starts[b] >= S (or < 0) are dropped.
//
// Replaces nfai_tpu/ops/fused_decode.py::write_all_layers (_write_kernel),
// which rewrote the 8-row sublane tile around each row because a TPU kernel
// cannot store one sublane alone. A GPU stores single rows, so each
// (layer, batch) pair writes exactly its row and nothing else is touched.
//
// What bounds it on an H100: bytes (one read and one write of L*B rows of
// Hkv*D elements) and, at decode sizes (~64 KB), the launch itself.
//
// Design: one block per (batch row, layer), 16-byte copies, element type
// agnostic (the row length is given in bytes, a multiple of 16): the int8
// cache's code rows (Hkv*D bytes) go through it as they are.
//
// K10 (nfai_kv_write_t): the same write for the int8 cache's per-(token,
// kv head) f32 scales, stored time-minor as [L, B, Hkv, S]:
// arr[l, b, h, starts[b]] = rows[l, b, h]. Replaces
// nfai_tpu/ops/fused_decode.py::write_all_layers_t (_write_kernel_t), which
// rewrote the 128-lane tile around each scale because a TPU kernel cannot
// store one lane; a GPU stores one float. One thread per (l, b, h), rows
// with starts[b] outside [0, S) dropped, as in K3. Bound: bytes, L*B*Hkv*4
// read and written; at decode sizes (1 KB at L=16, B=8, Hkv=8) the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void kv_write_kernel(uint8_t* __restrict__ cache,
                                const uint8_t* __restrict__ rows,
                                const int* __restrict__ starts, int B, int S,
                                int row_bytes) {
  const int b = blockIdx.x, l = blockIdx.y;
  const int s = starts[b];
  if (s < 0 || s >= S) return;
  const uint4* src = reinterpret_cast<const uint4*>(
      rows + ((size_t)l * B + b) * row_bytes);
  uint4* dst = reinterpret_cast<uint4*>(
      cache + (((size_t)l * B + b) * S + s) * row_bytes);
  for (int i = threadIdx.x; i < row_bytes / 16; i += blockDim.x) dst[i] = src[i];
}

// K10: arr[l, b, h, starts[b]] = rows[l, b, h] for the int8 cache's f32
// scale arrays [L, B, H, S] (time-minor), one thread per (l, b, h).
__global__ void kv_write_t_kernel(float* __restrict__ arr, const float* __restrict__ rows,
                                  const int* __restrict__ starts, int n, int B, int H, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (l * B + b) * H + h
  if (i >= n) return;
  const int s = starts[(i / H) % B];
  if (s < 0 || s >= S) return;
  arr[(size_t)i * S + s] = rows[i];
}

}  // namespace

// cache [L, B, S, row] and rows [L, B, row] of the same element type,
// row_bytes % 16 == 0; starts [B] int32.
extern "C" int nfai_kv_write(void* cache, const void* rows, const void* starts,
                             int L, int B, int S, int row_bytes, void* stream) {
  dim3 grid(B, L), block(64);
  kv_write_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(cache), static_cast<const uint8_t*>(rows),
      static_cast<const int*>(starts), B, S, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// K10: arr [L, B, H, S] f32, rows [L, B, H] f32, starts [B] int32.
extern "C" int nfai_kv_write_t(void* arr, const void* rows, const void* starts, int L, int B,
                               int H, int S, void* stream) {
  const int n = L * B * H;
  kv_write_t_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(arr), static_cast<const float*>(rows),
      static_cast<const int*>(starts), n, B, H, S);
  return static_cast<int>(cudaGetLastError());
}
