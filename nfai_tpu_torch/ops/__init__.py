"""Compute ops: each kernel's wrapper next to its plain PyTorch version.

- qmatmul: K1 4-bit and K6 8-bit dequant-matmul (csrc/q4_matmul.cu,
  csrc/q8_matmul.cu)
- fused_mlp: K5, the one-kernel quantized MLP (csrc/fused_mlp.cu)
- fused_decode: K2 decode attention (csrc/decode_attention.cu); K3 and K10,
  the row and scale writes in their JAX contracts (csrc/kv_write.cu)
- kv_store: the K/V store every K/V write of the main path goes through,
  K3 and K10 redesigned as one kernel with the int8 quantization inside:
  the dense cache and the page pool (csrc/kv_write.cu, csrc/kv_store.cuh)
- prefill_attention: K4 flash prefill attention (csrc/prefill_attention.cu)
- paged_attention: K7 decode attention through block tables
  (csrc/paged_attention.cu)
- qtensor: the 4-bit and 8-bit weight containers (no kernel)
- norms, rope, sampling: plain PyTorch (no kernel in the JAX package either)
"""
