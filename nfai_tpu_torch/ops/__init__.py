"""Compute ops: each kernel's wrapper next to its plain PyTorch version.

- qmatmul: K1 4-bit and K6 8-bit dequant-matmul (csrc/q4_matmul.cu,
  csrc/q8_matmul.cu)
- fused_mlp: K5, the one-kernel quantized MLP (csrc/fused_mlp.cu)
- fused_decode: K2 decode attention, K3 K/V row write
  (csrc/decode_attention.cu, csrc/kv_write.cu)
- prefill_attention: K4 flash prefill attention (csrc/prefill_attention.cu)
- qtensor: the 4-bit and 8-bit weight containers (no kernel)
- norms, rope, sampling: plain PyTorch (no kernel in the JAX package either)
"""
