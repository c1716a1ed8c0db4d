"""Packed-code primitives (``csrc/quant.cuh``) and the fused dequantize + score kernel (``csrc/dequant_score.cu``)."""
