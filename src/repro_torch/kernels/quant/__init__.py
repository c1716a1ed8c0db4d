"""Packed-code primitives shared by the PLAID kernels (``csrc/quant.cuh``)."""
