// Shared packed-code primitives for the PLAID residual codec.
//
// Replaces the in-tile helper `unpack_reconstruct` of the TPU kernels
// (src/repro/kernels/quant/kernel.py): unpack little-endian b-bit codes,
// add the centroid row and the per-dimension bucket value, renormalize by
// max(||v||, 1e-9). On the TPU the centroid row came from a one-hot matmul
// and the bucket value from a where-chain over 2^b planes (no dynamic
// gather in Mosaic); here both are plain indexed loads.
//
// One warp reconstructs one token row: lane e handles dimensions
// e, e+32, ... and the sum of squares is a warp shuffle reduction.
#pragma once
#include <cstdint>

__device__ __forceinline__ int unpack_code(const uint32_t* words, int e,
                                           int bits) {
  const int cpw = 32 / bits;
  const uint32_t w = words[e / cpw];
  return (int)((w >> ((e % cpw) * bits)) & ((1u << bits) - 1u));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Reconstruct one unit-renormalized token row into out[0:dim] (shared
// memory). words: the row's W packed words; cid: its centroid id;
// centroids [K, dim]; values [dim, 2^bits]. Called by all 32 lanes.
__device__ __forceinline__ void warp_unpack_reconstruct(
    const uint32_t* words, int cid, const float* __restrict__ centroids,
    const float* values, int dim, int bits, float* out) {
  const int lane = threadIdx.x & 31;
  const int nb = 1 << bits;
  float ss = 0.f;
  for (int e = lane; e < dim; e += 32) {
    const float v = __fadd_rn(centroids[(size_t)cid * dim + e],
                              values[e * nb + unpack_code(words, e, bits)]);
    out[e] = v;
    ss = __fmaf_rn(v, v, ss);
  }
  ss = warp_sum(ss);
  const float inv = fmaxf(sqrtf(ss), 1e-9f);
  __syncwarp();
  for (int e = lane; e < dim; e += 32) out[e] = __fdiv_rn(out[e], inv);
  __syncwarp();
}
