// Fused dequantize + score of packed residual-coded rows for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quant/kernel.py
// (`_dequant_score_kernel`, dispatched by `dequant_score_pallas`): for each
// of M packed rows, unpack its b-bit codes, add the per-dimension bucket
// values to its centroid row, renormalize by max(||v||, 1e-9), and score it
// against every query token: out [M, Lq] = v . q^T. The reconstructed rows
// never reach device memory.
//
// The JAX wrapper gathers the centroid rows outside its kernel
// (`jnp.take`); here the kernel reads centroids[id] itself, which saves
// writing and then reading M * dim floats. The function is the same.
//
// What bounds it on this card: operations. Per row the function must read
// 4W + 4 bytes of codes and id and write 4 Lq bytes of scores (the centroid
// table, the value table and the query are read once for all rows), and it
// does 2 Lq dim FLOP of scores: at b = 2, Lq = 32, dim = 128 that is ~50 FLOP
// a byte, above the f32 (non tensor core) ridge of ~20. Counted with one
// centroid row read per row (the TPU kernel's pre-gathered input), it is
// ~12 FLOP a byte and bound by bytes; chip_smoke.py prints both bounds.
//
// Design: one warp per row, ROWS_PER_WARP rows a warp, 8 warps a block. The
// query's [Lq, dim] tile and the codec's value table sit in shared memory
// for the whole block (query rows padded to dim + 1 floats, so lane l
// reading row l is bank-conflict free). Each warp reconstructs its row into
// shared memory with `warp_unpack_reconstruct` (csrc/quant.cuh, the device
// function the packed rerank uses), then lane l computes the dot products
// of query tokens l, l + 32, ... in plain f32 FMA and the warp writes the
// row's Lq scores contiguously.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "quant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;

__global__ void __launch_bounds__(THREADS) dequant_score_kernel(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ ids,
    const float* __restrict__ centroids, const float* __restrict__ values,
    const float* __restrict__ q, float* __restrict__ out, int M, int Lq,
    int dim, int W, int bits) {
  extern __shared__ float smem[];
  const int nb = 1 << bits;
  const int stride = dim + 1;
  float* qs = smem;                          // [Lq][stride]
  float* vals = qs + Lq * stride;            // [dim][nb]
  float* rows = vals + dim * nb;             // [WARPS][dim]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < Lq * dim; i += THREADS)
    qs[(i / dim) * stride + (i % dim)] = q[i];
  for (int i = tid; i < dim * nb; i += THREADS) vals[i] = values[i];
  __syncthreads();

  float* row = rows + warp * dim;
  const int m0 = blockIdx.x * ROWS_PER_BLOCK + warp * ROWS_PER_WARP;
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int m = m0 + r;
    if (m >= M) break;                       // uniform across the warp
    warp_unpack_reconstruct(words + (size_t)m * W, ids[m], centroids, vals,
                            dim, bits, row);
    for (int l = lane; l < Lq; l += 32) {
      const float* qrow = qs + l * stride;
      float acc = 0.f;
      for (int e = 0; e < dim; ++e) acc = __fmaf_rn(row[e], qrow[e], acc);
      out[(size_t)m * Lq + l] = acc;
    }
    __syncwarp();                            // row read before it is reused
  }
}

}  // namespace

extern "C" size_t dequant_score_smem_bytes(int Lq, int dim, int bits) {
  return sizeof(float) * ((size_t)Lq * (dim + 1) + (size_t)dim * (1 << bits) +
                          (size_t)WARPS * dim);
}

// words [M, W] u32; ids [M] i32; centroids [K, dim] f32; values
// [dim, 2^bits] f32; q [Lq, dim] f32 -> out [M, Lq] f32.
// Returns cudaGetLastError().
extern "C" int dequant_score_launch(const uint32_t* words, const int32_t* ids,
                                    const float* centroids,
                                    const float* values, const float* q,
                                    float* out, int M, int Lq, int dim, int W,
                                    int bits, void* stream) {
  const size_t smem = dequant_score_smem_bytes(Lq, dim, bits);
  cudaFuncSetAttribute(dequant_score_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int blocks = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (blocks > 0)
    dequant_score_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        words, ids, centroids, values, q, out, M, Lq, dim, W, bits);
  return (int)cudaGetLastError();
}
