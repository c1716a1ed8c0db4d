// Compressed-domain MaxSim rerank (PLAID stage 4) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maxsim_packed/kernel.py
// (`_maxsim_packed_rerank_kernel`, dispatched by
// `maxsim_packed_rerank_pallas`): for each query and each of its own
// candidates, unpack the candidate's packed b-bit residual codes,
// reconstruct and renormalize its token vectors, and score
// sum_{valid q tokens} max_{valid d tokens} q . d.
//
// What bounds it on this card: operations. Per query/candidate token pair
// it does `dim` multiply-adds, while the packed inputs it reads are only
// 4 + 4W + 1 bytes per doc token (W = dim*b/32 words), so at dim = 128,
// Lq = 32 the arithmetic intensity is ~200 FLOP/byte: above the f32
// (non tensor core) ridge of ~20 FLOP/byte, below the bf16 tensor-core one.
//
// Design: one block per (query, slab of candidates). The query's token
// vectors and the codec's value table sit in shared memory for the whole
// slab; doc tokens are reconstructed CHUNK at a time into shared memory
// (one warp per token row, `warp_unpack_reconstruct` from quant.cuh — the
// centroid row is a direct indexed read, not the TPU's one-hot matmul),
// chunks with no valid token are skipped, and each thread keeps running
// maxima for its query tokens in registers. Rows are padded to dim + 1
// floats so the strided row reads are bank-conflict free. Plain f32 FMA;
// moving the dot products onto wgmma is left to a later change.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "quant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SUBS = 8;                     // threads sharing a query token
constexpr int GROUPS = THREADS / SUBS;      // query tokens per pass
constexpr int MAX_Q_PER_THREAD = 4;         // Lq <= GROUPS * 4 = 128 a launch;
                                            // the wrapper splits longer queries
constexpr int CHUNK = 32;                   // doc tokens per shared pass
constexpr int CANDS_PER_BLOCK = 4;

__global__ void __launch_bounds__(THREADS) maxsim_packed_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ qmask,
    const uint32_t* __restrict__ words, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ dmask, const float* __restrict__ centroids,
    const float* __restrict__ values, float* __restrict__ out, int Lq,
    int dim, int S, int Ld, int W, int bits) {
  extern __shared__ float smem[];
  const int nb = 1 << bits;
  const int stride = dim + 1;
  float* qs = smem;                              // [Lq, stride]
  float* ds = qs + Lq * stride;                  // [CHUNK, stride]
  float* vals = ds + CHUNK * stride;             // [dim, nb]
  float* red = vals + dim * nb;                  // [THREADS / 32]
  int* live = reinterpret_cast<int*>(red + THREADS / 32);   // [CHUNK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = THREADS / 32;
  const int qi = blockIdx.y;
  const int g = tid / SUBS, sub = tid % SUBS;

  for (int i = tid; i < Lq * dim; i += THREADS)
    qs[(i / dim) * stride + (i % dim)] = q[(size_t)qi * Lq * dim + i];
  for (int i = tid; i < dim * nb; i += THREADS) vals[i] = values[i];
  __syncthreads();

  for (int c = 0; c < CANDS_PER_BLOCK; ++c) {
    const int s = blockIdx.x * CANDS_PER_BLOCK + c;
    if (s >= S) break;                         // uniform across the block
    const size_t cand = (size_t)qi * S + s;
    float best[MAX_Q_PER_THREAD];
#pragma unroll
    for (int r = 0; r < MAX_Q_PER_THREAD; ++r) best[r] = -INFINITY;

    for (int t0 = 0; t0 < Ld; t0 += CHUNK) {
      const int n = min(CHUNK, Ld - t0);
      const size_t base = cand * Ld + t0;
      const int valid = (tid < n) ? (int)dmask[base + tid] : 0;
      if (tid < CHUNK) live[tid] = valid;
      if (!__syncthreads_or(valid)) continue;  // fully masked chunk
      for (int t = warp; t < n; t += nwarps)
        if (live[t])
          warp_unpack_reconstruct(words + (base + t) * W, ids[base + t],
                                  centroids, vals, dim, bits,
                                  ds + t * stride);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < MAX_Q_PER_THREAD; ++r) {
        const int lq = g + r * GROUPS;
        if (lq >= Lq) break;
        const float* qrow = qs + lq * stride;
        for (int t = sub; t < n; t += SUBS) {
          if (!live[t]) continue;
          const float* drow = ds + t * stride;
          float acc = 0.f;
          for (int e = 0; e < dim; ++e) acc = __fmaf_rn(qrow[e], drow[e], acc);
          best[r] = fmaxf(best[r], acc);
        }
      }
      __syncthreads();
    }

    // max over the SUBS threads of a query token, then the masked sum
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_Q_PER_THREAD; ++r) {
      float b = best[r];
#pragma unroll
      for (int o = SUBS / 2; o > 0; o >>= 1)
        b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
      const int lq = g + r * GROUPS;
      if (sub == 0 && lq < Lq && qmask[(size_t)qi * Lq + lq] && isfinite(b))
        part += b;
    }
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < nwarps; ++w) total += red[w];
      out[cand] = total;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" size_t maxsim_packed_smem_bytes(int Lq, int dim, int bits) {
  return sizeof(float) * ((size_t)(Lq + CHUNK) * (dim + 1) +
                          (size_t)dim * (1 << bits) + THREADS / 32) +
         sizeof(int) * CHUNK;
}

// q [Nq, Lq, dim] f32; qmask [Nq, Lq] u8; words [Nq, S, Ld, W] u32;
// ids / dmask [Nq, S, Ld] i32 / u8; centroids [K, dim]; values
// [dim, 2^bits] -> out [Nq, S] f32, Lq <= 128. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a longer query).
extern "C" int maxsim_packed_launch(const float* q, const uint8_t* qmask,
                                    const uint32_t* words,
                                    const int32_t* ids, const uint8_t* dmask,
                                    const float* centroids,
                                    const float* values, float* out, int Nq,
                                    int Lq, int dim, int S, int Ld, int W,
                                    int bits, void* stream) {
  if (Lq > GROUPS * MAX_Q_PER_THREAD) return (int)cudaErrorInvalidValue;
  const size_t smem = maxsim_packed_smem_bytes(Lq, dim, bits);
  cudaFuncSetAttribute(maxsim_packed_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((S + CANDS_PER_BLOCK - 1) / CANDS_PER_BLOCK, Nq);
  if (Nq > 0 && S > 0)
    maxsim_packed_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        q, qmask, words, ids, dmask, centroids, values, out, Lq, dim, S, Ld,
        W, bits);
  return (int)cudaGetLastError();
}
