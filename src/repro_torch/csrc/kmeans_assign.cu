// Fused similarity + masked first-argmax k-means assignment for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign/kernel.py
// (`_assign_kernel`, dispatched by `kmeans_assign_pallas`): for every row x_n
// of a document, sim_k = x_n . c_k over the document's centroids, -inf where
// k_mask[k] is false, then (first argmax, max). Among equal maxima the
// smallest index wins (the iota-min of the TPU kernel, jnp.argmax's rule), so
// a row whose clusters are all masked gets index 0 and -inf, as both JAX
// versions give. The [N, K] similarity matrix never reaches device memory.
//
// Batched: per-document k-means pooling gives every document its own
// centroids, so one launch serves a whole encode batch: x [B, N, dim],
// centroids [B, K, dim], k_mask [B, K]. The TPU contract ([N, dim] rows
// against one [K, dim] centroid set) is the case B = 1.
//
// What bounds it on this card: at the pooling shapes (N = 256, K = 129,
// dim = 128) it does 2 * K * dim = 33 KFLOP per 512-byte row it must read,
// ~64 FLOP a byte: above the f32 (non tensor core) ridge of ~20, so it is
// bound by operations, ~16 us for a 128-document batch at the f32 peak.
//
// Design: one block per (document, tile of ROWS = 64 rows). The row tile
// and CHUNK = 64 centroids at a time are staged in shared memory, rows
// padded to dim + 1 floats (conflict-free reads across rows); for K above
// CHUNK the block loops over centroid chunks, so any K fits. Each of the
// 256 threads owns a 4 x 4 register tile (rows ty + 16 i, centroids
// tx + 16 j) of dot products, accumulated in plain f32 FMA in dimension
// order, and keeps a running (best, index) pair for its 4 rows; the 16
// threads of a row then reduce their pairs with shuffles (larger value, or
// equal value and smaller index). No tensor cores: TF32 would flip
// assignments that f32 keeps; wgmma is for a later change.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int ROWS = 64;                  // rows of x per block
constexpr int CHUNK = 64;                 // centroids staged per pass
constexpr int TR = 4;                     // rows per thread
constexpr int TC = 4;                     // centroids per thread
constexpr int NTX = CHUNK / TC;           // threads along centroids (16)
constexpr int NTY = ROWS / TR;            // threads along rows (16)
constexpr int THREADS = NTX * NTY;        // 256
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ bool better(float s, int k, float best, int idx) {
  return s > best || (s == best && k < idx);
}

__global__ void __launch_bounds__(THREADS) kmeans_assign_kernel(
    const float* __restrict__ x, const float* __restrict__ centroids,
    const uint8_t* __restrict__ kmask, int32_t* __restrict__ assign,
    float* __restrict__ best_out, int N, int K, int dim, int b0) {
  extern __shared__ float smem[];
  const int stride = dim + 1;
  float* xs = smem;                        // [ROWS][stride]
  float* cs = xs + ROWS * stride;          // [CHUNK][stride]
  int* km = reinterpret_cast<int*>(cs + CHUNK * stride);   // [CHUNK]

  const int b = b0 + blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const float* xb = x + (size_t)b * N * dim;
  const float* cb = centroids + (size_t)b * K * dim;
  const uint8_t* kb = kmask + (size_t)b * K;

  for (int i = tid; i < ROWS * dim; i += THREADS) {
    const int r = i / dim, e = i % dim;
    xs[r * stride + e] = (row0 + r < N) ? xb[(size_t)(row0 + r) * dim + e]
                                        : 0.f;
  }

  float best[TR];
  int idx[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    best[i] = -INFINITY;
    idx[i] = K;                            // sentinel above every index
  }

  for (int k0 = 0; k0 < K; k0 += CHUNK) {
    const int nk = min(CHUNK, K - k0);
    __syncthreads();                       // previous chunk fully read
    for (int i = tid; i < CHUNK * dim; i += THREADS) {
      const int c = i / dim, e = i % dim;
      cs[c * stride + e] = (c < nk) ? cb[(size_t)(k0 + c) * dim + e] : 0.f;
    }
    if (tid < CHUNK) km[tid] = (tid < nk) ? (int)kb[k0 + tid] : 0;
    __syncthreads();

    float acc[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
    for (int e = 0; e < dim; ++e) {
      float xv[TR], cv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) xv[i] = xs[(ty + NTY * i) * stride + e];
#pragma unroll
      for (int j = 0; j < TC; ++j) cv[j] = cs[(tx + NTX * j) * stride + e];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j)
          acc[i][j] = __fmaf_rn(xv[i], cv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = tx + NTX * j;
      if (c >= nk) continue;
      const bool on = km[c] != 0;
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float s = on ? acc[i][j] : -INFINITY;
        if (better(s, k0 + c, best[i], idx[i])) {
          best[i] = s;
          idx[i] = k0 + c;
        }
      }
    }
  }

  // the NTX threads of a row are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float bv = best[i];
    int bi = idx[i];
#pragma unroll
    for (int o = NTX / 2; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int r = row0 + ty + NTY * i;
    if (tx == 0 && r < N) {
      const size_t o = (size_t)b * N + r;
      assign[o] = (bi >= K) ? 0 : bi;      // K == 0: nothing to pick
      best_out[o] = bv;
    }
  }
}

}  // namespace

extern "C" size_t kmeans_assign_smem_bytes(int dim) {
  return sizeof(float) * (size_t)(ROWS + CHUNK) * (dim + 1) +
         sizeof(int) * CHUNK;
}

// x [B, N, dim] f32; centroids [B, K, dim] f32; kmask [B, K] u8 ->
// assign [B, N] i32, best [B, N] f32. Returns cudaGetLastError().
extern "C" int kmeans_assign_launch(const float* x, const float* centroids,
                                    const uint8_t* kmask, int32_t* assign,
                                    float* best, int B, int N, int K,
                                    int dim, void* stream) {
  const size_t smem = kmeans_assign_smem_bytes(dim);
  cudaFuncSetAttribute(kmeans_assign_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int tiles = (N + ROWS - 1) / ROWS;
  for (int b0 = 0; b0 < B && tiles > 0; b0 += MAX_GRID_Y) {
    dim3 grid(tiles, min(MAX_GRID_Y, B - b0));
    kmeans_assign_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        x, centroids, kmask, assign, best, N, K, dim, b0);
  }
  return (int)cudaGetLastError();
}
