// Fused PLAID centroid-interaction probe (stages 1 + 3) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/plaid_probe/kernel.py
// (`_plaid_probe_kernel`, dispatched by `plaid_probe_pallas`): score one
// query's tokens against every centroid (q . C^T), set masked query tokens
// to -inf, prune scores below t_cs to 0, then for each candidate doc take
// the max over its (valid) token codes of the pruned score and sum over
// query tokens. Invalid candidate slots get -inf.
//
// What bounds it on this card: bytes. Per candidate token it reads a 4-byte
// centroid id and a 1-byte mask and does Lq table lookups and maxima; the
// q . C^T table ([Lq, K], 2*Lq*K*dim FLOP per block) is small next to the
// candidate stream at C = 16384 candidates per query.
//
// Design: one block per (query, tile of TILE_C candidates). The pruned
// [Lq, K] score table is computed into shared memory once per block from
// the query's tokens and CT-row centroid tiles, both staged in shared
// memory with coalesced loads (rows padded to K + 1 floats, so lanes
// reading different query tokens at one code hit different banks). Each
// warp then walks candidates; lane i owns query token i (and i + 32,
// ...), the warp loads 32 codes at a time with
// one coalesced read and broadcasts them with shuffles, and each
// candidate token's score is a direct indexed read of the table — the
// one-hot matmul of the TPU kernel was a Mosaic workaround and is gone.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_C = 256;
constexpr int MAX_R = 4;                   // Lq <= 32 * MAX_R = 128 a launch;
                                           // the wrapper splits longer queries
constexpr int CT = 32;                     // centroid rows per stage-1 tile

__global__ void __launch_bounds__(THREADS) plaid_probe_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ qmask,
    const float* __restrict__ centroids, const int32_t* __restrict__ codes,
    const uint8_t* __restrict__ cmask, const uint8_t* __restrict__ vmask,
    float* __restrict__ out, int Lq, int dim, int K, int C, int L,
    float t_cs) {
  extern __shared__ float smem[];
  const int ks = K + 1;
  const int ds = dim + 1;
  float* cs = smem;                        // [Lq, K + 1] pruned scores
  float* qs = cs + Lq * ks;                // [Lq, dim] this query's tokens
  float* ctile = qs + Lq * dim;            // [CT, dim + 1] centroid rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = THREADS / 32;
  const int qi = blockIdx.y;

  // stage 1: centroid scores for this query's tokens, masked and pruned.
  // Centroid rows are staged CT at a time with coalesced loads; lane
  // kk of every warp owns centroid k0 + kk, warp w query tokens w, w + 8..
  const float* qq = q + (size_t)qi * Lq * dim;
  for (int i = tid; i < Lq * dim; i += THREADS) qs[i] = qq[i];
  for (int k0 = 0; k0 < K; k0 += CT) {
    const int nk = min(CT, K - k0);
    __syncthreads();                       // previous tile fully read
    for (int i = tid; i < nk * dim; i += THREADS)
      ctile[(i / dim) * ds + i % dim] = centroids[(size_t)k0 * dim + i];
    __syncthreads();
    if (lane < nk) {
      const float* crow = ctile + lane * ds;
      for (int lq = warp; lq < Lq; lq += nwarps) {
        const float* qrow = qs + lq * dim;
        float acc = 0.f;
        for (int e = 0; e < dim; ++e) acc = __fmaf_rn(qrow[e], crow[e], acc);
        const float s = qmask[(size_t)qi * Lq + lq] ? acc : -INFINITY;
        cs[lq * ks + k0 + lane] = (s >= t_cs) ? s : 0.f;
      }
    }
  }
  __syncthreads();

  // stage 3: centroid-only MaxSim over each candidate's token codes
  const int c_end = min(C, (int)(blockIdx.x + 1) * TILE_C);
  for (int c = blockIdx.x * TILE_C + warp; c < c_end; c += nwarps) {
    const size_t cand = (size_t)qi * C + c;
    if (!vmask[cand]) {
      if (lane == 0) out[cand] = -INFINITY;
      continue;
    }
    float m[MAX_R];
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) m[r] = -INFINITY;
    const size_t base = cand * L;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int n = min(32, L - l0);
      const int code = lane < n ? codes[base + l0 + lane] : 0;
      const int msk = lane < n ? (int)cmask[base + l0 + lane] : 0;
      for (int j = 0; j < n; ++j) {
        const int cj = __shfl_sync(0xffffffffu, code, j);
        const int mj = __shfl_sync(0xffffffffu, msk, j);
#pragma unroll
        for (int r = 0; r < MAX_R; ++r) {
          const int lq = lane + 32 * r;
          if (lq < Lq) m[r] = fmaxf(m[r], mj ? cs[lq * ks + cj] : 0.f);
        }
      }
    }
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r)
      if (lane + 32 * r < Lq) part += m[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) out[cand] = part;
  }
}

}  // namespace

extern "C" size_t plaid_probe_smem_bytes(int Lq, int K, int dim) {
  return sizeof(float) * ((size_t)Lq * (K + 1) + (size_t)Lq * dim +
                          (size_t)CT * (dim + 1));
}

// q [Nq, Lq, dim] f32; qmask [Nq, Lq] u8; centroids [K, dim] f32;
// codes [Nq, C, L] i32; cmask [Nq, C, L] u8; vmask [Nq, C] u8
// -> out [Nq, C] f32, Lq <= 128. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a longer query).
extern "C" int plaid_probe_launch(const float* q, const uint8_t* qmask,
                                  const float* centroids,
                                  const int32_t* codes, const uint8_t* cmask,
                                  const uint8_t* vmask, float* out, int Nq,
                                  int Lq, int dim, int K, int C, int L,
                                  float t_cs, void* stream) {
  if (Lq > 32 * MAX_R) return (int)cudaErrorInvalidValue;
  const size_t smem = plaid_probe_smem_bytes(Lq, K, dim);
  cudaFuncSetAttribute(plaid_probe_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((C + TILE_C - 1) / TILE_C, Nq);
  if (Nq > 0 && C > 0)
    plaid_probe_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        q, qmask, centroids, codes, cmask, vmask, out, Lq, dim, K, C, L,
        t_cs);
  return (int)cudaGetLastError();
}
