// MaxSim late-interaction scoring over f32 token vectors for Hopper (sm_90a).
//
// Two entries, one per TPU kernel of src/repro/kernels/maxsim/kernel.py:
//   * maxsim_launch replaces `maxsim_pallas` (`_maxsim_kernel`): all-pairs
//     scores q [Nq, Lq, dim] x d [Nd, Ld, dim] -> [Nq, Nd] (flat search and
//     PLAID's dense corpus-wide fallback);
//   * maxsim_rerank_launch replaces `maxsim_rerank_pallas`
//     (`_maxsim_rerank_kernel`): each query against its own gathered
//     candidates d [Nq, S, Ld, dim] -> [Nq, S] (PLAID's rerank from the f32
//     reconstruction store).
// Both compute sum_{valid q tokens} max_{valid d tokens} q . d; a masked doc
// token is -inf, and a query token that is masked or whose best is not
// finite contributes 0 (a doc with no valid token scores 0).
//
// What bounds them on this card: the all-pairs entry is bound by operations
// (each doc token is scored against every token of Nq queries: at Nq = 32,
// Lq = 32, dim = 128 it does ~40 FLOP per byte it must read, above the f32
// ridge of ~20); the rerank entry reads every gathered doc once for one
// query (~16 FLOP per byte at Lq = 32) and is bound by bytes.
//
// Design: one block per (QB queries, run of DOCS_PER_BLOCK docs);
// blockIdx.x walks queries, so the blocks reading one doc run side by side
// and share it through L2, and each doc chunk staged in shared memory is
// scored against QB queries (2 for all-pairs; 1 for the rerank, whose docs
// belong to one query). Query tiles (QT tokens) are staged once per block,
// k-major ([dim][QT]); doc tokens are staged DT rows at a time as one
// contiguous, coalesced float4 copy into rows padded to dim + 4 floats
// (bank-conflict-free float4 reads across rows). Each thread owns a
// TQ x TD tile of (query token, doc token) dot products per query in
// registers — per 4 dimensions it loads TD float4 of doc values, reused for
// all QB queries, and TQ query values per dimension — in plain f32 FMA,
// explicitly rounded so nvcc cannot reassociate them. Running maxima per
// query token are reduced over the block with shuffles and the sum goes
// through shared memory. Chunks whose doc tokens are all masked are
// skipped. No tensor cores: TF32 would move the scores past the tolerances
// this port holds them to; wgmma is for a later change.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "quant.cuh"

namespace {

constexpr int QT = 32;                  // query tokens per staged tile
constexpr int DT = 64;                  // doc tokens per staged chunk
constexpr int TQ = 4;                   // query tokens per thread
constexpr int TD = 4;                   // doc tokens per thread
constexpr int NTD = DT / TD;            // threads along doc tokens (16)
constexpr int THREADS = (QT / TQ) * NTD;         // 128
constexpr int DOCS_PER_BLOCK = 8;
constexpr int STAGE = 8;                // doc-chunk loads in flight a thread
constexpr int QB_ALL_PAIRS = 2;         // queries per block, all-pairs
constexpr int MAX_GRID_Y = 65535;

template <int QB>
struct Tiles {
  float* q;    // [QB][dim][QT] k-major query tiles
  float* d;    // [DT][dim + 4] doc rows
  int* qv;     // [QB][QT] query token valid
  int* dv;     // [DT] doc token valid
  float* red;  // [QB][THREADS / 32]
};

template <int QB>
__device__ __forceinline__ Tiles<QB> carve(float* base, int dim) {
  Tiles<QB> s;
  s.q = base;
  s.d = s.q + (size_t)QB * dim * QT;
  s.qv = reinterpret_cast<int*>(s.d + (size_t)DT * (dim + 4));
  s.dv = s.qv + QB * QT;
  s.red = reinterpret_cast<float*>(s.dv + DT);
  return s;
}

__host__ __device__ constexpr size_t smem_bytes(int QB, int dim) {
  return sizeof(float) * ((size_t)QB * dim * QT + (size_t)DT * (dim + 4) +
                          (size_t)QB * (THREADS / 32)) +
         sizeof(int) * ((size_t)QB * QT + DT);
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Query tokens [l0, l0 + QT) of one query q [Lq, dim] into dst [dim][QT]
// and their valid flags (false past Lq, or for a query past Nq). Lanes walk
// tokens so the transposed stores hit consecutive banks.
__device__ __forceinline__ void stage_query(const float* __restrict__ q,
                                            const uint8_t* __restrict__ qm,
                                            bool present, int Lq, int dim,
                                            int l0, float* dst, int* qv) {
  const int dim4 = dim >> 2;
  for (int i = threadIdx.x; i < QT * dim4; i += THREADS) {
    const int t = i % QT, e4 = i / QT, l = l0 + t;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (present && l < Lq)
      v = reinterpret_cast<const float4*>(q + (size_t)l * dim)[e4];
    float* col = dst + (size_t)(4 * e4) * QT + t;
    col[0] = v.x;
    col[QT] = v.y;
    col[2 * QT] = v.z;
    col[3 * QT] = v.w;
  }
  for (int t = threadIdx.x; t < QT; t += THREADS)
    qv[t] = present && (l0 + t < Lq) && qm[l0 + t];
}

// MaxSim of the QB staged query tiles against one doc d [Ld, dim] with mask
// dm [Ld]: for each query, the sum over its tile's valid query tokens of the
// max over the doc's valid tokens (0 for a query token with no finite
// best). Called by the whole block; part[] is valid in thread 0.
template <int QB>
__device__ __forceinline__ void tile_doc_maxsim(const float* __restrict__ d,
                                const uint8_t* __restrict__ dm, int Ld,
                                int dim, const Tiles<QB>& s,
                                float part[QB]) {
  const int tid = threadIdx.x;
  const int tq = tid / NTD, td = tid % NTD;
  const int dim4 = dim >> 2, ds4 = (dim + 4) >> 2;
  float best[QB][TQ];
#pragma unroll
  for (int b = 0; b < QB; ++b)
#pragma unroll
    for (int i = 0; i < TQ; ++i) best[b][i] = -INFINITY;
  const float4* q4 = reinterpret_cast<const float4*>(s.q);
  float4* d4 = reinterpret_cast<float4*>(s.d);

  for (int t0 = 0; t0 < Ld; t0 += DT) {
    const int n = min(DT, Ld - t0);
    int valid = 0;
    for (int t = tid; t < DT; t += THREADS) {
      const int v = t < n && dm[t0 + t];
      s.dv[t] = v;
      valid |= v;
    }
    if (!__syncthreads_or(valid)) continue;          // all masked: skip
    // rows [t0, t0 + n) are contiguous in global memory: one coalesced
    // copy, STAGE loads in flight per thread before their stores
    const float4* src = reinterpret_cast<const float4*>(d + (size_t)t0 * dim);
    const int total = n * dim4;
    for (int i0 = tid; i0 < total; i0 += THREADS * STAGE) {
      float4 v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u)
        if (i0 + u * THREADS < total) v[u] = src[i0 + u * THREADS];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int i = i0 + u * THREADS;
        if (i < total) d4[(i / dim4) * ds4 + i % dim4] = v[u];
      }
    }
    __syncthreads();
    float acc[QB][TQ][TD];
#pragma unroll
    for (int b = 0; b < QB; ++b)
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[b][i][j] = 0.f;
    for (int k4 = 0; k4 < dim4; ++k4) {
      float4 dval[TD];
#pragma unroll
      for (int j = 0; j < TD; ++j) dval[j] = d4[(td + j * NTD) * ds4 + k4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int b = 0; b < QB; ++b) {
          const float4 a =
              q4[((size_t)b * dim + 4 * k4 + c) * (QT / 4) + tq];
          const float av[TQ] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int j = 0; j < TD; ++j)
              acc[b][i][j] = __fmaf_rn(av[i], comp(dval[j], c),
                                       acc[b][i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TD; ++j)
      if (s.dv[td + j * NTD])
#pragma unroll
        for (int b = 0; b < QB; ++b)
#pragma unroll
          for (int i = 0; i < TQ; ++i)
            best[b][i] = fmaxf(best[b][i], acc[b][i][j]);
    __syncthreads();                 // the next chunk overwrites the tiles
  }

  // max over the NTD threads sharing a query-token group (one half-warp)
#pragma unroll
  for (int b = 0; b < QB; ++b) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      float m = best[b][i];
#pragma unroll
      for (int o = NTD / 2; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (td == 0 && s.qv[b * QT + tq * TQ + i] && isfinite(m)) sum += m;
    }
    sum = warp_sum(sum);
    if ((tid & 31) == 0) s.red[b * (THREADS / 32) + (tid >> 5)] = sum;
  }
  __syncthreads();
  if (tid == 0)
#pragma unroll
    for (int b = 0; b < QB; ++b) {
      float total = 0.f;
      for (int w = 0; w < THREADS / 32; ++w)
        total += s.red[b * (THREADS / 32) + w];
      part[b] = total;
    }
  __syncthreads();                   // red is reused by the next doc
}

// PER_QUERY = false: docs d [Nd, Ld, dim] shared by all queries (all-pairs);
// PER_QUERY = true: docs d [Nq, Nd, Ld, dim], query i scores only d[i]
// (QB must be 1 then).
template <bool PER_QUERY, int QB>
__global__ void __launch_bounds__(THREADS) maxsim_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ qmask,
    const float* __restrict__ d, const uint8_t* __restrict__ dmask,
    float* __restrict__ out, int Nq, int Lq, int dim, int Nd, int Ld) {
  static_assert(!PER_QUERY || QB == 1, "per-query docs: one query a block");
  extern __shared__ __align__(16) float smem[];
  const Tiles<QB> s = carve<QB>(smem, dim);
  const int q0 = blockIdx.x * QB;
  const int nqt = max((Lq + QT - 1) / QT, 1);
  const size_t doc0 = PER_QUERY ? (size_t)q0 * Nd : 0;
  const int nblk = (Nd + DOCS_PER_BLOCK - 1) / DOCS_PER_BLOCK;
  for (int t = 0; t < nqt; ++t) {
    __syncthreads();                 // the previous tiles are no longer read
#pragma unroll
    for (int b = 0; b < QB; ++b) {
      const int qi = min(q0 + b, Nq - 1);
      stage_query(q + (size_t)qi * Lq * dim, qmask + (size_t)qi * Lq,
                  q0 + b < Nq, Lq, dim, t * QT, s.q + (size_t)b * dim * QT,
                  s.qv + b * QT);
    }
    __syncthreads();
    for (int blk = blockIdx.y; blk < nblk; blk += gridDim.y) {
      for (int j = 0; j < DOCS_PER_BLOCK; ++j) {
        const int n = blk * DOCS_PER_BLOCK + j;
        if (n >= Nd) break;                            // uniform
        const size_t doc = doc0 + n;
        float part[QB];
        tile_doc_maxsim<QB>(d + doc * Ld * dim, dmask + doc * Ld, Ld, dim, s,
                            part);
        if (threadIdx.x == 0)
#pragma unroll
          for (int b = 0; b < QB; ++b)
            if (q0 + b < Nq) {
              float* o = out + (size_t)(q0 + b) * Nd + n;
              *o = (t == 0 ? 0.f : *o) + part[b];
            }
      }
    }
  }
}

template <bool PER_QUERY, int QB>
int launch(const float* q, const uint8_t* qmask, const float* d,
           const uint8_t* dmask, float* out, int Nq, int Lq, int dim, int Nd,
           int Ld, void* stream) {
  const size_t smem = smem_bytes(QB, dim);
  cudaFuncSetAttribute(maxsim_kernel<PER_QUERY, QB>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int nblk = (Nd + DOCS_PER_BLOCK - 1) / DOCS_PER_BLOCK;
  dim3 grid((Nq + QB - 1) / QB, nblk < MAX_GRID_Y ? nblk : MAX_GRID_Y);
  if (Nq > 0 && Nd > 0)
    maxsim_kernel<PER_QUERY, QB>
        <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            q, qmask, d, dmask, out, Nq, Lq, dim, Nd, Ld);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the larger (all-pairs) entry needs at this dim.
extern "C" size_t maxsim_smem_bytes(int dim) {
  return smem_bytes(QB_ALL_PAIRS, dim);
}

// q [Nq, Lq, dim] f32; qmask [Nq, Lq] u8; d [Nd, Ld, dim] f32; dmask
// [Nd, Ld] u8 -> out [Nq, Nd] f32. dim % 4 == 0, 16-byte aligned rows.
// Returns cudaGetLastError().
extern "C" int maxsim_launch(const float* q, const uint8_t* qmask,
                             const float* d, const uint8_t* dmask,
                             float* out, int Nq, int Lq, int dim, int Nd,
                             int Ld, void* stream) {
  return launch<false, QB_ALL_PAIRS>(q, qmask, d, dmask, out, Nq, Lq, dim, Nd,
                                     Ld, stream);
}

// q [Nq, Lq, dim]; qmask [Nq, Lq]; d [Nq, S, Ld, dim]; dmask [Nq, S, Ld]
// -> out [Nq, S] f32. Returns cudaGetLastError().
extern "C" int maxsim_rerank_launch(const float* q, const uint8_t* qmask,
                                    const float* d, const uint8_t* dmask,
                                    float* out, int Nq, int Lq, int dim,
                                    int S, int Ld, void* stream) {
  return launch<true, 1>(q, qmask, d, dmask, out, Nq, Lq, dim, S, Ld, stream);
}
