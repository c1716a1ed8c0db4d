// MaxSim late-interaction scoring over f32 token vectors for Hopper (sm_90a).
//
// Two entries, one per TPU kernel of src/repro/kernels/maxsim/kernel.py:
//   * maxsim_launch replaces `maxsim_pallas` (`_maxsim_kernel`): all-pairs
//     scores q [Nq, Lq, dim] x d [Nd, Ld, dim] -> [Nq, Nd] (flat search,
//     PLAID's dense corpus-wide fallback, the cascade's first stage);
//   * maxsim_rerank_launch replaces `maxsim_rerank_pallas`
//     (`_maxsim_rerank_kernel`): each query against its own gathered
//     candidates d [Nq, S, Ld, dim] -> [Nq, S] (PLAID's rerank from the f32
//     reconstruction store, the cascade's second stage).
// Both compute sum_{valid q tokens} max_{valid d tokens} q . d; a masked doc
// token is -inf, and a query token that is masked or whose best is not
// finite contributes 0 (a doc with no valid token scores 0).
//
// All-pairs: bound by operations (each doc token is scored against every
// token of Nq queries: at Nq = 32, Lq = 32, dim = 128 ~40 FLOP per byte it
// must read). Its products run on the tensor cores as 3xTF32 (tf32.cuh:
// f32's accuracy over three TF32 passes). Design (`maxsim_tc_kernel`):
// - One flat stream of the valid doc rows of [Nd * Ld, dim]: masked rows
//   (a pooled document's padding) cost nothing. A block owns whole queries
//   (QR = 128 query rows: 128 / Lq queries) and a run of whole documents,
//   and walks the run's valid rows in tiles of up to TR = 128 that cross
//   document boundaries: the block lists a tile's rows two tiles ahead
//   (a ballot over 256 mask bytes a step), copies them by 16-byte cp.async
//   one tile ahead into a double buffer, and multiplies the current one.
//   blockIdx.x walks the query groups, so the blocks sharing a run of
//   documents run side by side and read it once from device memory.
// - The block's query rows are staged once. Warp (rg, cg) scores query
//   rows 64 rg .. + 63 against tile rows 32 cg .. + 31: per k-step of 8,
//   four A fragments (query rows) and four B fragments (doc rows) come from
//   shared memory by six `ldmatrix.x4` (a step ahead of their use) and are
//   split into TF32 hi and lo in registers, then 16 x 3 `mma.sync.m16n8k8`
//   (lo.hi + hi.lo + hi.hi) into f32 registers, each pass over all 16
//   tiles before the next, with no branch among them (a branch there cuts
//   the warp's instruction stream into blocks the compiler cannot
//   interleave). A warp past the tile's listed rows takes no product.
// - Segmented maxima from the accumulators. Where a warp's 32 listed rows
//   lie in at most two documents (always where documents hold 32 valid
//   rows or more), each side of the boundary reduces in registers and two
//   shuffles, then one shared-memory atomic max per query row and side
//   (floats ordered as integers); otherwise each value takes its own
//   atomic into its document's slot. A tile touches at most SLOTS
//   documents; one spanning two tiles carries its maxima into slot 0 of
//   the next tile's `best` (two sets of slots, one reset while the other
//   fills).
// - After a tile, each document that ended in it is summed over each
//   query's valid rows (a finite max only) by one warp and written; a
//   document without a valid row keeps the 0 the block wrote first.
// Shared memory holds the tensor-core body up to dim = 132; wider tokens
// take the f32 body below.
//
// Rerank (and all-pairs above dim 132): the f32 body, bound by bytes for
// the rerank (every gathered doc is read once for one query, ~16 FLOP per
// byte at Lq = 32). One block per (QB queries, run of DOCS_PER_BLOCK
// docs); blockIdx.x walks queries, so the blocks reading one doc run side
// by side and share it through L2, and each doc chunk staged in shared
// memory is scored against QB queries (2 for all-pairs; 1 for the rerank,
// whose docs belong to one query). Query tiles (QT tokens) are staged once
// per block, k-major ([dim][QT]); doc tokens are staged DT rows at a time
// as one contiguous, coalesced float4 copy into rows padded to dim + 4
// floats (bank-conflict-free float4 reads across rows). Each thread owns a
// TQ x TD tile of (query token, doc token) dot products per query in
// registers in plain f32 FMA, explicitly rounded so nvcc cannot
// reassociate them. Running maxima per query token are reduced over the
// block with shuffles and the sum goes through shared memory. Chunks whose
// doc tokens are all masked are skipped.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "quant.cuh"
#include "tf32.cuh"

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

// --- the all-pairs tensor-core body (3xTF32) --------------------------------

constexpr int TC_THREADS = 256;         // 8 warps: 2 query-row groups x 4
constexpr int TC_WARPS = TC_THREADS / 32;   // doc-row groups
constexpr int QR = 128;                 // query rows a block (whole queries)
constexpr int TR = 128;                 // valid doc rows a tile, at most
constexpr int WM = 4;                   // m-tiles a warp: 64 query rows
constexpr int WN = 4;                   // n-tiles a warp: 32 doc rows
constexpr int SLOTS = 16;               // documents a tile may touch
constexpr int MAX_SMEM = 232448;        // dynamic shared memory a block

__host__ __device__ constexpr size_t tc_smem_bytes(int dim) {
  return sizeof(float) * ((size_t)(QR + 2 * TR) * (dim + 4) +
                          (size_t)2 * SLOTS * QR) +
         sizeof(int) * (QR + 3 * 2 * TR + 3 + TC_WARPS + 1);
}

// Docs [n0, n0 + dpb) of d [Nd, Ld, dim] against queries [q0, q0 + QB) of
// q [Nq, Lq, dim] (Lq <= QR). DIM: the token width when known at compile
// time (the model's 128), so the k-loop unrolls; 0 takes it at run time.
template <int DIM>
__global__ void __launch_bounds__(TC_THREADS, 1) maxsim_tc_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ qmask,
    const float* __restrict__ d, const uint8_t* __restrict__ dmask,
    float* __restrict__ out, int Nq, int Lq, int width, int Nd, int Ld,
    int QB, int dpb) {
  const int dim = DIM > 0 ? DIM : width;
  const int DS = dim + 4;
  extern __shared__ int4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);             // [QR][DS]
  float* dt = qs + QR * DS;                                // [2][TR][DS]
  float* bests = dt + 2 * TR * DS;                   // [2][SLOTS][QR]
  int* qv = reinterpret_cast<int*>(bests + 2 * SLOTS * QR);   // [QR]
  int* lrow = qv + QR;              // [3][TR] a tile's listed rows (local)
  int* ldoc = lrow + 3 * TR;        // [3][TR] and their documents (local)
  int* lcnt = ldoc + 3 * TR;        // [3] listed rows a tile
  int* wcnt = lcnt + 3;             // [TC_WARPS] valid rows a warp saw
  int* cut = wcnt + TC_WARPS;       // [1] the last row a full list took

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rq = 64 * (warp >> 2), c0 = 32 * (warp & 3);
  const int q0 = blockIdx.x * QB;
  const int nq = min(QB, Nq - q0);
  const int nqrows = nq * Lq;
  const int n0 = blockIdx.y * dpb;
  const int nrun = min(Nd, n0 + dpb) - n0;
  const int rows = nrun * Ld;               // the run's rows; local from 0
  const size_t R0 = (size_t)n0 * Ld;
  const int dim4 = dim >> 2;

  // every score of the run 0: a document without a valid token keeps it
  for (int i = tid; i < nq * nrun; i += TC_THREADS)
    out[(size_t)(q0 + i / nrun) * Nd + n0 + i % nrun] = 0.f;
  // row pads (columns dim..dim + 3) zero: a k-step past dim reads zeros
  for (int r = tid; r < QR + 2 * TR; r += TC_THREADS)
    *reinterpret_cast<float4*>(qs + r * DS + dim) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  // the block's query rows are contiguous in q
  const float* qsrc = q + (size_t)q0 * Lq * dim;
  for (int i = tid; i < QR * dim4; i += TC_THREADS) {
    const int r = i / dim4, e = 4 * (i % dim4);
    if (r < nqrows)
      cp_async16(qs + r * DS + e, qsrc + (size_t)r * dim + e);
    else
      *reinterpret_cast<float4*>(qs + r * DS + e) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int r = tid; r < QR; r += TC_THREADS)
    qv[r] = r < nqrows && qmask[(size_t)q0 * Lq + r];
  for (int i = tid; i < 2 * SLOTS * QR; i += TC_THREADS) bests[i] = -INFINITY;

  // The next tile's list: the valid rows from the cursor on, at most TR,
  // within SLOTS documents of the cursor's, scanning TC_THREADS rows a
  // step (a ballot a warp, then a prefix over the warps) until one is
  // found or the run ends. Called by the whole block (it holds barriers);
  // the cursor stays the same in every thread.
  int cursor = 0;
  // this thread's mask byte of the next scan (row cursor + tid), read
  // early: a tile's products hide its latency
  auto peek = [&]() {
    return cursor + tid < rows ? (int)dmask[R0 + cursor + tid] : 0;
  };
  auto build = [&](int sl, int first) {
    int total = 0;
    for (int it = 0; it == 0 || cursor < rows; ++it) {   // barriers: >= 2
      const int cap = min(rows, (cursor / Ld + SLOTS) * Ld);
      const int r = cursor + tid;
      const bool v = r < cap && (it == 0 ? first : peek());
      const unsigned bal = __ballot_sync(0xffffffffu, v);
      if (lane == 0) wcnt[warp] = __popc(bal);
      __syncthreads();
      int before = 0;
      total = 0;
#pragma unroll
      for (int w = 0; w < TC_WARPS; ++w) {
        const int c = wcnt[w];
        before += w < warp ? c : 0;
        total += c;
      }
      const int pos = before + __popc(bal & ((1u << lane) - 1u));
      if (v && pos < TR) {
        lrow[sl * TR + pos] = r;
        ldoc[sl * TR + pos] = r / Ld;
      }
      if (v && pos == TR - 1) *cut = r;
      __syncthreads();                  // the list, cut; wcnt reusable
      cursor = total >= TR ? *cut + 1 : min(cursor + TC_THREADS, cap);
      if (total > 0) break;
    }
    if (tid == 0) lcnt[sl] = min(total, TR);
  };
  // tile j's listed rows into dt[j & 1] by 16-byte cp.async: warp w
  // copies rows 16 w .. 16 w + 15, a row a step
  auto issue = [&](int j) {
    const int sl = j % 3, cnt = lcnt[sl];
    float* dst = dt + (j & 1) * TR * DS;
    for (int i = 16 * warp; i < min(cnt, 16 * warp + 16); ++i) {
      const float* src = d + (R0 + lrow[sl * TR + i]) * dim;
      for (int e = lane; e < dim4; e += 32)
        cp_async16(dst + i * DS + 4 * e, src + 4 * e);
    }
    cp_async_commit();
  };

  build(0, peek());
  build(1, peek());
  __syncthreads();                    // both counts
  issue(0);
  // tile j's maxima go to best = bests[j & 1], whose slots the block reset
  // a tile before (and the next tile's, while this one multiplies)
  int used = -1;                      // slots the last tile used, less one
  for (int j = 0; lcnt[j % 3] > 0; ++j) {
    const int sl = j % 3, cnt = lcnt[sl];
    float* best = bests + (j & 1) * SLOTS * QR;
    float* next = bests + ((j + 1) & 1) * SLOTS * QR;
    cp_async_wait_all();
    __syncthreads();                  // tile j, its list and best settled
    if (lcnt[(j + 1) % 3] > 0) issue(j + 1);
    const int ahead = peek();
    if (tid < QR)
      for (int sd = 0; sd <= used; ++sd) next[sd * QR + tid] = -INFINITY;
    const float* tile = dt + (j & 1) * TR * DS;
    const int* td = ldoc + sl * TR;
    const int dlo = td[0], dlast = td[cnt - 1];

    // 1. scores of query rows rq.. against listed doc rows c0..
    if (c0 < cnt && rq < nqrows) {
      float acc[WM][WN][4];
#pragma unroll
      for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int n = 0; n < WN; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;
      // fragment rows of this lane for ldmatrix: A (m-tile m) row
      // rq + 16 m + l % 8 + 8 (l / 8 % 2), columns + 4 (l / 16); B (n-tiles
      // 2 p, 2 p + 1) row c0 + 16 p + l % 8 + 8 (l / 16), columns
      // + 4 (l / 8 % 2)
      const float* pa = qs + (rq + (lane & 7) + 8 * ((lane >> 3) & 1)) * DS +
                        4 * (lane >> 4);
      const float* pb = tile + (c0 + (lane & 7) + 8 * (lane >> 4)) * DS +
                        4 * ((lane >> 3) & 1);
      // raw values of the next k-step, read while this one multiplies
      uint32_t ra[WM][4], rb[WN / 2][4];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int m = 0; m < WM; ++m) ldmatrix_x4(ra[m], pa + 16 * m * DS + k0);
#pragma unroll
        for (int p = 0; p < WN / 2; ++p)
          ldmatrix_x4(rb[p], pb + 16 * p * DS + k0);
      };
      fetch(0);
#pragma unroll
      for (int k0 = 0; k0 < dim; k0 += 8) {
        uint32_t ah[WM][4], al[WM][4], bh[WN][2], bl[WN][2];
#pragma unroll
        for (int m = 0; m < WM; ++m)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            tf32_split(__uint_as_float(ra[m][r]), ah[m][r], al[m][r]);
#pragma unroll
        for (int n = 0; n < WN; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tf32_split(__uint_as_float(rb[n / 2][2 * (n % 2) + h]), bh[n][h],
                       bl[n][h]);
        if (k0 + 8 < dim) fetch(k0 + 8);
        // no branch among the products (query rows past the block's are
        // zeros, doc rows past the list are dropped below), and each pass
        // over all 16 accumulators before the next: a product waits for
        // the one before it on its accumulator
        mma_3xtf32_tiles<WM, WN>(acc, ah, al, bh, bl);
      }

      // 2. segmented maxima into best[document slot][query row]
      const int sfirst = td[c0] - dlo;
      const int slast = td[min(c0 + 31, cnt - 1)] - dlo;
      // columns of the warp's first document (the list is in row order)
      const int cb = __popc(__ballot_sync(
          0xffffffffu, c0 + lane < cnt && td[c0 + lane] == sfirst + dlo));
      if (slast == sfirst) {
        // the warp's 32 doc rows lie in one document (the common case):
        // per query row a max in registers, two shuffles, an atomic max
#pragma unroll
        for (int m = 0; m < WM; ++m)
#pragma unroll
          for (int u = 0; u < 2; ++u) {            // rows g, g + 8
            float mx = -INFINITY;
#pragma unroll
            for (int n = 0; n < WN; ++n)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                mx = c0 + 8 * n + 2 * t + h < cnt
                         ? fmaxf(mx, acc[m][n][2 * u + h]) : mx;
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const int row = rq + 16 * m + 8 * u + g;
            if (t == 0 && row < nqrows)
              atomic_max(best + sfirst * QR + row, mx);
          }
      } else if (slast - sfirst == 1) {
        // two documents (always so, or one, where documents hold 32
        // valid rows or more): the same for each side of the boundary
#pragma unroll
        for (int m = 0; m < WM; ++m)
#pragma unroll
          for (int u = 0; u < 2; ++u) {            // rows g, g + 8
            float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
            for (int n = 0; n < WN; ++n)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int col = 8 * n + 2 * t + h;
                const float v = acc[m][n][2 * u + h];
                ma = col < cb ? fmaxf(ma, v) : ma;
                mb = col >= cb && c0 + col < cnt ? fmaxf(mb, v) : mb;
              }
#pragma unroll
            for (int o = 1; o < 4; o <<= 1) {
              ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
              mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
            }
            const int row = rq + 16 * m + 8 * u + g;
            if (t == 0 && row < nqrows) {
              if (ma > -INFINITY) atomic_max(best + sfirst * QR + row, ma);
              if (mb > -INFINITY)
                atomic_max(best + (sfirst + 1) * QR + row, mb);
            }
          }
      } else {
        // documents with few valid rows: an atomic per value
#pragma unroll
        for (int n = 0; n < WN; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = c0 + 8 * n + 2 * t + h;
            if (col >= cnt) continue;
            const int sd = td[col] - dlo;
#pragma unroll
            for (int m = 0; m < WM; ++m)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int row = rq + 16 * m + 8 * u + g;
                if (row < nqrows)
                  atomic_max(best + sd * QR + row, acc[m][n][2 * u + h]);
              }
          }
      }
    }

    // the list two tiles ahead (its barriers also settle every maximum
    // of this tile)
    build((j + 2) % 3, ahead);

    // 3. documents this tile finished (all before the next tile's first):
    // one warp a (document, query)
    const int dnext = lcnt[(j + 1) % 3] > 0 ? ldoc[((j + 1) % 3) * TR] : nrun;
    const int nfin = min(dlast, dnext - 1) - dlo + 1;
    for (int p = warp; p < nfin * nq; p += TC_WARPS) {
      const int sd = p / nq, qq = p % nq;
      float part = 0.f;
      for (int l = lane; l < Lq; l += 32) {
        const int r = qq * Lq + l;
        const float b = best[sd * QR + r];
        if (qv[r] && isfinite(b)) part += b;
      }
      part = warp_sum(part);
      if (lane == 0) out[(size_t)(q0 + qq) * Nd + n0 + dlo + sd] = part;
    }
    // a document that runs on into the next tile: slot 0 of the next best
    if (dlast == dnext && tid < QR) next[tid] = best[(dlast - dlo) * QR + tid];
    used = dlast - dlo;
  }
}

template <int DIM>
int launch_tc(const float* q, const uint8_t* qmask, const float* d,
              const uint8_t* dmask, float* out, int Nq, int Lq, int dim,
              int Nd, int Ld, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int QB = min(Nq, QR / Lq);
  const int groups = (Nq + QB - 1) / QB;
  // one wave: the runs of documents times the query groups fill the SMs
  const int runs0 = min(Nd, max(1, sms / groups));
  const int dpb = (Nd + runs0 - 1) / runs0;
  const int runs = (Nd + dpb - 1) / dpb;
  const size_t smem = tc_smem_bytes(dim);
  cudaFuncSetAttribute(maxsim_tc_kernel<DIM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(groups, runs);
  maxsim_tc_kernel<DIM><<<grid, TC_THREADS, smem, stream>>>(
      q, qmask, d, dmask, out, Nq, Lq, dim, Nd, Ld, QB, dpb);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory the all-pairs entry needs at this dim (the
// tensor-core body where it fits, else the f32 body).
extern "C" size_t maxsim_smem_bytes(int dim) {
  return tc_smem_bytes(dim) <= MAX_SMEM ? tc_smem_bytes(dim)
                                        : smem_bytes(QB_ALL_PAIRS, dim);
}

// q [Nq, Lq, dim] f32; qmask [Nq, Lq] u8; d [Nd, Ld, dim] f32; dmask
// [Nd, Ld] u8 -> out [Nq, Nd] f32. dim % 4 == 0, 16-byte aligned rows,
// Nd * Ld < 2^31; Lq <= 128 where the tensor-core body runs (dim <= 132:
// the wrapper splits longer queries). Returns cudaGetLastError()
// (cudaErrorInvalidValue outside those limits).
extern "C" int maxsim_launch(const float* q, const uint8_t* qmask,
                             const float* d, const uint8_t* dmask,
                             float* out, int Nq, int Lq, int dim, int Nd,
                             int Ld, void* stream) {
  if (tc_smem_bytes(dim) > MAX_SMEM)
    return launch<false, QB_ALL_PAIRS>(q, qmask, d, dmask, out, Nq, Lq, dim,
                                       Nd, Ld, stream);
  cudaStream_t s = (cudaStream_t)stream;
  if (dim % 4 != 0 || Lq > QR || (long long)Nd * Ld >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (Nq == 0 || Nd == 0) return (int)cudaGetLastError();
  if (Lq == 0 || Ld == 0) {               // no token anywhere: every score 0
    cudaMemsetAsync(out, 0, sizeof(float) * (size_t)Nq * Nd, s);
    return (int)cudaGetLastError();
  }
  return dim == 128 ? launch_tc<128>(q, qmask, d, dmask, out, Nq, Lq, dim,
                                     Nd, Ld, s)
                    : launch_tc<0>(q, qmask, d, dmask, out, Nq, Lq, dim, Nd,
                                   Ld, s);
}

// q [Nq, Lq, dim]; qmask [Nq, Lq]; d [Nq, S, Ld, dim]; dmask [Nq, S, Ld]
// -> out [Nq, S] f32. Returns cudaGetLastError().
extern "C" int maxsim_rerank_launch(const float* q, const uint8_t* qmask,
                                    const float* d, const uint8_t* dmask,
                                    float* out, int Nq, int Lq, int dim,
                                    int S, int Ld, void* stream) {
  return launch<true, 1>(q, qmask, d, dmask, out, Nq, Lq, dim, S, Ld, stream);
}
