// MaxSim late-interaction scoring over f32 token vectors for Hopper (sm_90a).
//
// Three entries, for the two TPU kernels of src/repro/kernels/maxsim/kernel.py:
//   * maxsim_launch replaces `maxsim_pallas` (`_maxsim_kernel`): all-pairs
//     scores q [Nq, Lq, dim] x d [Nd, Ld, dim] -> [Nq, Nd] (flat search,
//     PLAID's dense corpus-wide fallback, the cascade's first stage);
//   * maxsim_rerank_launch replaces `maxsim_rerank_pallas`
//     (`_maxsim_rerank_kernel`): each query against its own gathered
//     candidates d [Nq, S, Ld, dim] -> [Nq, S];
//   * maxsim_rerank_indexed_launch computes the same function as the JAX
//     package's candidate gather followed by `maxsim_rerank_pallas`, reading
//     the candidates in place: d [Nd, Ld, dim] is a store's padded view and
//     cand [Nq, S] the ids of each query's candidates (PLAID's rerank from
//     the f32 reconstruction store, the cascade's second stage), so the
//     [Nq, S, Ld, dim] gather is never written. An invalid candidate
//     (cand_mask false) scores 0 and no row of it is read, whatever id it
//     holds.
// All compute sum_{valid q tokens} max_{valid d tokens} q . d; a masked doc
// token is -inf, and a query token that is masked or whose best is not
// finite contributes 0 (a doc with no valid token scores 0).
//
// What bounds them on this card. All-pairs: operations (each doc token is
// scored against every token of Nq queries: at Nq = 32, Lq = 32,
// dim = 128 ~40 FLOP per byte it must read). Rerank: bytes (each candidate
// row is read for one query: Lq / 2 FLOP per byte, 16 at Lq = 32, under
// the ~50 at which 3xTF32 products at the TF32 peak take as long as the
// bytes). Both run one tensor-core body (`maxsim_tc_kernel`), whose products
// are 3xTF32 (tf32.cuh: f32's accuracy over three TF32 passes):
// - One stream of the valid doc rows of a block's run of documents: masked
//   rows (a pooled document's padding, ~20%) and documents whose candidate
//   is invalid are never read. A block owns whole queries and a run of
//   whole documents (all-pairs: QR / Lq queries against documents shared by
//   all; rerank: one query against a run of its own candidates), and walks
//   the run's valid rows in tiles of up to TR rows (`Shape`: 128, or 64 at
//   QR = 32) that cross document boundaries: the block lists a tile's rows
//   ahead (a ballot over a mask byte a thread a step; in the indexed layout
//   each document's rows start at cand[i, s] * Ld) and copies them by
//   16-byte cp.async into a ring of NBUF tile buffers (three at QR = 32,
//   else two). While the block multiplies tile j, the tiles after it land,
//   and each warp copies its rows of tile j + NBUF - 1 a row a k-step,
//   between its products. Measured on the rerank (NVIDIA H100 80GB HBM3,
//   S = 1,024, 1.51 GB of valid rows): with a tile's copies asked in one
//   burst after the products, the burst stalled every warp once the SM's
//   copies in flight were at their limit, and the device then idled
//   during the products (0.88 ms); spread over the k-steps, 0.80 ms; with
//   two blocks of four warps a SM at QR = 32 (one block's lists and
//   barriers overlap the other's products), 0.72 ms. (TMA bulk copies of
//   a 512-byte row each: 1.36 ms; their cost is per request.)
//   blockIdx.x walks the queries (groups), so the all-pairs blocks sharing a
//   run of documents run side by side and read it once from device memory.
// - The block's query rows: QR = 128 for all-pairs, and for the rerank the
//   smallest of 32, 64, 128 that holds Lq, so that every warp multiplies
//   document rows (QR = 128 would waste 3/4 of the products at Lq = 32).
//   Warps form RG groups along the query rows and CG along a tile's rows
//   (`Shape`). At QR = 32 each warp's query fragments (16 rows, hi and lo)
//   stay in registers for the whole kernel, read once from device memory,
//   so shared memory carries only doc rows and holds a third tile buffer;
//   above, they are held raw in shared memory. Per k-step of 8 a warp
//   loads its fragments from shared memory by `ldmatrix.x4` (a step ahead
//   of their use), splits raw values into TF32 hi and lo in registers, and
//   issues 3 WM WN `mma.sync.m16n8k8` (lo.hi + hi.lo + hi.hi) into f32
//   registers, each pass over all its tiles before the next, with no
//   branch among them (a branch there cuts the warp's instruction stream
//   into blocks the compiler cannot interleave). A warp past the tile's
//   listed rows takes no product.
// - Segmented maxima from the accumulators. Where a warp's listed rows lie
//   in at most two documents (always where documents hold as many valid
//   rows as a warp takes), each side of the boundary reduces in registers
//   and two shuffles, then one shared-memory atomic max per query row and
//   side (floats ordered as integers); otherwise each value takes its own
//   atomic into its document's slot. A tile touches at most SLOTS
//   documents; one spanning two tiles carries its maxima into slot 0 of the
//   next tile's `best` (two sets of slots, one reset while the other fills).
// - After a tile, each document that ended in it is summed over each
//   query's valid rows (a finite max only) by one warp and written; a
//   document without a valid row keeps the 0 the block wrote first.
// Shared memory holds the tensor-core body up to dim = 132; wider tokens
// take the f32 body below (both layouts of the rerank too).
//
// The f32 body: one block per (QB queries, run of DOCS_PER_BLOCK docs);
// blockIdx.x walks queries, so the blocks reading one doc run side by side
// and share it through L2, and each doc chunk staged in shared memory is
// scored against QB queries (2 for all-pairs; 1 for the rerank, whose docs
// belong to one query). Query tiles (QT tokens) are staged once per block,
// k-major ([dim][QT]); doc tokens are staged DT rows at a time as one
// contiguous, coalesced float4 copy into rows padded to dim + 4 floats
// (bank-conflict-free float4 reads across rows). Each thread owns a TQ x TD
// tile of (query token, doc token) dot products per query in registers in
// plain f32 FMA, explicitly rounded so nvcc cannot reassociate them. Running
// maxima per query token are reduced over the block with shuffles and the
// sum goes through shared memory. Chunks whose doc tokens are all masked
// are skipped.
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
// PER_QUERY = true: query i scores only its own Nd candidates (QB must be 1
// then): gathered, d [Nq, Nd, Ld, dim], where cand is null; indexed,
// candidate s the store's document cand[i, s] of d [*, Ld, dim] where
// cmask[i, s] (else it scores 0 unread).
template <bool PER_QUERY, int QB>
__global__ void __launch_bounds__(THREADS) maxsim_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ qmask,
    const float* __restrict__ d, const uint8_t* __restrict__ dmask,
    const int64_t* __restrict__ cand, const uint8_t* __restrict__ cmask,
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
        size_t doc = doc0 + n;
        bool present = true;                           // uniform
        if (PER_QUERY && cand != nullptr) {
          present = cmask[doc];
          doc = present ? (size_t)cand[doc] : 0;
        }
        float part[QB];
        if (present)
          tile_doc_maxsim<QB>(d + doc * Ld * dim, dmask + doc * Ld, Ld, dim,
                              s, part);
        else
#pragma unroll
          for (int b = 0; b < QB; ++b) part[b] = 0.f;
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
           const uint8_t* dmask, const int64_t* cand, const uint8_t* cmask,
           float* out, int Nq, int Lq, int dim, int Nd, int Ld,
           void* stream) {
  const size_t smem = smem_bytes(QB, dim);
  cudaFuncSetAttribute(maxsim_kernel<PER_QUERY, QB>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int nblk = (Nd + DOCS_PER_BLOCK - 1) / DOCS_PER_BLOCK;
  dim3 grid((Nq + QB - 1) / QB, nblk < MAX_GRID_Y ? nblk : MAX_GRID_Y);
  if (Nq > 0 && Nd > 0)
    maxsim_kernel<PER_QUERY, QB>
        <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            q, qmask, d, dmask, cand, cmask, out, Nq, Lq, dim, Nd, Ld);
  return (int)cudaGetLastError();
}

// --- the tensor-core body (3xTF32) -----------------------------------------

// how a block's documents are laid out
enum Layout : int {
  ALL_PAIRS = 0,    // d [Nd, Ld, dim], shared by all queries
  GATHERED = 1,     // d [Nq, S, Ld, dim], query i's own candidates
  INDEXED = 2,      // d [*, Ld, dim], query i's candidate s at cand[i, s]
};

constexpr int MAX_QR = 128;             // query rows a block, at most
constexpr int SLOTS = 16;               // documents a tile may touch
constexpr int MAX_SMEM = 232448;        // dynamic shared memory a block

// A block holding QR query rows: at QR = 32 (the rerank at ColBERT's query
// length) four warps and tiles of 64 rows, two blocks a SM, so that one
// block's products run while the other lists its next tile and waits at
// its barriers; else eight warps and tiles of 128, one block a SM. A warp
// copies 16 rows of each tile.
template <int QR>
struct Shape {
  static constexpr int THREADS = QR == 32 ? 128 : 256;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int TR = 16 * WARPS;       // valid doc rows a tile, at most
  static constexpr int PER_SM = QR == 32 ? 2 : 1;
  // Warps form RG groups along the query rows times CG along a tile's doc
  // rows, each WM m-tiles (16 query rows) by WN n-tiles (8 doc rows): 64 x
  // 32 at QR = 128 (2 x 4 warps), 16 x 32 at QR = 32 (2 x 2), 64 x 16 at
  // QR = 64 (1 x 8).
  static constexpr int RG = QR == 64 ? 1 : 2;
  static constexpr int CG = WARPS / RG;
  static constexpr int WM = QR / RG / 16;
  static constexpr int WN = TR / CG / 8;
  static constexpr int WC = 8 * WN;     // doc rows a warp
  static_assert(WM >= 1 && WN % 2 == 0 && WC <= 32, "warp tiles");
};

// Planes of query rows in shared memory: one, raw, or none at QR = 32,
// where each warp holds its query fragments in registers (at the model's
// width only).
__host__ __device__ constexpr int q_planes(int QR) {
  return QR == 32 ? 0 : 1;
}

// Tile buffers (a ring): three where the query takes no shared memory.
__host__ __device__ constexpr int n_bufs(int QR) { return QR == 32 ? 3 : 2; }

template <int QR>
constexpr size_t tc_smem_bytes(int dim) {
  constexpr int TR = Shape<QR>::TR, WARPS = Shape<QR>::WARPS;
  return sizeof(float) * ((size_t)(q_planes(QR) * QR + n_bufs(QR) * TR) *
                              (dim + 4) +
                          (size_t)2 * SLOTS * QR) +
         sizeof(int) * (QR + 2 * (n_bufs(QR) + 1) * TR + WARPS + 1);
}

// Docs [n0, n0 + dpb) against queries [q0, q0 + QB) (Lq <= QR); `layout`
// says where a doc's rows lie (Layout; for the rerank Nd is S and QB 1).
// DIM: the token width when known at compile time (the model's 128), so
// the k-loop unrolls; 0 takes it at run time.
template <int DIM, int QR>
__global__ void __launch_bounds__(Shape<QR>::THREADS, Shape<QR>::PER_SM)
maxsim_tc_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ qmask,
    const float* __restrict__ d, const uint8_t* __restrict__ dmask,
    const int64_t* __restrict__ cand, const uint8_t* __restrict__ cmask,
    float* __restrict__ out, int layout, int Nq, int Lq, int width, int Nd,
    int Ld, int QB, int dpb) {
  using W = Shape<QR>;
  constexpr int WM = W::WM, WN = W::WN, WC = W::WC;
  constexpr int TC_THREADS = W::THREADS, TC_WARPS = W::WARPS, TR = W::TR;
  // a warp's query fragments held in registers for the whole kernel (one
  // m-tile at the model's width: 2 x 64 a lane), so that shared memory
  // carries only doc rows
  constexpr bool QREG = q_planes(QR) == 0;
  static_assert(!QREG || (WM == 1 && DIM > 0), "query fragments a warp");
  constexpr int NBUF = n_bufs(QR), NL = NBUF + 1;   // tile buffers, lists
  const int dim = DIM > 0 ? DIM : width;
  const int DS = dim + 4;
  extern __shared__ int4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);             // [QR][DS] or none
  float* dt = qs + q_planes(QR) * QR * DS;              // [NBUF][TR][DS]
  float* bests = dt + NBUF * TR * DS;                // [2][SLOTS][QR]
  int* qv = reinterpret_cast<int*>(bests + 2 * SLOTS * QR);   // [QR]
  int* lrow = qv + QR;              // [NL][TR] a tile's listed rows (of d)
  int* ldoc = lrow + NL * TR;       // [NL][TR] and their documents (local)
  int* wcnt = ldoc + NL * TR;       // [TC_WARPS] valid rows a warp saw
  int* cut = wcnt + TC_WARPS;       // [1] the last row a full list took

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rq = (QR / W::RG) * (warp / W::CG), c0 = WC * (warp % W::CG);
  const int q0 = blockIdx.x * QB;
  const int nq = min(QB, Nq - q0);
  const int nqrows = nq * Lq;
  const int n0 = blockIdx.y * dpb;
  const int nrun = min(Nd, n0 + dpb) - n0;
  const int rows = nrun * Ld;               // the run's rows; local from 0
  // the run's first candidate slot (per-query layouts) and first row of d
  // (the contiguous layouts)
  const size_t slot0 = (size_t)q0 * Nd + n0;
  const size_t R0 = (layout == ALL_PAIRS ? (size_t)n0 : slot0) * Ld;
  const int dim4 = dim >> 2;

  // every score of the run 0: a document without a valid token keeps it
  for (int i = tid; i < nq * nrun; i += TC_THREADS)
    out[(size_t)(q0 + i / nrun) * Nd + n0 + i % nrun] = 0.f;
  // row pads (columns dim..dim + 3) zero: a k-step past dim reads zeros
  for (int r = tid; r < q_planes(QR) * QR + NBUF * TR; r += TC_THREADS)
    *reinterpret_cast<float4*>(qs + r * DS + dim) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  // the block's query rows are contiguous in q
  const float* qsrc = q + (size_t)q0 * Lq * dim;
  for (int i = tid; i < (QREG ? 0 : QR * dim4); i += TC_THREADS) {
    const int r = i / dim4, e = 4 * (i % dim4);
    if (r < nqrows) {
      cp_async16(qs + r * DS + e, qsrc + (size_t)r * dim + e);
    } else {
      *reinterpret_cast<float4*>(qs + r * DS + e) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int r = tid; r < QR; r += TC_THREADS)
    qv[r] = r < nqrows && qmask[(size_t)q0 * Lq + r];
  for (int i = tid; i < 2 * SLOTS * QR; i += TC_THREADS) bests[i] = -INFINITY;

  // The row of d behind local row r of the run where it is a valid token,
  // else -1: contiguous layouts R0 + r; indexed, row r % Ld of the store's
  // document cand[slot] (an invalid candidate's id is never read).
  auto row_of = [&](int r) -> int {
    if (layout != INDEXED) return dmask[R0 + r] ? (int)(R0 + r) : -1;
    const int doc = r / Ld;
    if (!cmask[slot0 + doc]) return -1;
    const int gr = (int)cand[slot0 + doc] * Ld + (r - doc * Ld);
    return dmask[gr] ? gr : -1;
  };
  // The next tile's list: the valid rows from the cursor on, at most TR,
  // within SLOTS documents of the cursor's, scanning TC_THREADS rows a
  // step (a ballot a warp, then a prefix over the warps) until one is
  // found or the run ends. Called by the whole block (it holds barriers);
  // the cursor stays the same in every thread.
  int cursor = 0;
  // this thread's row of the next scan (row cursor + tid), read early: a
  // tile's products hide its latency
  auto peek = [&]() { return cursor + tid < rows ? row_of(cursor + tid) : -1; };
  // Returns the list's count (the same in every thread).
  auto build = [&](int sl, int first) {
    int total = 0;
    for (int it = 0; it == 0 || cursor < rows; ++it) {   // barriers: >= 2
      const int cap = min(rows, (cursor / Ld + SLOTS) * Ld);
      const int r = cursor + tid;
      const int gr = r < cap ? (it == 0 ? first : peek()) : -1;
      const bool v = gr >= 0;
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
        lrow[sl * TR + pos] = gr;
        ldoc[sl * TR + pos] = r / Ld;
      }
      if (v && pos == TR - 1) *cut = r;
      __syncthreads();                  // the list, cut; wcnt reusable
      cursor = total >= TR ? *cut + 1 : min(cursor + TC_THREADS, cap);
      if (total > 0) break;
    }
    return min(total, TR);
  };
  // row i of tile j (of cnt listed rows) into buffer j % NBUF by 16-byte
  // cp.async; warp w copies rows 16 w .. 16 w + 15 of each tile
  auto copy_row = [&](int j, int cnt, int i) {
    if (i >= cnt) return;
    const float* src = d + (size_t)lrow[(j % NL) * TR + i] * dim;
    float* dst = dt + ((j % NBUF) * TR + i) * DS;
    for (int e = lane; e < dim4; e += 32)
      cp_async16(dst + 4 * e, src + 4 * e);
  };

  // listed rows of tiles j .. j + NBUF - 1; tiles 0 .. NBUF - 2 copied
  // now, a group each (the first with the all-pairs query rows)
  int c[NBUF];
#pragma unroll
  for (int b = 0; b < NBUF; ++b) c[b] = build(b, peek());
#pragma unroll
  for (int b = 0; b + 1 < NBUF; ++b) {
    for (int i = 0; i < 16; ++i) copy_row(b, c[b], 16 * warp + i);
    cp_async_commit();
  }
  // this lane's fragments of the warp's query rows, every k-step (QREG),
  // straight from device memory: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
  // a3 (g + 8, t + 4) of each 16 x 8 step, split as ldmatrix would give them
  uint32_t qh[QREG ? DIM / 8 : 1][4], ql[QREG ? DIM / 8 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int k = 0; k < DIM / 8; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rq + g + 8 * (i & 1), e = 8 * k + t + 4 * (i >> 1);
        tf32_split(r < nqrows ? qsrc[(size_t)r * DIM + e] : 0.f, qh[k][i],
                   ql[k][i]);
      }
  }
  // While the block multiplies tile j, tiles j + 1 .. j + NBUF - 2 land
  // and each warp copies its rows of tile j + NBUF - 1, a row a k-step,
  // into the buffer of tile j - 1 (a group an iteration, empty past the
  // end): the copies never wait in one burst, and the device keeps being
  // asked for rows while the tensor cores work. Tile j's maxima go to
  // best = bests[j & 1], whose slots the block reset a tile before (and
  // the next tile's, while this one multiplies).
  int used = -1;                      // slots the last tile used, less one
  for (int j = 0; c[0] > 0; ++j) {
    const int sl = j % NL, cnt = c[0];
    float* best = bests + (j & 1) * SLOTS * QR;
    float* next = bests + ((j + 1) & 1) * SLOTS * QR;
    cp_async_wait<NBUF - 2>();        // tile j landed (this thread's rows)
    __syncthreads();                  // all of it, its list and best settled
    const int jn = j + NBUF - 1, cn1 = c[NBUF - 1];   // the tile to copy
    int copied = 0;                   // of this warp's 16 rows of it
    const int ahead = peek();
    if (tid < QR)
      for (int sd = 0; sd <= used; ++sd) next[sd * QR + tid] = -INFINITY;
    const float* tile = dt + (j % NBUF) * TR * DS;
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
        for (int m = 0; m < WM && !QREG; ++m)
          ldmatrix_x4(ra[m], pa + 16 * m * DS + k0);
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
          for (int r = 0; r < 4; ++r) {
            if constexpr (QREG) {
              ah[m][r] = qh[k0 / 8][r];
              al[m][r] = ql[k0 / 8][r];
            } else {
              tf32_split(__uint_as_float(ra[m][r]), ah[m][r], al[m][r]);
            }
          }
#pragma unroll
        for (int n = 0; n < WN; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tf32_split(__uint_as_float(rb[n / 2][2 * (n % 2) + h]), bh[n][h],
                       bl[n][h]);
        if (k0 + 8 < dim) fetch(k0 + 8);
        if (copied < 16) copy_row(jn, cn1, 16 * warp + copied++);
        // no branch among the products (query rows past the block's are
        // zeros, doc rows past the list are dropped below), and each pass
        // over all accumulators before the next: a product waits for the
        // one before it on its accumulator
        mma_3xtf32_tiles<WM, WN>(acc, ah, al, bh, bl);
      }

      // 2. segmented maxima into best[document slot][query row]
      const int sfirst = td[c0] - dlo;
      const int slast = td[min(c0 + WC - 1, cnt - 1)] - dlo;
      // columns of the warp's first document (the list is in row order)
      const int cb = __popc(__ballot_sync(
          0xffffffffu,
          lane < WC && c0 + lane < cnt && td[c0 + lane] == sfirst + dlo));
      if (slast == sfirst) {
        // the warp's doc rows lie in one document (the common case): per
        // query row a max in registers, two shuffles, an atomic max
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
        // two documents (always so, or one, where documents hold WC valid
        // rows or more): the same for each side of the boundary
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

    while (copied < 16) copy_row(jn, cn1, 16 * warp + copied++);
    cp_async_commit();
    // the list NBUF tiles ahead (its barriers also settle every maximum
    // of this tile, and free its buffer for tile j + NBUF)
    const int cn = build((j + NBUF) % NL, ahead);

    // 3. documents this tile finished (all before the next tile's first):
    // one warp a (document, query)
    const int dnext = c[1] > 0 ? ldoc[((j + 1) % NL) * TR] : nrun;
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
#pragma unroll
    for (int b = 0; b + 1 < NBUF; ++b) c[b] = c[b + 1];
    c[NBUF - 1] = cn;
  }
}

template <int DIM, int QR>
int launch_tc(const float* q, const uint8_t* qmask, const float* d,
              const uint8_t* dmask, const int64_t* cand, const uint8_t* cmask,
              float* out, int layout, int Nq, int Lq, int dim, int Nd, int Ld,
              cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int QB = layout == ALL_PAIRS ? min(Nq, QR / Lq) : 1;
  const int groups = (Nq + QB - 1) / QB;
  // one wave: the runs of documents times the query groups fill the SMs
  const int runs0 = min(Nd, max(1, Shape<QR>::PER_SM * sms / groups));
  const int dpb = (Nd + runs0 - 1) / runs0;
  const int runs = (Nd + dpb - 1) / dpb;
  const size_t smem = tc_smem_bytes<QR>(dim);
  cudaFuncSetAttribute(maxsim_tc_kernel<DIM, QR>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(groups, runs);
  constexpr int threads = Shape<QR>::THREADS;
  maxsim_tc_kernel<DIM, QR><<<grid, threads, smem, stream>>>(
      q, qmask, d, dmask, cand, cmask, out, layout, Nq, Lq, dim, Nd, Ld, QB,
      dpb);
  return (int)cudaGetLastError();
}

// The tensor-core body for `layout`: QR = 128 for all-pairs; for the
// rerank the smallest of 32, 64, 128 rows that holds Lq at the model's
// width (other widths take 128).
int run_tc(const float* q, const uint8_t* qmask, const float* d,
           const uint8_t* dmask, const int64_t* cand, const uint8_t* cmask,
           float* out, int layout, int Nq, int Lq, int dim, int Nd, int Ld,
           cudaStream_t s) {
  if (dim != 128)
    return launch_tc<0, 128>(q, qmask, d, dmask, cand, cmask, out, layout,
                             Nq, Lq, dim, Nd, Ld, s);
  if (layout != ALL_PAIRS && Lq <= 32)
    return launch_tc<128, 32>(q, qmask, d, dmask, cand, cmask, out, layout,
                              Nq, Lq, dim, Nd, Ld, s);
  if (layout != ALL_PAIRS && Lq <= 64)
    return launch_tc<128, 64>(q, qmask, d, dmask, cand, cmask, out, layout,
                              Nq, Lq, dim, Nd, Ld, s);
  return launch_tc<128, 128>(q, qmask, d, dmask, cand, cmask, out, layout,
                             Nq, Lq, dim, Nd, Ld, s);
}

// Shared checks and edge cases of the three entries, then the tensor-core
// body. `rows`: the rows of d a valid row index may reach (< 2^31).
int score(const float* q, const uint8_t* qmask, const float* d,
          const uint8_t* dmask, const int64_t* cand, const uint8_t* cmask,
          float* out, int layout, int Nq, int Lq, int dim, int Nd, int Ld,
          long long rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dim % 4 != 0 || Lq > MAX_QR || rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (Nq == 0 || Nd == 0) return (int)cudaGetLastError();
  if (Lq == 0 || Ld == 0) {               // no token anywhere: every score 0
    cudaMemsetAsync(out, 0, sizeof(float) * (size_t)Nq * Nd, s);
    return (int)cudaGetLastError();
  }
  return run_tc(q, qmask, d, dmask, cand, cmask, out, layout, Nq, Lq, dim,
                Nd, Ld, s);
}

bool f32_body(int dim) { return tc_smem_bytes<MAX_QR>(dim) > MAX_SMEM; }

}  // namespace

// Dynamic shared memory the entries need at this dim (the tensor-core
// body where it fits, else the f32 body).
extern "C" size_t maxsim_smem_bytes(int dim) {
  return f32_body(dim) ? smem_bytes(QB_ALL_PAIRS, dim)
                       : tc_smem_bytes<MAX_QR>(dim);
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
  if (f32_body(dim))
    return launch<false, QB_ALL_PAIRS>(q, qmask, d, dmask, nullptr, nullptr,
                                       out, Nq, Lq, dim, Nd, Ld, stream);
  return score(q, qmask, d, dmask, nullptr, nullptr, out, ALL_PAIRS, Nq, Lq,
               dim, Nd, Ld, (long long)Nd * Ld, stream);
}

// q [Nq, Lq, dim]; qmask [Nq, Lq]; d [Nq, S, Ld, dim]; dmask [Nq, S, Ld]
// -> out [Nq, S] f32. The limits of maxsim_launch, with Nq * S * Ld
// < 2^31. Returns cudaGetLastError().
extern "C" int maxsim_rerank_launch(const float* q, const uint8_t* qmask,
                                    const float* d, const uint8_t* dmask,
                                    float* out, int Nq, int Lq, int dim,
                                    int S, int Ld, void* stream) {
  if (f32_body(dim))
    return launch<true, 1>(q, qmask, d, dmask, nullptr, nullptr, out, Nq, Lq,
                           dim, S, Ld, stream);
  return score(q, qmask, d, dmask, nullptr, nullptr, out, GATHERED, Nq, Lq,
               dim, S, Ld, (long long)Nq * S * Ld, stream);
}

// q [Nq, Lq, dim]; qmask [Nq, Lq]; d [Nd, Ld, dim] and dmask [Nd, Ld] (a
// store's padded view); cand [Nq, S] i64 document ids, each in [0, Nd)
// where cmask [Nq, S] u8 holds -> out [Nq, S] f32: query i against the
// documents cand[i, s], 0 where cmask[i, s] is false (cand[i, s] unread).
// The limits of maxsim_launch. Returns cudaGetLastError().
extern "C" int maxsim_rerank_indexed_launch(
    const float* q, const uint8_t* qmask, const float* d,
    const uint8_t* dmask, const int64_t* cand, const uint8_t* cmask,
    float* out, int Nq, int Lq, int dim, int Nd, int S, int Ld,
    void* stream) {
  if (f32_body(dim))
    return launch<true, 1>(q, qmask, d, dmask, cand, cmask, out, Nq, Lq, dim,
                           S, Ld, stream);
  return score(q, qmask, d, dmask, cand, cmask, out, INDEXED, Nq, Lq, dim, S,
               Ld, (long long)Nd * Ld, stream);
}
