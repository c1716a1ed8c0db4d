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
// 4 + 4W + 1 bytes per doc token (W = dim*b/32 words). The products run
// on the tensor cores as 3xTF32 (three TF32 passes, ~165 TFLOP/s of
// f32-accurate products at the dense TF32 peak); the reconstruction (an
// IEEE division a dimension) runs on the f32 pipes.
//
// Design: one block per (query, CPB = 8 candidates), 8 warps. Shared
// memory depends on neither the document length nor the token width, so
// the kernel takes any Ld and any dim (a multiple of 8):
// - Windows: the block walks its candidates' tokens in windows of LW = 256
//   a candidate. In each it compacts the window's valid tokens into one
//   list (a ballot a 32 tokens): masked tokens and fully masked candidates
//   cost nothing after that. The running max of each (candidate, query
//   token) lives in shared memory across windows; max is exact, so the
//   windows' order changes no score.
// - Slabs: token rows are taken 128 dims at a time, the K loop of a GEMM.
//   At dim <= 128 (one slab, the model's case) the query's tokens are
//   staged once, split into TF32 hi and lo parts (x = hi + lo to ~2^-22),
//   rows padded to a multiple of 32 with zeros. Wider tokens stage each
//   slab of the query for each tile, and a first pass takes each row's sum
//   of squares over all of its dims (quant.cuh's order) before any slab is
//   reconstructed.
// - Tiles of NT = 128 listed tokens: a slab of their centroid ids and
//   packed words is fetched by the whole block into registers a step ahead
//   (the next slab's or tile's loads fly while the current one is
//   multiplied) and staged in shared memory; then each warp reconstructs
//   rows with quant.cuh's exact rounding (`__fadd_rn` of centroid and
//   bucket value, `__fdiv_rn` by max(sqrt(ss), 1e-9), the sum of squares in
//   the same order), four rows a pass with all their loads issued first and
//   all their divisions before any store. The code width is a template
//   parameter, so unpacking is shifts and masks; so is the token width
//   where it is the model's 128 (the dot-product loop then unrolls), other
//   widths taking it at run time.
// - Products: warp w takes the tile's columns 16w..16w+15 (two n-tiles)
//   against every query row: `mma.sync.m16n8k8` TF32, lo*hi + hi*lo +
//   hi*hi into f32 register accumulators that carry across slabs; each doc
//   value is split once, as its fragment is loaded.
// - The max over each candidate's tokens is taken from the accumulators:
//   an n-tile whose 8 columns belong to one candidate reduces in registers
//   and two shuffles, then one shared-memory atomic max per row (floats
//   ordered as integers); an n-tile across a candidate boundary takes an
//   atomic per value. The masked sum over query tokens (a finite max only,
//   as the TPU kernel) is a warp shuffle tree, warp w for candidate w.
// Rows are padded to 128 + 4 floats (dim + 4 below 128): the fragment
// loads (8 rows x 4 columns a warp) hit 32 distinct banks.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "quant.cuh"
#include "tf32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int CPB = NWARPS;                 // candidates a block: warp w's
constexpr int NT = 128;                     // listed doc tokens a tile
constexpr int WCOLS = NT / NWARPS;          // 16 columns a warp,
constexpr int NTW = WCOLS / 8;              // two n-tiles of 8
constexpr int MIN_BLOCKS = 2;               // blocks a SM, for registers
constexpr int MAX_QCH = 4;                  // Lq <= 32 * 4 = 128 a launch;
                                            // the wrapper splits longer queries
constexpr int SLAB = 128;                   // dims a K step; a lane's 4
constexpr int MAX_W = SLAB * 4 / 32;        // packed words a slab, b <= 4
constexpr int ROWS = 4;                     // rows a warp reconstructs a pass
constexpr int LW = 256;                     // tokens a candidate a window:
                                            // the list's index CPB * LW fits
                                            // 16 bits

// DIM: the token width when known at compile time (SLAB, the model's), so
// the dot-product loop unrolls; 0 takes it at run time.
template <int QCH, int BITS, int DIM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) maxsim_packed_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ qmask,
    const uint32_t* __restrict__ words, const int32_t* __restrict__ ids,
    const uint8_t* __restrict__ dmask, const float* __restrict__ centroids,
    const float* __restrict__ values, float* __restrict__ out, int Lq,
    int width, int S, int Ld, int W) {
  const int dim = DIM > 0 ? DIM : width;
  const int nslab = DIM > 0 ? 1 : (dim + SLAB - 1) / SLAB;
  const int SW = min(dim, SLAB);            // a full slab's dims
  constexpr int QP = 32 * QCH;              // query rows, zero-padded
  constexpr int NB = 1 << BITS, CPW = 32 / BITS;
  extern __shared__ int4 smem4[];
  const int DS = SW + 4;
  uint32_t* qhi = reinterpret_cast<uint32_t*>(smem4);      // [QP][DS]
  uint32_t* qlo = qhi + QP * DS;                           // [QP][DS]
  float* tile = reinterpret_cast<float*>(qlo + QP * DS);   // [NT][DS]
  float* vt = tile + NT * DS;                              // [NB][SW]
  float* best = vt + NB * SW;                              // [CPB][QP]
  float* rnorm = best + CPB * QP;                          // [NT]
  uint32_t* wbuf = reinterpret_cast<uint32_t*>(rnorm + NT);  // [NT][SW b/32]
  int* tok_id = reinterpret_cast<int*>(wbuf + NT * (SW * BITS / 32));
  int* col_cand = tok_id + NT;                             // [NT]
  int* cstart = col_cand + NT;                             // [CPB + 1]
  uint16_t* list = reinterpret_cast<uint16_t*>(cstart + CPB + 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qi = blockIdx.y;
  const int s0 = blockIdx.x * CPB;
  const int ns = min(CPB, S - s0);
  const size_t tok0 = ((size_t)qi * S + s0) * Ld;   // the block's first token

  // slab s: its dims, and the query's rows and value table staged for it
  auto slab_dims = [&](int s) { return DIM > 0 ? DIM : min(SLAB, dim - s * SLAB); };
  auto stage = [&](int s) {
    const int sw = slab_dims(s), e0 = s * SLAB;
    for (int i = tid; i < QP * sw; i += THREADS) {
      const int r = i / sw, e = i % sw;
      const float x = r < Lq ? q[((size_t)qi * Lq + r) * dim + e0 + e] : 0.f;
      const uint32_t hi = to_tf32(x);
      qhi[r * DS + e] = hi;
      qlo[r * DS + e] = to_tf32(x - __uint_as_float(hi));
    }
    for (int i = tid; i < sw * NB; i += THREADS)
      vt[(i % NB) * SW + i / NB] = values[(size_t)e0 * NB + i];
  };
  for (int i = tid; i < CPB * QP; i += THREADS) best[i] = -INFINITY;

  // this lane's dimensions lane + 32 i of a slab: their word and bit offset
  int wi[SLAB / 32], sh[SLAB / 32];
#pragma unroll
  for (int i = 0; i < SLAB / 32; ++i) {
    wi[i] = (lane + 32 * i) / CPW;
    sh[i] = (lane + 32 * i) % CPW * BITS;
  }
  const int c0 = warp * WCOLS;

  for (int w0 = 0; w0 < Ld; w0 += LW) {
    const int lw = min(LW, Ld - w0);
    // 1. compact the window's valid tokens: warp w lists candidate w's, in
    // order, as w * LW + the token's place in the window
    int cnt = 0;
    if (warp < ns)
      for (int t0 = 0; t0 < lw; t0 += 32)
        cnt += __popc(__ballot_sync(
            0xffffffffu,
            t0 + lane < lw && dmask[tok0 + warp * Ld + w0 + t0 + lane]));
    if (lane == 0) cstart[warp + 1] = cnt;
    if (tid == 0) cstart[0] = 0;
    __syncthreads();
    if (tid == 0)
      for (int c = 0; c < CPB; ++c) cstart[c + 1] += cstart[c];
    __syncthreads();
    const int total = cstart[CPB];
    if (total == 0 && lw == Ld) {           // no valid token in the block
      if (tid < ns) out[(size_t)qi * S + s0 + tid] = 0.f;
      return;
    }
    if (warp < ns) {
      int pos = cstart[warp];
      for (int t0 = 0; t0 < lw; t0 += 32) {
        const int j = t0 + lane;
        const bool v = j < lw && dmask[tok0 + warp * Ld + w0 + j];
        const unsigned b = __ballot_sync(0xffffffffu, v);
        if (v) list[pos + __popc(b & ((1u << lane) - 1u))] =
            (uint16_t)(warp * LW + j);
        pos += __popc(b);
      }
    }
    __syncthreads();
    // the global token of list entry i
    auto token = [&](int i) {
      const int v = list[i];
      return tok0 + (size_t)(v / LW) * Ld + w0 + v % LW;
    };

    // a tile's centroid ids and a slab of its packed words, fetched into
    // registers: the first tile's while the query is staged, each next
    // step's while the current one is multiplied
    int pf_id = 0;
    uint32_t pf_w[MAX_W * NT / THREADS];
    auto fetch = [&](int t0, int s) {
      const int ncols = min(NT, total - t0);
      const int ws = slab_dims(s) * BITS / 32;
      if (s == 0 && tid < ncols) pf_id = ids[token(t0 + tid)];
#pragma unroll
      for (int k = 0; k < MAX_W * NT / THREADS; ++k) {
        const int i = tid + k * THREADS;
        if (i < ncols * ws)
          pf_w[k] = __ldg(words + token(t0 + i / ws) * W +
                          s * (SLAB * BITS / 32) + i % ws);
      }
    };
    if (total > 0) fetch(0, 0);

    // 2. one slab: the query's tokens as TF32 hi + lo, the values [NB][SW]
    if (w0 == 0 && nslab == 1) stage(0);
    __syncthreads();

    for (int t0 = 0; t0 < total; t0 += NT) {
      const int ncols = min(NT, total - t0);
      const int ntiles = min(NTW, max(0, (ncols - c0 + 7) / 8));
      float acc[QCH][2][NTW][4];
#pragma unroll
      for (int a = 0; a < QCH; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int n = 0; n < NTW; ++n)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[a][b][n][r] = 0.f;

      for (int s = 0; s < nslab; ++s) {
        const int sw = slab_dims(s), ws = sw * BITS / 32;
        if (s == 0 && tid < ncols) {
          tok_id[tid] = pf_id;
          col_cand[tid] = list[t0 + tid] / LW;
        }
#pragma unroll
        for (int k = 0; k < MAX_W * NT / THREADS; ++k)
          if (tid + k * THREADS < ncols * ws) wbuf[tid + k * THREADS] = pf_w[k];
        if (nslab > 1) stage(s);
        __syncthreads();

        // several slabs: each row's norm over all of its dims first, by the
        // warp that reconstructs the row (quant.cuh's order and rounding)
        if (nslab > 1 && s == 0) {
          for (int jj = warp; jj < ncols; jj += NWARPS) {
            const uint32_t* wrow = words + token(t0 + jj) * W;
            const float* crow = centroids + (size_t)tok_id[jj] * dim;
            float ss = 0.f;
            for (int e = lane; e < dim; e += 32) {
              const int code = (__ldg(wrow + e / CPW) >> (e % CPW * BITS)) &
                               (NB - 1);
              const float v = __fadd_rn(__ldg(crow + e),
                                        __ldg(values + (size_t)e * NB + code));
              ss = __fmaf_rn(v, v, ss);
            }
            ss = warp_sum(ss);
            if (lane == 0) rnorm[jj] = fmaxf(sqrtf(ss), 1e-9f);
          }
          __syncwarp();
        }

        // 3. reconstruct the slab of the tile's rows, ROWS a warp a pass
        for (int j = warp; j < ncols; j += ROWS * NWARPS) {
          float v[ROWS][SLAB / 32], ss[ROWS];
#pragma unroll
          for (int u = 0; u < ROWS; ++u) {
            const int jj = min(j + u * NWARPS, ncols - 1);
            const uint32_t* w = wbuf + jj * ws;
            const float* crow =
                centroids + (size_t)tok_id[jj] * dim + s * SLAB;
            ss[u] = 0.f;
#pragma unroll
            for (int i = 0; i < SLAB / 32; ++i) {
              const int e = lane + 32 * i;
              if (e < sw) {
                const int code = (w[wi[i]] >> sh[i]) & (NB - 1);
                v[u][i] = __fadd_rn(__ldg(crow + e), vt[code * SW + e]);
                ss[u] = __fmaf_rn(v[u][i], v[u][i], ss[u]);
              }
            }
          }
          float inv[ROWS];
          if (nslab == 1) {
            // the sums of squares (quant.cuh's warp_sum order) of all ROWS
            // rows together, then every division before any store
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
#pragma unroll
              for (int u = 0; u < ROWS; ++u)
                ss[u] += __shfl_xor_sync(0xffffffffu, ss[u], o);
#pragma unroll
            for (int u = 0; u < ROWS; ++u) inv[u] = fmaxf(sqrtf(ss[u]), 1e-9f);
          } else {
#pragma unroll
            for (int u = 0; u < ROWS; ++u)
              inv[u] = rnorm[min(j + u * NWARPS, ncols - 1)];
          }
#pragma unroll
          for (int u = 0; u < ROWS; ++u)
#pragma unroll
            for (int i = 0; i < SLAB / 32; ++i)
              v[u][i] = __fdiv_rn(v[u][i], inv[u]);
#pragma unroll
          for (int u = 0; u < ROWS; ++u) {
            const int jj = j + u * NWARPS;
            if (jj < ncols) {
#pragma unroll
              for (int i = 0; i < SLAB / 32; ++i) {
                const int e = lane + 32 * i;
                if (e < sw) tile[jj * DS + e] = v[u][i];
              }
            }
          }
        }
        __syncthreads();

        if (s + 1 < nslab) fetch(t0, s + 1);
        else if (t0 + NT < total) fetch(t0 + NT, 0);

        // 4. this slab's products [QP, 16] of this warp's columns on the
        // tensor cores, into the tile's accumulators
        if (ntiles > 0) {
          for (int k0 = 0; k0 < sw; k0 += 8) {
            uint32_t bh[NTW][2], bl[NTW][2];
#pragma unroll
            for (int n = 0; n < NTW; ++n) {
              const float* drow = tile + (c0 + 8 * n + g) * DS + k0 + t;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float x = drow[4 * h];
                bh[n][h] = to_tf32(x);
                bl[n][h] = to_tf32(x - __uint_as_float(bh[n][h]));
              }
            }
#pragma unroll
            for (int a = 0; a < QCH; ++a)
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                const int r0 = (32 * a + 16 * b + g) * DS + k0 + t;
                const int rows[4] = {r0, r0 + 8 * DS, r0 + 4, r0 + 8 * DS + 4};
                uint32_t ah[4], al[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  ah[r] = qhi[rows[r]];
                  al[r] = qlo[rows[r]];
                }
#pragma unroll
                for (int n = 0; n < NTW; ++n)
                  if (n < ntiles) {
                    mma_tf32(acc[a][b][n], al, bh[n][0], bh[n][1]);
                    mma_tf32(acc[a][b][n], ah, bl[n][0], bl[n][1]);
                    mma_tf32(acc[a][b][n], ah, bh[n][0], bh[n][1]);
                  }
              }
          }
        }

        // 5. after the last slab: the max over each candidate's columns,
        // into best[candidate]
        if (s + 1 == nslab) {
#pragma unroll
          for (int n = 0; n < NTW; ++n) {
            if (n >= ntiles) break;
            const int col0 = c0 + 8 * n;
            const int cl = col_cand[col0];
            const bool one = col0 + 7 < ncols && col_cand[col0 + 7] == cl;
#pragma unroll
            for (int a = 0; a < QCH; ++a)
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                const float (&c)[4] = acc[a][b][n];
                const int row = 32 * a + 16 * b + g;
                if (one) {
                  float m0 = fmaxf(c[0], c[1]), m8 = fmaxf(c[2], c[3]);
#pragma unroll
                  for (int o = 1; o < 4; o <<= 1) {
                    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
                    m8 = fmaxf(m8, __shfl_xor_sync(0xffffffffu, m8, o));
                  }
                  if (t == 0) {
                    atomic_max(best + cl * QP + row, m0);
                    atomic_max(best + cl * QP + row + 8, m8);
                  }
                } else {
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const int col = col0 + 2 * t + h;
                    if (col < ncols) {
                      const int cc = col_cand[col];
                      atomic_max(best + cc * QP + row, c[h]);
                      atomic_max(best + cc * QP + row + 8, c[2 + h]);
                    }
                  }
                }
              }
          }
        }
        __syncthreads();                    // tile, ids and maxima settled
      }
    }
  }

  // 6. the masked sum over the query's tokens, warp w for candidate w
  __syncthreads();                          // best, also where Ld is 0
  if (warp < ns) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < QCH; ++i) {
      const int lq = lane + 32 * i;
      const float b = best[warp * QP + lq];
      if (lq < Lq && qmask[(size_t)qi * Lq + lq] && isfinite(b)) part += b;
    }
    part = warp_sum(part);
    if (lane == 0) out[(size_t)qi * S + s0 + warp] = part;
  }
}

template <int QCH, int BITS, int DIM>
int launch_q(const float* q, const uint8_t* qmask, const uint32_t* words,
             const int32_t* ids, const uint8_t* dmask, const float* centroids,
             const float* values, float* out, int Nq, int Lq, int dim, int S,
             int Ld, int W, size_t smem, cudaStream_t stream) {
  cudaFuncSetAttribute(maxsim_packed_kernel<QCH, BITS, DIM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((S + CPB - 1) / CPB, Nq);
  maxsim_packed_kernel<QCH, BITS, DIM><<<grid, THREADS, smem, stream>>>(
      q, qmask, words, ids, dmask, centroids, values, out, Lq, dim, S, Ld, W);
  return (int)cudaGetLastError();
}

template <int BITS, int DIM>
int launch_d(const float* q, const uint8_t* qmask, const uint32_t* words,
             const int32_t* ids, const uint8_t* dmask, const float* centroids,
             const float* values, float* out, int Nq, int Lq, int dim, int S,
             int Ld, int W, size_t smem, cudaStream_t s) {
  switch (Lq > 32 ? (Lq + 31) / 32 : 1) {
    case 1: return launch_q<1, BITS, DIM>(q, qmask, words, ids, dmask,
                                          centroids, values, out, Nq, Lq, dim,
                                          S, Ld, W, smem, s);
    case 2: return launch_q<2, BITS, DIM>(q, qmask, words, ids, dmask,
                                          centroids, values, out, Nq, Lq, dim,
                                          S, Ld, W, smem, s);
    case 3: return launch_q<3, BITS, DIM>(q, qmask, words, ids, dmask,
                                          centroids, values, out, Nq, Lq, dim,
                                          S, Ld, W, smem, s);
    default: return launch_q<4, BITS, DIM>(q, qmask, words, ids, dmask,
                                           centroids, values, out, Nq, Lq,
                                           dim, S, Ld, W, smem, s);
  }
}

template <int BITS>
int launch_b(const float* q, const uint8_t* qmask, const uint32_t* words,
             const int32_t* ids, const uint8_t* dmask, const float* centroids,
             const float* values, float* out, int Nq, int Lq, int dim, int S,
             int Ld, int W, size_t smem, cudaStream_t s) {
  return dim == SLAB
             ? launch_d<BITS, SLAB>(q, qmask, words, ids, dmask, centroids,
                                    values, out, Nq, Lq, dim, S, Ld, W, smem,
                                    s)
             : launch_d<BITS, 0>(q, qmask, words, ids, dmask, centroids,
                                 values, out, Nq, Lq, dim, S, Ld, W, smem, s);
}

}  // namespace

// Shared memory of a launch; it depends on neither Ld nor a dim above 128.
extern "C" size_t maxsim_packed_smem_bytes(int Lq, int dim, int bits) {
  const int QP = 32 * (Lq > 32 ? (Lq + 31) / 32 : 1);
  const size_t SW = dim < SLAB ? dim : SLAB;
  return sizeof(uint32_t) * 2 * (size_t)QP * (SW + 4) +
         sizeof(float) * ((size_t)NT * (SW + 4) + SW * (1 << bits) +
                          (size_t)CPB * QP + NT) +
         sizeof(uint32_t) * (size_t)NT * SW * bits / 32 +
         sizeof(int) * (2 * NT + CPB + 1) + sizeof(uint16_t) * CPB * LW;
}

// q [Nq, Lq, dim] f32; qmask [Nq, Lq] u8; words [Nq, S, Ld, W] u32;
// ids / dmask [Nq, S, Ld] i32 / u8; centroids [K, dim]; values
// [dim, 2^bits] -> out [Nq, S] f32, Lq <= 128, dim a multiple of 8, bits 2
// or 4, W * 32 == dim * bits; any Ld. Returns cudaGetLastError()
// (cudaErrorInvalidValue outside those limits).
extern "C" int maxsim_packed_launch(const float* q, const uint8_t* qmask,
                                    const uint32_t* words,
                                    const int32_t* ids, const uint8_t* dmask,
                                    const float* centroids,
                                    const float* values, float* out, int Nq,
                                    int Lq, int dim, int S, int Ld, int W,
                                    int bits, void* stream) {
  if (Lq > 32 * MAX_QCH || dim <= 0 || dim % 8 != 0 ||
      (bits != 2 && bits != 4) || W * 32 != dim * bits)
    return (int)cudaErrorInvalidValue;
  if (Nq == 0 || S == 0) return (int)cudaGetLastError();
  const size_t smem = maxsim_packed_smem_bytes(Lq, dim, bits);
  cudaStream_t s = (cudaStream_t)stream;
  return bits == 2
             ? launch_b<2>(q, qmask, words, ids, dmask, centroids, values,
                           out, Nq, Lq, dim, S, Ld, W, smem, s)
             : launch_b<4>(q, qmask, words, ids, dmask, centroids, values,
                           out, Nq, Lq, dim, S, Ld, W, smem, s);
}
