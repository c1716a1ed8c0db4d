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
// What bounds it on this card: per row the function reads 4W + 4 bytes of
// codes and id and writes 4 Lq bytes of scores (the centroid table, the
// value table and the query are read once for all rows), and it does
// 2 Lq dim FLOP of products plus ~4 dim of reconstruction: at b = 2,
// Lq = 32, dim = 128 ~50 FLOP a byte, near the ridge of 3xTF32 products on
// the tensor cores (three TF32 passes at 494.7 TFLOP/s against 3.35 TB/s),
// so bytes and products are about even, and each alone is ~0.01 ms at
// 200k rows. In f32 FMA (67 TFLOP/s) the products alone would take 6x
// that. The reconstruction is latency-bound (a dependent load, an add, a
// sum over the warp, an IEEE division a dimension).
//
// Design: every warp works alone on tiles of TM = 16 rows (one m-tile),
// walking the tiles with a stride of all warps of the grid (one wave of
// resident blocks); the block only shares the query and the value table,
// staged once (one barrier in all).
// - A tile's packed words and centroid ids are copied by cp.async into the
//   warp's double buffer a tile ahead (the next tile's loads fly while the
//   current one is reconstructed and multiplied).
// - The warp reconstructs its 16 rows into shared memory with quant.cuh's
//   exact rounding (`__fadd_rn` of centroid and bucket value, the sum of
//   squares by `__fmaf_rn` in the same order and the same warp_sum, then
//   `__fdiv_rn` by max(sqrt(ss), 1e-9)): the rows equal the earlier FMA
//   design's bit for bit. At the model's width (DIM = 128) four rows go
//   together, their loads first and all their divisions before any store;
//   other widths take a row at a time.
// - Products: rows x query^T on `mma.sync.m16n8k8` 3xTF32 (tf32.cuh: lo.hi
//   + hi.lo + hi.hi into f32 accumulators), 32 query tokens (four n-tiles)
//   a pass, fragments by `ldmatrix.x4` a k-step ahead, split into TF32 hi
//   and lo in registers. The query is held raw (f32 rows padded to
//   dim + 4: conflict-free ldmatrix), zero rows past Lq.
// - The [16, 32] accumulator tile goes through the warp's shared staging
//   (rows of 36 floats) and out to device memory a row of 32 scores a
//   store (coalesced 128 bytes).
// A launch holds as many query tokens as shared memory takes (the C entry
// splits longer queries over launches, each writing its columns). Rows
// too wide for a warp's tiles in shared memory (tc_fits) keep the f32 body
// below: one warp reconstructs one row into shared memory, then lane l
// computes the products of query tokens l, l + 32, ... in plain f32 FMA.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "quant.cuh"
#include "tf32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TM = 16;                  // rows a warp tile: one m-tile
constexpr int QN = 32;                  // query tokens a pass: four n-tiles
constexpr int OS = QN + 4;              // staging row stride (floats)
constexpr int ROWS = 4;                 // rows reconstructed together
constexpr int MAX_SMEM = 232448;        // dynamic shared memory a block

__host__ __device__ constexpr size_t tc_smem_bytes(int QP, int dim, int bits) {
  return sizeof(float) * ((size_t)(QP + WARPS * TM) * (dim + 4) +
                          (size_t)dim * (1 << bits) + (size_t)WARPS * TM * OS) +
         sizeof(uint32_t) * (size_t)WARPS * 2 * TM * (dim * bits / 32 + 1);
}

// The tensor-core body where a launch of QN query tokens fits shared
// memory (dim <= 288 at b = 2, 248 at b = 4), else the f32 body.
bool tc_fits(int dim, int bits) {
  return tc_smem_bytes(QN, dim, bits) <= MAX_SMEM;
}

// Query tokens a launch of the tensor-core body takes: a multiple of QN.
int tc_max_tokens(int dim, int bits) {
  int qp = QN;
  while (tc_smem_bytes(qp + QN, dim, bits) <= MAX_SMEM) qp += QN;
  return qp;
}

// words [M, W]; ids [M]; centroids [K, dim]; values [dim, 2^BITS]; q
// [Lq, dim] (this launch's tokens) -> out [m, l] at out + m * ldo + l.
// QP: Lq rounded up to QN. DIM: the token width when known at compile
// time (the model's 128); 0 takes it at run time.
template <int BITS, int DIM>
__global__ void __launch_bounds__(THREADS, 2) dequant_score_tc_kernel(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ ids,
    const float* __restrict__ centroids, const float* __restrict__ values,
    const float* __restrict__ q, float* __restrict__ out, int M, int Lq,
    int width, int ldo, int QP) {
  constexpr int NB = 1 << BITS, CPW = 32 / BITS;
  const int dim = DIM > 0 ? DIM : width;
  const int W = dim / CPW, DS = dim + 4, dim4 = dim >> 2;
  extern __shared__ int4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);             // [QP][DS]
  float* vt = qs + QP * DS;                                // [NB][dim]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* rw = vt + NB * dim + warp * TM * DS;              // [TM][DS]
  float* sw = vt + NB * dim + WARPS * TM * DS + warp * TM * OS;  // [TM][OS]
  // [2][TM * W words, TM ids], a tile's in each half by turns
  const int TW = TM * (W + 1);
  uint32_t* wbuf = reinterpret_cast<uint32_t*>(vt + NB * dim +
                                               WARPS * TM * (DS + OS)) +
                   warp * 2 * TW;

  for (int i = tid; i < QP * dim4; i += THREADS) {
    const int r = i / dim4, e = 4 * (i % dim4);
    *reinterpret_cast<float4*>(qs + r * DS + e) =
        r < Lq ? __ldg(reinterpret_cast<const float4*>(q + (size_t)r * dim +
                                                       e))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = tid; i < dim * NB; i += THREADS)
    vt[(i % NB) * dim + i / NB] = values[i];
  __syncthreads();

  const int ntiles = (M + TM - 1) / TM;
  const int step = gridDim.x * WARPS;
  // a tile's words then ids into half h of the buffer (past M: 0, a valid
  // code and centroid), a group of this lane's copies
  auto fetch = [&](int tile, int h) {
    const size_t m0 = (size_t)tile * TM;
    uint32_t* dst = wbuf + h * TW;
    for (int i = lane; i < TW; i += 32) {
      const size_t m = i < TM * W ? m0 * W + i : m0 + (i - TM * W);
      const size_t end = i < TM * W ? (size_t)M * W : (size_t)M;
      const uint32_t* src = i < TM * W
                                ? words + m
                                : reinterpret_cast<const uint32_t*>(ids) + m;
      if (m < end)
        cp_async4(dst + i, src);
      else
        dst[i] = 0u;
    }
    cp_async_commit();
  };
  // this lane's dimensions lane + 32 i (DIM > 0): their word and bit offset
  constexpr int NE = DIM > 0 ? DIM / 32 : 1;
  int wi[NE], sh[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    wi[i] = (lane + 32 * i) / CPW;
    sh[i] = (lane + 32 * i) % CPW * BITS;
  }

  int tile = blockIdx.x * WARPS + warp;
  if (tile < ntiles) fetch(tile, 0);
  for (int j = 0; tile < ntiles; tile += step, ++j) {
    if (tile + step < ntiles)
      fetch(tile + step, (j + 1) & 1);     // the next tile's, in flight
    else
      cp_async_commit();
    cp_async_wait<1>();                      // this lane's copies of tile j
    __syncwarp();                            // and every lane's
    const uint32_t* wb = wbuf + (j & 1) * TW;
    const int* ib = reinterpret_cast<const int*>(wb + TM * W);
    const int m0 = tile * TM, nrows = min(TM, M - m0);

    // 1. the tile's rows, unit-renormalized, into rw
    if constexpr (DIM > 0) {
#pragma unroll
      for (int j0 = 0; j0 < TM; j0 += ROWS) {
        float v[ROWS][NE], ss[ROWS];
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const uint32_t* w = wb + (j0 + u) * W;
          const float* crow = centroids + (size_t)ib[j0 + u] * dim;
          ss[u] = 0.f;
#pragma unroll
          for (int i = 0; i < NE; ++i) {
            const int code = (w[wi[i]] >> sh[i]) & (NB - 1);
            v[u][i] = __fadd_rn(__ldg(crow + lane + 32 * i),
                                vt[code * dim + lane + 32 * i]);
            ss[u] = __fmaf_rn(v[u][i], v[u][i], ss[u]);
          }
        }
        // the sums of squares in warp_sum's order, then every division
        // before any store
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < ROWS; ++u)
            ss[u] += __shfl_xor_sync(0xffffffffu, ss[u], o);
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const float inv = fmaxf(sqrtf(ss[u]), 1e-9f);
#pragma unroll
          for (int i = 0; i < NE; ++i) v[u][i] = __fdiv_rn(v[u][i], inv);
        }
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
#pragma unroll
          for (int i = 0; i < NE; ++i)
            rw[(j0 + u) * DS + lane + 32 * i] = v[u][i];
      }
    } else {
      for (int j = 0; j < TM; ++j) {
        const uint32_t* w = wb + j * W;
        const float* crow = centroids + (size_t)ib[j] * dim;
        float* o = rw + j * DS;
        float ss = 0.f;
        for (int e = lane; e < dim; e += 32) {
          const int code = (w[e / CPW] >> (e % CPW * BITS)) & (NB - 1);
          const float v = __fadd_rn(__ldg(crow + e), vt[code * dim + e]);
          o[e] = v;
          ss = __fmaf_rn(v, v, ss);
        }
        const float inv = fmaxf(sqrtf(warp_sum(ss)), 1e-9f);
        for (int e = lane; e < dim; e += 32) o[e] = __fdiv_rn(o[e], inv);
      }
    }
    __syncwarp();

    // 2. scores [16, QN] a pass on the tensor cores, out through sw
    const float* pa = rw + ((lane & 7) + 8 * ((lane >> 3) & 1)) * DS +
                      4 * (lane >> 4);
    for (int c = 0; c < QP; c += QN) {
      const float* pb = qs + (c + (lane & 7) + 8 * (lane >> 4)) * DS +
                        4 * ((lane >> 3) & 1);
      float acc[1][4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[0][n][r] = 0.f;
      uint32_t ra[4], rb[2][4];
      auto frag = [&](int k0) {
        ldmatrix_x4(ra, pa + k0);
        ldmatrix_x4(rb[0], pb + k0);
        ldmatrix_x4(rb[1], pb + 16 * DS + k0);
      };
      frag(0);
#pragma unroll
      for (int k0 = 0; k0 < dim; k0 += 8) {
        uint32_t ah[1][4], al[1][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          tf32_split(__uint_as_float(ra[r]), ah[0][r], al[0][r]);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tf32_split(__uint_as_float(rb[n / 2][2 * (n % 2) + h]), bh[n][h],
                       bl[n][h]);
        if (k0 + 8 < dim) frag(k0 + 8);
        mma_3xtf32_tiles<1, 4>(acc, ah, al, bh, bl);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<float2*>(sw + g * OS + 8 * n + 2 * t) =
            make_float2(acc[0][n][0], acc[0][n][1]);
        *reinterpret_cast<float2*>(sw + (g + 8) * OS + 8 * n + 2 * t) =
            make_float2(acc[0][n][2], acc[0][n][3]);
      }
      __syncwarp();
      if (c + lane < Lq)
        for (int r = 0; r < nrows; ++r)
          out[(size_t)(m0 + r) * ldo + c + lane] = sw[r * OS + lane];
      __syncwarp();                          // sw read before it is reused
    }
    // (the half of tile j is refilled at iteration j + 1: its words and ids
    // were read before the products, and every lane has passed the
    // __syncwarp after the last pass)
  }
}

template <int BITS, int DIM>
int launch_tc(const uint32_t* words, const int32_t* ids,
              const float* centroids, const float* values, const float* q,
              float* out, int M, int Lq, int dim, cudaStream_t stream) {
  auto kernel = dequant_score_tc_kernel<BITS, DIM>;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int qmax = tc_max_tokens(dim, BITS);
  const int tiles = (M + TM - 1) / TM;
  for (int lo = 0; lo < Lq; lo += qmax) {
    const int n = min(qmax, Lq - lo);
    const int QP = (n + QN - 1) / QN * QN;
    const size_t smem = tc_smem_bytes(QP, dim, BITS);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    int per_sm = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                  smem);
    // one wave of resident blocks, each warp walking its tiles
    const int blocks = min((tiles + WARPS - 1) / WARPS, max(per_sm, 1) * sms);
    kernel<<<blocks, THREADS, smem, stream>>>(words, ids, centroids, values,
                                              q + (size_t)lo * dim, out + lo,
                                              M, n, dim, Lq, QP);
    const int code = (int)cudaGetLastError();
    if (code) return code;
  }
  return (int)cudaGetLastError();
}

// --- the f32 body, for rows too wide for the tensor-core body's tiles ------

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

size_t f32_smem_bytes(int Lq, int dim, int bits) {
  return sizeof(float) * ((size_t)Lq * (dim + 1) + (size_t)dim * (1 << bits) +
                          (size_t)WARPS * dim);
}

}  // namespace

// Dynamic shared memory the entry needs for Lq query tokens at this width
// (the tensor-core body takes longer queries over several launches).
extern "C" size_t dequant_score_smem_bytes(int Lq, int dim, int bits) {
  if (!tc_fits(dim, bits)) return f32_smem_bytes(Lq, dim, bits);
  const int qp = (min(Lq, tc_max_tokens(dim, bits)) + QN - 1) / QN * QN;
  return tc_smem_bytes(qp > 0 ? qp : QN, dim, bits);
}

// words [M, W] u32; ids [M] i32; centroids [K, dim] f32; values
// [dim, 2^bits] f32; q [Lq, dim] f32 -> out [M, Lq] f32. bits 2 or 4,
// W * 32 == dim * bits, 16-byte aligned q. Returns cudaGetLastError()
// (cudaErrorInvalidValue outside those limits).
extern "C" int dequant_score_launch(const uint32_t* words, const int32_t* ids,
                                    const float* centroids,
                                    const float* values, const float* q,
                                    float* out, int M, int Lq, int dim, int W,
                                    int bits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((bits != 2 && bits != 4) || W * 32 != dim * bits)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || Lq == 0) return (int)cudaGetLastError();
  if (!tc_fits(dim, bits)) {
    const size_t smem = f32_smem_bytes(Lq, dim, bits);
    cudaFuncSetAttribute(dequant_score_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    const int blocks = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    dequant_score_kernel<<<blocks, THREADS, smem, s>>>(
        words, ids, centroids, values, q, out, M, Lq, dim, W, bits);
    return (int)cudaGetLastError();
  }
  if (bits == 2)
    return dim == 128 ? launch_tc<2, 128>(words, ids, centroids, values, q,
                                          out, M, Lq, dim, s)
                      : launch_tc<2, 0>(words, ids, centroids, values, q, out,
                                        M, Lq, dim, s);
  return dim == 128 ? launch_tc<4, 128>(words, ids, centroids, values, q, out,
                                        M, Lq, dim, s)
                    : launch_tc<4, 0>(words, ids, centroids, values, q, out,
                                      M, Lq, dim, s);
}
