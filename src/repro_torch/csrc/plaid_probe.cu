// Fused PLAID centroid-interaction probe (stages 1 + 3) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/plaid_probe/kernel.py
// (`_plaid_probe_kernel`, dispatched by `plaid_probe_pallas`): score one
// query's tokens against every centroid (q . C^T), set masked query tokens
// to -inf, prune scores below t_cs to 0, then for each candidate doc take
// the max over its (valid) token codes of the pruned score and sum over
// query tokens. Invalid candidate slots get -inf.
//
// What bounds it on this card: bytes where most slots are valid (a 4-byte
// centroid id and a 1-byte mask per candidate token); on the main path,
// whose stage-2 width pads a few hundred valid candidates to the corpus,
// reading the slots' flags and launching.
//
// Design: two kernels a launch, on one stream.
// - `plaid_table_kernel` computes each query's pruned [Lq, K] table once,
//   into a scratch [Nq][K + 2][32 R] in device memory (R = ceil(Lq / 32)),
//   each score one `__fmaf_rn` chain over dim, as in the first CUDA
//   version of this kernel, so the table is bit for bit the same. Row K
//   is all zero (what a masked candidate token reads: the reference gives
//   it 0), row K + 1 all -inf (what a slot past the candidate's last token
//   reads: neutral to the max). Query tokens past Lq are 0 in every row
//   but K + 1: they add 0 to the sum, and no guard runs in the lookups.
// - `plaid_probe_kernel`: a query's slots are dealt to its blocks in turn
//   (block b of G takes slots b, b + G, ...), TILE_C a block, so the
//   valid prefix of the main path's slate spreads over all of them. Each
//   warp reads the flags of its 32 slots at once and writes -inf to the
//   invalid ones; a block with no valid slot stops there, before it reads
//   the table or any code byte. Otherwise the block copies the query's
//   table into shared memory (16-byte loads from L2), and each warp scores
//   its valid candidates one at a time: the first SEG tokens' codes and
//   mask with 16-byte loads, the next candidate's kept in flight in
//   registers while the current one is scored; folded to one table row
//   offset a token (mask ? code : K) and written to the warp's buffer.
// - Lookups: lane i owns query tokens i + 32 r; a token is a quarter of a
//   broadcast 16-byte shared read (four offsets), one shared read and one
//   fmaxf (two running maxima, merged at the end) a row: the shared-memory
//   pipe bounds it. The max over a document's tokens depends only on its
//   set of distinct offsets, so where a segment's first 32 tokens repeat
//   their first code in more than a quarter of places (documents crowded
//   into a few centroids), each chunk of 32 first takes its distinct
//   offsets one at a time (at most DEDUP_MAX), and falls back to the
//   full read where they are many. fmaxf is idempotent: the same maxima
//   exactly, either way.
// - The sum over query tokens is the first version's: per lane over r,
//   then a shuffle xor tree, so the scores are bit for bit the same.
// - Two routes for the table. A table of (K + 2) x 32 R floats fits a
//   block's 227 KB of shared memory only up to K = 1,668 at R = 1 (415 at
//   R = 4). Past that (PLAID's own K of 8,192 and more) the probe kernel
//   reads the table where the table kernel wrote it, through the
//   read-only path (`__ldg`, L2), instead of staging it: the same
//   lookups, distinct-code path, loads and masks, and the same scores bit
//   for bit. A query's table is 1.05 MB at K = 8,192 and Lq <= 32, so a
//   few queries' tables sit in the 50 MB L2 at a time; with shared memory
//   left to the warps' buffers, more blocks a SM hide L2's latency. The
//   wrapper picks the route (`kernels/plaid_probe/ops.py` `probe_route`):
//   narrower query chunks whose table would fit shared memory were slower
//   on the card than this route at every K measured.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int TILE_C = 32 * NWARPS;        // candidate slots a block
constexpr int TAB_K = 32;                  // table rows a table block
constexpr int MAX_R = 4;                   // Lq <= 32 * MAX_R = 128 a launch;
                                           // the wrapper splits longer queries
constexpr int SEG = 256;                   // candidate tokens staged a pass
constexpr int DEDUP_MAX = 16;              // distinct codes a chunk looks up
                                           // one at a time before a full read
constexpr int CHUNKS = SEG / 32;
constexpr int CODE_VECS = SEG / 4 + 1;     // 16-byte vectors of SEG codes at
constexpr int MASK_VECS = SEG / 16 + 1;    // any alignment; of SEG mask bytes
constexpr int OFF_VECS = SEG / 4;          // the folded row offsets
constexpr int WARP_VECS = CODE_VECS + MASK_VECS + OFF_VECS;
constexpr int PF_VECS = (CODE_VECS + 31) / 32;   // code vectors a lane fetches

__host__ __device__ inline size_t table_floats(int R, int K) {
  return ((size_t)(K + 2) * 32 * R + 3) & ~(size_t)3;     // 16-byte aligned
}

// 16-byte vector v of a buffer of n_words 4-byte words (16-byte aligned
// base); a vector past the end is read word by word, its tail left 0.
__device__ __forceinline__ int4 load_vec(const int4* base, size_t v,
                                         size_t n_words) {
  if ((v + 1) * 4 <= n_words) return __ldg(base + v);
  int w[4] = {0, 0, 0, 0};
  const int* p = reinterpret_cast<const int*>(base);
  for (int i = 0; i < 4; ++i)
    if (v * 4 + i < n_words) w[i] = __ldg(p + v * 4 + i);
  return make_int4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int4 load_bytes_vec(const uint8_t* base, size_t v,
                                               size_t n_bytes) {
  if ((v + 1) * 16 <= n_bytes)
    return __ldg(reinterpret_cast<const int4*>(base) + v);
  int4 out = make_int4(0, 0, 0, 0);
  uint8_t* o = reinterpret_cast<uint8_t*>(&out);
  for (int i = 0; i < 16; ++i)
    if (v * 16 + i < n_bytes) o[i] = __ldg(base + v * 16 + i);
  return out;
}

// stage 1: block (kt, qi) writes table rows kt * TAB_K .. + TAB_K of
// query qi; a warp shares a query token, its lanes take centroids
// (staged in shared memory, rows padded to dim + 1 floats).
template <int R>
__global__ void __launch_bounds__(THREADS) plaid_table_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ qmask,
    const float* __restrict__ centroids, float* __restrict__ table, int Lq,
    int dim, int K, float t_cs) {
  constexpr int QW = 32 * R;
  extern __shared__ float cen[];                          // [TAB_K][dim + 1]
  const int qi = blockIdx.y, k0 = blockIdx.x * TAB_K;
  const int ds = dim + 1;
  const int nk = max(0, min(TAB_K, K - k0));             // centroid rows here
  for (int i = threadIdx.x; i < nk * dim; i += THREADS)
    cen[(i / dim) * ds + i % dim] = centroids[(size_t)k0 * dim + i];
  __syncthreads();
  const float* qq = q + (size_t)qi * Lq * dim;
  float* tq = table + (size_t)qi * table_floats(R, K);
  for (int p = threadIdx.x; p < TAB_K * QW; p += THREADS) {
    const int kk = p % TAB_K, lq = p / TAB_K, k = k0 + kk;
    if (k >= K + 2) continue;
    float v = 0.f;
    if (k == K + 1) {
      v = -INFINITY;
    } else if (k < K && lq < Lq) {
      const float* crow = cen + kk * ds;
      const float* qrow = qq + (size_t)lq * dim;
      float acc = 0.f;
      for (int e = 0; e < dim; ++e)
        acc = __fmaf_rn(__ldg(qrow + e), crow[e], acc);
      const float s = qmask[(size_t)qi * Lq + lq] ? acc : -INFINITY;
      v = (s >= t_cs) ? s : 0.f;
    }
    tq[(size_t)k * QW + lq] = v;
  }
}

// a table entry: shared memory, or (GT) device memory through L2
template <bool GT>
__device__ __forceinline__ float tab_at(const float* p) {
  if constexpr (GT) return __ldg(p);
  else return *p;
}

template <int R, bool GT>
__device__ __forceinline__ void lookup(int o, const float* tabl,
                                       float (&m)[2][R], int h) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    m[h][r] = fmaxf(m[h][r], tab_at<GT>(tabl + o + 32 * r));
}

// Max of this lane's query-token rows over a chunk of cnt <= 32 tokens,
// whose table row offsets the lanes hold one a lane (`off`) and the warp's
// buffer holds in order (`offs`, padded to 4 with the -inf row). With
// `dedup`, first distinct offsets one at a time (a shuffle, a lookup and a
// ballot each); a chunk with more than 3/4 of its tokens left after the
// first, or with more than DEDUP_MAX distinct offsets, is read in full
// (broadcast 16-byte reads of four offsets, a lookup each).
template <int R, bool GT>
__device__ __forceinline__ void lookup_chunk(int off, const int4* offs,
                                             int cnt, const float* tabl,
                                             float (&m)[2][R],
                                             bool dedup) {
  const unsigned full = 0xffffffffu;
  unsigned rem = cnt >= 32 ? full : (1u << cnt) - 1u;
  for (int d = 0; dedup && d < DEDUP_MAX; ++d) {
    const int o = __shfl_sync(full, off, __ffs(rem) - 1);
    lookup<R, GT>(o, tabl, m, 0);
    rem &= ~__ballot_sync(full, off == o);
    if (rem == 0u) return;
    if (d == 0 && 4 * __popc(rem) > 3 * cnt) break;   // mostly distinct
  }
#pragma unroll 2
  for (int j = 0; j < cnt; j += 4) {
    const int4 o = offs[j / 4];
    lookup<R, GT>(o.x, tabl, m, 0);
    lookup<R, GT>(o.y, tabl, m, 1);
    lookup<R, GT>(o.z, tabl, m, 0);
    lookup<R, GT>(o.w, tabl, m, 1);
  }
}

// GT: read the table in device memory (K too large for shared memory);
// shared memory then holds the warps' buffers only
template <int R, bool GT>
__global__ void __launch_bounds__(THREADS, 4) plaid_probe_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ codes,
    const uint8_t* __restrict__ cmask, const uint8_t* __restrict__ vmask,
    float* __restrict__ out, int Nq, int K, int C, int L) {
  extern __shared__ int4 smem4[];
  constexpr int QW = 32 * R;               // table row width
  const size_t tf = table_floats(R, K);
  const int qi = blockIdx.y;
  const float* tab = GT ? table + (size_t)qi * tf             // [K + 2][QW]
                        : reinterpret_cast<const float*>(smem4);
  int4* cbuf = smem4 + (GT ? 0 : tf / 4) + (threadIdx.x >> 5) * WARP_VECS;
  int4* mbuf = cbuf + CODE_VECS;                                   // mask
  int4* obuf = mbuf + MASK_VECS;                                   // offsets
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned full = 0xffffffffu;

  // the warp's slots, one a lane: the query's slots are dealt to its
  // blocks in turn, so a valid prefix (the main path's) spreads over all
  const int stride = gridDim.x;
  const int c = blockIdx.x + stride * (warp + NWARPS * lane);
  const bool ok = c < C && vmask[(size_t)qi * C + c];
  if (c < C && !ok) out[(size_t)qi * C + c] = -INFINITY;
  if (!__syncthreads_or(ok)) return;       // no valid slot in the block
  unsigned todo = __ballot_sync(full, ok);

  if (!GT) {
    const int4* tq = reinterpret_cast<const int4*>(table + (size_t)qi * tf);
    for (size_t i = tid; i < tf / 4; i += THREADS) smem4[i] = __ldg(tq + i);
  }

  const float* tabl = tab + lane;
  const size_t n_tok = (size_t)Nq * C * L;
  const int4* code_vecs = reinterpret_cast<const int4*>(codes);
  const int n0 = min(SEG, L);              // tokens of a first segment
  int4 cv[PF_VECS], mv;
  auto slot = [&](unsigned set) {          // the candidate of set's first bit
    return (size_t)qi * C + blockIdx.x +
           (size_t)stride * (warp + NWARPS * (__ffs(set) - 1));
  };
  auto fetch = [&](size_t cand) {          // a first segment into registers
    const size_t t0 = cand * L, v0 = t0 / 4, u0 = t0 / 16;
    const int nv = (int)((t0 + n0 + 3) / 4 - v0);
    const int nu = (int)((t0 + n0 + 15) / 16 - u0);
#pragma unroll
    for (int k = 0; k < PF_VECS; ++k)
      cv[k] = lane + 32 * k < nv
                  ? load_vec(code_vecs, v0 + lane + 32 * k, n_tok)
                  : make_int4(0, 0, 0, 0);
    mv = lane < nu ? load_bytes_vec(cmask, u0 + lane, n_tok)
                   : make_int4(0, 0, 0, 0);
  };
  if (todo) fetch(slot(todo));
  __syncthreads();                         // the table is in place

  while (todo) {
    const size_t cand = slot(todo);
    todo &= todo - 1;
    float m[2][R];
#pragma unroll
    for (int r = 0; r < R; ++r) m[0][r] = m[1][r] = -INFINITY;
    for (int s0 = 0; s0 < L; s0 += SEG) {
      const int n = min(SEG, L - s0);
      const size_t t0 = cand * L + s0;     // first token of the segment
      const size_t v0 = t0 / 4, u0 = t0 / 16;
      const int nv = (int)((t0 + n + 3) / 4 - v0);
      const int nu = (int)((t0 + n + 15) / 16 - u0);
      if (s0 == 0) {                       // fetched: stage, fetch the next
#pragma unroll
        for (int k = 0; k < PF_VECS; ++k)
          if (lane + 32 * k < nv) cbuf[lane + 32 * k] = cv[k];
        if (lane < nu) mbuf[lane] = mv;
        if (todo) fetch(slot(todo));
      } else {
        for (int v = lane; v < nv; v += 32)
          cbuf[v] = load_vec(code_vecs, v0 + v, n_tok);
        if (lane < nu) mbuf[lane] = load_bytes_vec(cmask, u0 + lane, n_tok);
      }
      __syncwarp();
      const int* cw = reinterpret_cast<const int*>(cbuf) + (t0 - v0 * 4);
      const uint8_t* mw = reinterpret_cast<const uint8_t*>(mbuf) +
                          (t0 - u0 * 16);
      const int nch = (n + 31) / 32;
      int* ow = reinterpret_cast<int*>(obuf);
      int off[CHUNKS];
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i)
        if (i < nch) {
          const int j = lane + 32 * i;
          off[i] = (j < n ? (mw[j] ? cw[j] : K) : K + 1) * QW;
          ow[j] = off[i];
        }
      __syncwarp();
      // dedup a segment whose first chunk repeats its first code often
      const int cnt0 = min(32, n);
      const unsigned same = __ballot_sync(
          full, lane < cnt0 && off[0] == __shfl_sync(full, off[0], 0));
      const bool dd = 4 * __popc(same) > cnt0;
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i)
        if (i < nch)
          lookup_chunk<R, GT>(off[i], obuf + 8 * i, min(32, n - 32 * i), tabl,
                          m, dd);
      __syncwarp();            // buffers free for the next segment
    }
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) part += fmaxf(m[0][r], m[1][r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(full, part, o);
    if (lane == 0) out[cand] = part;
  }
}

template <int R, bool GT>
int launch_r(const float* q, const uint8_t* qmask, const float* centroids,
             const int32_t* codes, const uint8_t* cmask,
             const uint8_t* vmask, float* table, float* out, int Nq, int Lq,
             int dim, int K, int C, int L, float t_cs, cudaStream_t stream) {
  const size_t tsmem = sizeof(float) * TAB_K * (dim + 1);
  cudaFuncSetAttribute(plaid_table_kernel<R>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)tsmem);
  plaid_table_kernel<R><<<dim3((K + 2 + TAB_K - 1) / TAB_K, Nq), THREADS,
                          tsmem, stream>>>(q, qmask, centroids, table, Lq,
                                           dim, K, t_cs);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem = (GT ? 0 : sizeof(float) * table_floats(R, K)) +
                      (size_t)NWARPS * WARP_VECS * 16;
  cudaFuncSetAttribute(plaid_probe_kernel<R, GT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  plaid_probe_kernel<R, GT><<<dim3((C + TILE_C - 1) / TILE_C, Nq), THREADS,
                              smem, stream>>>(table, codes, cmask, vmask, out,
                                              Nq, K, C, L);
  return (int)cudaGetLastError();
}

template <bool GT>
int launch_gt(const float* q, const uint8_t* qmask, const float* centroids,
              const int32_t* codes, const uint8_t* cmask,
              const uint8_t* vmask, float* table, float* out, int Nq, int Lq,
              int dim, int K, int C, int L, float t_cs, cudaStream_t s) {
  switch (Lq > 32 ? (Lq + 31) / 32 : 1) {
    case 1: return launch_r<1, GT>(q, qmask, centroids, codes, cmask, vmask,
                                   table, out, Nq, Lq, dim, K, C, L, t_cs, s);
    case 2: return launch_r<2, GT>(q, qmask, centroids, codes, cmask, vmask,
                                   table, out, Nq, Lq, dim, K, C, L, t_cs, s);
    case 3: return launch_r<3, GT>(q, qmask, centroids, codes, cmask, vmask,
                                   table, out, Nq, Lq, dim, K, C, L, t_cs, s);
    default: return launch_r<4, GT>(q, qmask, centroids, codes, cmask, vmask,
                                    table, out, Nq, Lq, dim, K, C, L, t_cs,
                                    s);
  }
}

}  // namespace

// Shared memory of the larger of the two kernels, the table in shared
// memory (what decides the route: the global-table route needs less).
extern "C" size_t plaid_probe_smem_bytes(int Lq, int K, int dim) {
  const int R = Lq > 32 ? (Lq + 31) / 32 : 1;
  const size_t t = sizeof(float) * TAB_K * (dim + 1);
  const size_t p = sizeof(float) * table_floats(R, K) +
                   (size_t)NWARPS * WARP_VECS * 16;
  return t > p ? t : p;
}

// Floats of the table scratch of a launch.
extern "C" size_t plaid_probe_table_floats(int Nq, int Lq, int K) {
  return (size_t)Nq * table_floats(Lq > 32 ? (Lq + 31) / 32 : 1, K);
}

// q [Nq, Lq, dim] f32; qmask [Nq, Lq] u8; centroids [K, dim] f32;
// codes [Nq, C, L] i32; cmask [Nq, C, L] u8 (both 16-byte aligned);
// vmask [Nq, C] u8; table: scratch of plaid_probe_table_floats(Nq, Lq, K)
// f32 -> out [Nq, C] f32, Lq <= 128. Two kernels: the table, then the
// probe, which stages the table in shared memory, or with global_table
// reads it in the scratch. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a longer query).
extern "C" int plaid_probe_launch(const float* q, const uint8_t* qmask,
                                  const float* centroids,
                                  const int32_t* codes, const uint8_t* cmask,
                                  const uint8_t* vmask, float* table,
                                  float* out, int Nq, int Lq, int dim, int K,
                                  int C, int L, float t_cs, int global_table,
                                  void* stream) {
  if (Lq > 32 * MAX_R) return (int)cudaErrorInvalidValue;
  if (Nq == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return global_table
             ? launch_gt<true>(q, qmask, centroids, codes, cmask, vmask,
                               table, out, Nq, Lq, dim, K, C, L, t_cs, s)
             : launch_gt<false>(q, qmask, centroids, codes, cmask, vmask,
                                table, out, Nq, Lq, dim, K, C, L, t_cs, s);
}
