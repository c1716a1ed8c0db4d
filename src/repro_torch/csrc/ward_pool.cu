// Agglomerative Ward token pooling for Hopper (sm_90a): the build fast path.
//
// Replaces the TPU kernel src/repro/kernels/ward_pool/kernel.py
// (`ward_merge_block`, inside `_ward_pool_kernel`, dispatched by
// `ward_pool_pallas`): per document, squared distances of the unit token
// vectors, then greedy Ward merges with the Lance-Williams update until
// k = n_valid // factor + 1 clusters remain. Output: each token's cluster
// representative (the lowest token index of its cluster), exactly the
// contract of src/repro/core/ward.py `ward_cluster_batch`.
//
// What bounds it on this card: neither bytes nor FLOPs in the roofline
// sense. Its input is read once (N*d*4 bytes per doc) and the Gram matrix
// is N^2*d multiply-adds, but the merge loop is ~N/2 dependent steps per
// document, each a block-wide argmin over the N(N-1)/2 live pair
// distances plus an O(N) row update: latency of shared-memory scans and
// block barriers.
//
// Design: one block per document, all state in shared memory. At
// N = doc_maxlen = 256 the full f32 [N, N] matrix (256 KiB) exceeds the
// 227 KB a block may hold, so only the strict upper triangle is kept
// (N(N-1)/2 floats: 130,560 B at N = 256, 179,400 B at N = 300 for
// JaColBERT) as dynamic shared memory. The Gram matrix is computed
// in-kernel from [16, d] row tiles staged through shared memory. Each
// merge step is a block-wide argmin over (value, flat triangle index):
// the row-major order of the upper triangle is the row-major order of the
// symmetric full matrix restricted to its first occurrences, so this
// reproduces the reference's argmin(d2.reshape(-1)) tie-break. The
// Lance-Williams update, the +inf propagation and the skipped-merge guard
// follow core/ward.py term for term, with explicitly rounded intrinsics
// so nvcc cannot contract them into FMAs. The Anderberg lazy row minima
// of the TPU kernel are not used: a full scan per step is simpler and the
// scan is cheap in shared memory.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math.h>

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int T = 16;                      // Gram tile rows

__device__ __forceinline__ int row_start(int i, int N) {
  return i * N - (i * (i + 1)) / 2;        // flat index of (i, i + 1)
}

__device__ __forceinline__ int tri_index(int i, int j, int N) {  // i < j
  return row_start(i, N) + (j - i - 1);
}

__device__ __forceinline__ float tri_get(const float* tri, int a, int b,
                                         int N) {
  if (a == b) return INFINITY;
  return a < b ? tri[tri_index(a, b, N)] : tri[tri_index(b, a, N)];
}

__device__ __forceinline__ bool better(float v, int t, float bv, int bt) {
  return v < bv || (v == bv && t < bt);
}

__global__ void __launch_bounds__(THREADS) ward_pool_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ steps_in, int32_t* __restrict__ assign_out,
    int N, int d) {
  extern __shared__ float smem[];
  const int P = N * (N - 1) / 2;
  float* tri = smem;                       // [P] upper-triangle distances
  float* sq = tri + P;                     // [N] squared norms
  float* sizes = sq + N;                   // [N] cluster sizes
  float* newrow = sizes + N;               // [N] merged row
  int* assign = reinterpret_cast<int*>(newrow + N);     // [N]
  float* ta_s = reinterpret_cast<float*>(assign + N);   // [T, d + 1]
  float* tb_s = ta_s + T * (d + 1);                     // [T, d + 1]
  float* redv = tb_s + T * (d + 1);                     // [NWARPS]
  int* redi = reinterpret_cast<int*>(redv + NWARPS);    // [NWARPS]
  int* sel = redi + NWARPS;                             // i, j
  float* selv = reinterpret_cast<float*>(sel + 2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const float* xb = x + (size_t)b * N * d;
  const uint8_t* mb = mask + (size_t)b * N;
  const int steps = steps_in[b];

  for (int i = tid; i < N; i += THREADS) {
    float acc = 0.f;
    for (int e = 0; e < d; ++e)
      acc = __fmaf_rn(xb[(size_t)i * d + e], xb[(size_t)i * d + e], acc);
    sq[i] = acc;
    sizes[i] = mb[i] ? 1.f : 0.f;
    assign[i] = i;
  }
  __syncthreads();

  // squared distances, strict upper triangle, from [T, d] row tiles
  const int nt = (N + T - 1) / T;
  const int ds = d + 1;
  for (int ta = 0; ta < nt; ++ta) {
    for (int idx = tid; idx < T * d; idx += THREADS) {
      const int r = ta * T + idx / d;
      ta_s[(idx / d) * ds + idx % d] = r < N ? xb[(size_t)r * d + idx % d]
                                             : 0.f;
    }
    for (int tb = ta; tb < nt; ++tb) {
      for (int idx = tid; idx < T * d; idx += THREADS) {
        const int r = tb * T + idx / d;
        tb_s[(idx / d) * ds + idx % d] = r < N ? xb[(size_t)r * d + idx % d]
                                               : 0.f;
      }
      __syncthreads();
      if (tid < T * T) {
        const int i = ta * T + tid / T, j = tb * T + tid % T;
        if (i < j && j < N) {
          const float* ra = ta_s + (tid / T) * ds;
          const float* rb = tb_s + (tid % T) * ds;
          float dot = 0.f;
          for (int e = 0; e < d; ++e) dot = __fmaf_rn(ra[e], rb[e], dot);
          float v = __fsub_rn(__fadd_rn(sq[i], sq[j]), __fmul_rn(2.f, dot));
          v = fmaxf(v, 0.f);
          tri[tri_index(i, j, N)] = (mb[i] && mb[j]) ? v : INFINITY;
        }
      }
      __syncthreads();
    }
  }

  // greedy merges; `steps` = n_valid - k merges at most (the n_active > k
  // guard), and an all-inf minimum ends the loop (the isfinite guard):
  // every later step of the reference would be a no-op too
  for (int step = 0; step < steps; ++step) {
    float bv = INFINITY;
    int bt = INT_MAX;
    for (int t = tid; t < P; t += THREADS) {
      const float v = tri[t];
      if (v < bv) { bv = v; bt = t; }      // first occurrence per thread
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int ot = __shfl_xor_sync(0xffffffffu, bt, o);
      if (better(ov, ot, bv, bt)) { bv = ov; bt = ot; }
    }
    if (lane == 0) { redv[warp] = bv; redi[warp] = bt; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < NWARPS ? redv[lane] : INFINITY;
      bt = lane < NWARPS ? redi[lane] : INT_MAX;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int ot = __shfl_xor_sync(0xffffffffu, bt, o);
        if (better(ov, ot, bv, bt)) { bv = ov; bt = ot; }
      }
      if (lane == 0) {
        int i = 0;
        if (isfinite(bv)) {                // row of flat index bt
          int lo = 0, hi = N - 2;
          while (lo < hi) {
            const int mid = (lo + hi + 1) / 2;
            if (row_start(mid, N) <= bt) lo = mid; else hi = mid - 1;
          }
          i = lo;
        }
        sel[0] = i;
        sel[1] = isfinite(bv) ? i + 1 + (bt - row_start(i, N)) : 0;
        *selv = bv;
      }
    }
    __syncthreads();
    const float dij = *selv;
    if (!isfinite(dij)) break;             // uniform: read from shared
    const int i = sel[0], j = sel[1];
    const float si = sizes[i], sj = sizes[j];
    for (int k = tid; k < N; k += THREADS) {
      float nr = INFINITY;
      if (k != i && k != j) {
        const float a = tri_get(tri, i, k, N), c = tri_get(tri, j, k, N);
        if (!isinf(a) && !isinf(c)) {
          const float sc = sizes[k];
          const float num = __fsub_rn(
              __fadd_rn(__fmul_rn(__fadd_rn(si, sc), a),
                        __fmul_rn(__fadd_rn(sj, sc), c)),
              __fmul_rn(sc, dij));
          const float den = fmaxf(__fadd_rn(__fadd_rn(si, sj), sc), 1e-9f);
          nr = __fdiv_rn(num, den);
        }
      }
      newrow[k] = nr;
    }
    __syncthreads();
    for (int k = tid; k < N; k += THREADS) {
      if (k != i && k != j) {
        tri[k < i ? tri_index(k, i, N) : tri_index(i, k, N)] = newrow[k];
        tri[k < j ? tri_index(k, j, N) : tri_index(j, k, N)] = INFINITY;
      } else if (k == j) {
        tri[tri_index(i, j, N)] = INFINITY;
      }
      if (assign[k] == j) assign[k] = i;
    }
    if (tid == 0) {
      sizes[i] = __fadd_rn(si, sj);
      sizes[j] = 0.f;
    }
    __syncthreads();
  }

  for (int i = tid; i < N; i += THREADS) assign_out[(size_t)b * N + i] = assign[i];
}

}  // namespace

extern "C" size_t ward_pool_smem_bytes(int N, int d) {
  return sizeof(float) * ((size_t)N * (N - 1) / 2 + 4 * (size_t)N +
                          2 * (size_t)T * (d + 1) + 2 * NWARPS + 3);
}

// x [B, N, d] f32 unit rows (masked rows zero); mask [B, N] u8;
// steps [B] i32 merge budget max(n_valid - k, 0) -> assign [B, N] i32.
// Returns cudaGetLastError().
extern "C" int ward_pool_launch(const float* x, const uint8_t* mask,
                                const int32_t* steps, int32_t* assign, int B,
                                int N, int d, void* stream) {
  const size_t smem = ward_pool_smem_bytes(N, d);
  cudaFuncSetAttribute(ward_pool_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  if (B > 0)
    ward_pool_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
        x, mask, steps, assign, N, d);
  return (int)cudaGetLastError();
}
