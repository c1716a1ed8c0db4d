// Agglomerative Ward token pooling for Hopper (sm_90a): the build fast path.
//
// Replaces the TPU kernel src/repro/kernels/ward_pool/kernel.py
// (`ward_merge_block`, inside `_ward_pool_kernel`, dispatched by
// `ward_pool_pallas`): per document, the squared norms and Gram matrix of
// the unit token vectors, their squared distances, then greedy Ward merges
// with the Lance-Williams update until k = n_valid // factor + 1 clusters
// remain. Output: each token's cluster representative (the lowest token
// index of its cluster), the contract of core/ward.py `ward_cluster_batch`,
// the plain version.
//
// What bounds it on this card: neither bytes nor FLOPs in the roofline
// sense. The Gram is N^2 d / 2 multiply-adds a document (4.2 M at N = 256,
// d = 128: tens of microseconds of f32 FMA on one SM), but the merges are
// ~N/2 dependent steps, each a chain of shared-memory round trips, warp
// reductions and block barriers: latency. An argmin over all N(N-1)/2 pair
// distances at each step would make a document O(N^3); the lazy row minima
// below make a step O(N).
//
// Design: one block of 256 threads per document.
//
// Gram and distances, in the kernel: [64, 64] tiles of the Gram, each
// thread a 4 x 4 register tile of f32 accumulators fed from 16 token
// dimensions of both tiles' rows staged in shared memory (the next 16
// prefetched into registers while these compute). Every entry is one
// `__fmaf_rn` chain over the token dimensions in ascending order, the
// squared norms included: the diagonal tiles go first and their diagonals
// are the norms. So a token's norm and its dot product with an exact
// duplicate are the same chain, and duplicates are exactly 0 apart. The
// plain version takes its norms from a torch sum and its Gram from
// `torch.bmm`, in other orders: its distances differ in the last bits, and
// among exact duplicates it has near-zeros where the kernel has zeros.
// Assignments are equal where no two merge candidates are that close; on
// exact duplicates both break the zero ties into partitions of equal Ward
// objective (`chip_smoke.py` and the card tests hold it so). The Gram
// stays off the tensor cores: TF32 would change distances in the 11th bit
// and flip near-tie merges. Distances are clamp((sq_i + sq_j) - 2 G, 0),
// +inf unless both tokens are valid, as the plain version forms them.
// Only the strict upper triangle is kept: in shared memory when it fits
// (N <= 330), else in a [B, N(N-1)/2] scratch in device memory that the
// wrapper allocates.
//
// Selection uses Anderberg's lazy row minima, as the TPU kernel does
// (kernel.py:88-155), but held to the plain version's tie-break. lb[r] is a
// lower bound on min_{c > r} D(r, c); col[r] is the first column at it when
// the bound is known exact, else -1 (the row is stale). One warp selects:
// r = the first argmin of lb; if row r is exact, accept (r, col[r]); else
// rescan it, accept if its true minimum equals lb[r], else store the true
// minimum (now exact) and repeat. The accepted pair is the plain version's
// `argmin(d2.reshape(B, -1))`: every row before r has a bound, hence a
// minimum, strictly above lb[r], every row after it a minimum >= lb[r], so
// D(i, j) is the global minimum and r the first row that holds it; its
// first column is then the first occurrence in row-major order of the upper
// triangle, which is the first occurrence in the symmetric matrix too (an
// earlier one below the diagonal would mirror to an earlier row).
//
// Merging (i, j), the thread of each k rewrites D(i, k) by Lance-Williams
// and D(j, k) = +inf. For k < i it lowers lb[k] to the new D(k, i) when that
// is smaller (exact, column i), keeps the row exact on a tie (the first
// column of the two), and marks it stale when its minimum sat at column i or
// j and rose; rows between i and j whose minimum sat at column j go stale.
// Row i's exact new minimum and first column are reduced per warp from the
// entries as they are written; lb[j] = +inf. A stale bound is still a lower
// bound, so every bound stays one under f32 rounding without any
// reducibility argument. Each warp also leaves the first minimum of the
// bounds of its rows, so the selecting warp finds the argmin of lb from
// eight candidates and row i. A merge is O(N) work spread over the block,
// about one rescan of a stale row and two block barriers; warp minima are
// `redux.sync` instructions on order-preserving integer keys. The
// Lance-Williams update, the +inf propagation and the `steps` budget follow
// core/ward.py term for term, with explicitly rounded intrinsics so nvcc
// cannot contract them into FMAs.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_LIMIT = 232448;     // a block's dynamic shared memory
constexpr int TS = 64;                    // Gram tile: TS x TS entries
constexpr int KC = 16;                    // token dimensions staged a step
constexpr int LDT = TS + 4;               // staged row stride (16-byte rows)
constexpr int STAGE = 2 * KC * LDT;       // both tiles' staged rows, floats

// Flat index of D(i, j), i < j, in the packed strict upper triangle
// (contiguous along j).
__device__ __forceinline__ int at(int i, int j, int N) {
  return i * N - (i * (i + 1)) / 2 + (j - i - 1);
}

__device__ __forceinline__ int at_sym(int a, int b, int N) {
  return a < b ? at(a, b, N) : at(b, a, N);
}

struct Best {
  float v;
  int at;
};

// A key whose unsigned order is the float order (no NaN; -0 is made +0
// first, so keys are equal exactly when the floats compare equal).
__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(x, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The first minimum of (v, at) across the warp, on every lane: the least
// value, then the least `at` among the lanes that hold it.
__device__ __forceinline__ Best warp_first_min(float v, int a) {
  const unsigned k = key_of(v);
  const unsigned m = __reduce_min_sync(FULL, k);
  const int at = (int)__reduce_min_sync(FULL, k == m ? (unsigned)a : ~0u);
  return {__uint_as_float((m & 0x80000000u) ? (m & 0x7fffffffu) : ~m), at};
}

// min over c > r of D(r, c) and its first column.
__device__ __forceinline__ Best row_min(const float* tri, int r, int N,
                                        int lane) {
  const int base = at(r, r + 1, N) - (r + 1);  // D(r, c) at base + c
  float v = INFINITY;
  int a = INT_MAX;
  for (int c0 = r + 1 + lane; c0 < N; c0 += 8 * 32) {
    float x[8];                           // eight loads in flight a lane
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + 32 * u;
      x[u] = c < N ? tri[base + c] : INFINITY;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (x[u] < v) {                     // first occurrence on this lane
        v = x[u];
        a = c0 + 32 * u;
      }
  }
  return warp_first_min(v, a);
}

// The first minimum of lb over the rows that warp w updates (k = 32 w +
// lane + THREADS m) into its slot; any warp may compute any w's.
__device__ __forceinline__ void lmin_of_warp(const float* lb, float* lmin_v,
                                             int* lmin_r, int w, int N,
                                             int lane) {
  float v = INFINITY;
  int a = INT_MAX;
  for (int k = 32 * w + lane; k < N; k += THREADS)
    if (lb[k] < v) {
      v = lb[k];
      a = k;
    }
  const Best m = warp_first_min(v, a);
  if (lane == 0) {
    lmin_v[w] = m.v;
    lmin_r[w] = m.at;
  }
  __syncwarp();
}

// The 4 values thread t stages: x[r0 + t / 4][e0 + 4 (t % 4) + u], zeros
// past N or d (a zero term leaves every chain as it is).
__device__ __forceinline__ void fetch(const float* __restrict__ xb, int r0,
                                      int e0, int N, int d, int tid,
                                      float (&v)[4]) {
  const int r = r0 + (tid >> 2), e = e0 + 4 * (tid & 3);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    v[u] = (r < N && e + u < d) ? xb[(size_t)r * d + e + u] : 0.f;
}

// ... into st[e][r], dimension-major, so a thread reads its four rows'
// values of one dimension as one float4.
__device__ __forceinline__ void stage(float* st, const float (&v)[4],
                                      int tid) {
  const int r = tid >> 2, e = 4 * (tid & 3);
#pragma unroll
  for (int u = 0; u < 4; ++u) st[(e + u) * LDT + r] = v[u];
}

// The Gram tiles in order: the diagonal ones first (their diagonals are the
// squared norms every other tile needs), then (ti < tj) row-major.
__device__ __forceinline__ void next_tile(int& ti, int& tj, int nt) {
  if (ti == tj) {
    if (ti + 1 < nt) {
      ++ti;
      ++tj;
    } else {
      ti = 0;
      tj = 1;
    }
  } else if (tj + 1 < nt) {
    ++tj;
  } else {
    ++ti;
    tj = ti + 1;
  }
}

template <bool DEVICE>
__global__ void __launch_bounds__(THREADS) ward_pool_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ mask,
    int factor, float* scratch, int32_t* __restrict__ assign_out, int N,
    int d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  const size_t P = (size_t)N * (N - 1) / 2;
  float* as = smem;                       // [KC][LDT] staged rows, i side
  float* bs = as + KC * LDT;              // [KC][LDT] staged rows, j side
  float* tri = DEVICE ? scratch + (size_t)b * P : smem + STAGE;  // D(i < j)
  float* sizes = DEVICE ? smem + STAGE : tri + P;   // [N]
  float* lb = sizes + N;                  // [N] row lower bounds
  int* col = reinterpret_cast<int*>(lb + N);   // [N] see below
  int* assign = col + N;                  // [N]
  float* sq = reinterpret_cast<float*>(assign);  // [N], until merges start
  // per warp w, over the rows it updates (k = 32 w + lane + THREADS m):
  // the first minimum of lb, and its part of row i's new minimum
  float* lmin_v = reinterpret_cast<float*>(assign + N);  // [NWARPS]
  int* lmin_r = reinterpret_cast<int*>(lmin_v + NWARPS);  // [NWARPS]
  float* slot_v = reinterpret_cast<float*>(lmin_r + NWARPS);  // [NWARPS]
  int* slot_c = reinterpret_cast<int*>(slot_v + NWARPS);  // [NWARPS]
  int* sel = slot_c + NWARPS;             // i, j
  float* selv = reinterpret_cast<float*>(sel + 2);       // D(i, j), si, sj
  // col[r] >= 0: lb[r] is row r's exact minimum and col[r] the first column
  // holding it; col[r] < 0: lb[r] is only a lower bound (the row is stale)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* mb = mask + (size_t)b * N;
  const float* xb = x + (size_t)b * N * d;
  int n_valid = 0;
  for (int i0 = 0; i0 < N; i0 += THREADS) {
    const int i = i0 + tid;
    const bool on = i < N && mb[i];
    if (i < N) sizes[i] = on ? 1.f : 0.f;
    n_valid += __syncthreads_count(on);
  }

  // the Gram, tile by tile and 16 dimensions a step, each entry one
  // ascending __fmaf_rn chain; a tile's last step writes its distances
  const int ty = tid >> 4, tx = tid & 15;  // rows 4 ty.., columns 4 tx..
  const int nt = (N + TS - 1) / TS, nc = (d + KC - 1) / KC;
  const int total = nt * (nt + 1) / 2 * nc;
  int ti = 0, tj = 0, c = 0;
  float va[4], vb[4], acc[4][4] = {};
  fetch(xb, 0, 0, N, d, tid, va);
  fetch(xb, 0, 0, N, d, tid, vb);
  for (int s = 0; s < total; ++s) {
    __syncthreads();                      // the last step's reads are done
    stage(as, va, tid);
    stage(bs, vb, tid);
    __syncthreads();
    int nti = ti, ntj = tj, ncc = c + 1;
    if (ncc == nc) {
      ncc = 0;
      next_tile(nti, ntj, nt);
    }
    if (s + 1 < total) {                  // in flight while these compute
      fetch(xb, nti * TS, ncc * KC, N, d, tid, va);
      fetch(xb, ntj * TS, ncc * KC, N, d, tid, vb);
    }
#pragma unroll
    for (int e = 0; e < KC; ++e) {
      const float4 a4 = *reinterpret_cast<const float4*>(as + e * LDT + 4 * ty);
      const float4 b4 = *reinterpret_cast<const float4*>(bs + e * LDT + 4 * tx);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[r][q] = __fmaf_rn(av[r], bv[q], acc[r][q]);
    }
    if (c == nc - 1) {                    // the tile is done: its distances
      const int i0 = ti * TS + 4 * ty, j0 = tj * TS + 4 * tx;
      if (ti == tj) {                     // uniform: the norms first
        if (tx == ty)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (i0 + r < N) sq[i0 + r] = acc[r][r];
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + q;
          if (j > i && j < N) {
            const float dist = fmaxf(
                __fsub_rn(__fadd_rn(sq[i], sq[j]), __fmul_rn(2.f, acc[r][q])),
                0.f);
            tri[at(i, j, N)] =
                (sizes[i] != 0.f && sizes[j] != 0.f) ? dist : INFINITY;
          }
          acc[r][q] = 0.f;
        }
      }
    }
    ti = nti;
    tj = ntj;
    c = ncc;
  }
  __syncthreads();
  // each row's exact minimum and first column
  for (int r = warp; r < N; r += NWARPS) {
    const Best m = row_min(tri, r, N, lane);
    if (lane == 0) {
      lb[r] = m.v;
      col[r] = m.at;
    }
  }
  __syncthreads();
  for (int k = tid; k < N; k += THREADS) assign[k] = k;   // sq is done
  lmin_of_warp(lb, lmin_v, lmin_r, warp, N, lane);
  __syncthreads();

  // greedy merges down to k = n_valid // factor + 1 clusters: `steps` =
  // max(n_valid - k, 0) merges at most (`ward_targets`; the n_active > k
  // guard), and an all-inf minimum ends the loop (the isfinite guard):
  // every later step of the reference would be a no-op too
  const int steps = max(n_valid - max(n_valid / factor + 1, 1), 0);
  int prev = -1;                          // the row merged into last step
  for (int step = 0; step < steps; ++step) {
    if (warp == 0) {
      if (prev >= 0) {                    // row prev's exact new minimum
        const Best m = warp_first_min(lane < NWARPS ? slot_v[lane] : INFINITY,
                                      lane < NWARPS ? slot_c[lane] : INT_MAX);
        if (lane == 0) {
          lb[prev] = m.v;
          col[prev] = m.at;
        }
        __syncwarp();
      }
      // the first argmin r of lb, from the warps' minima and row prev (left
      // out of them); accept it if the row is exact or its rescanned
      // minimum equals the bound, else tighten it and repeat
      float dv = INFINITY;
      int si = 0, sj = 0;
      for (;;) {
        const bool extra = lane == NWARPS && prev >= 0;
        const Best A = warp_first_min(
            lane < NWARPS ? lmin_v[lane] : extra ? lb[prev] : INFINITY,
            lane < NWARPS ? lmin_r[lane] : extra ? prev : INT_MAX);
        if (!(A.v < INFINITY)) break;     // no finite pair is left
        const int c = col[A.at];
        if (c >= 0) {                     // exact: accept without a scan
          dv = A.v;
          si = A.at;
          sj = c;
          break;
        }
        const Best rm = row_min(tri, A.at, N, lane);
        if (rm.v == A.v) {
          dv = A.v;
          si = A.at;
          sj = rm.at;
          break;
        }
        if (lane == 0) {                  // the bound was stale: tighten it
          lb[A.at] = rm.v;
          col[A.at] = rm.at;
        }
        __syncwarp();
        lmin_of_warp(lb, lmin_v, lmin_r, (A.at % THREADS) / 32, N, lane);
      }
      if (lane == 0) {
        sel[0] = si;
        sel[1] = sj;
        selv[0] = dv;
        selv[1] = sizes[si];
        selv[2] = sizes[sj];
      }
    }
    __syncthreads();
    const float dij = selv[0];
    if (!(dij < INFINITY)) break;         // uniform: read from shared
    const int i = sel[0], j = sel[1];
    const float si = selv[1], sj = selv[2];
    // thread k owns the entries (i, k), (j, k) and row k's bound; for
    // k > i its new entry is one of row i's, whose minimum each warp reduces
    float ri = INFINITY;
    int rc = INT_MAX;
    for (int k = tid; k < N; k += THREADS) {
      if (k != i && k != j) {
        const int ik = at_sym(i, k, N), jk = at_sym(j, k, N);
        const float a = tri[ik], c = tri[jk];
        float nr = INFINITY;
        if (!isinf(a) && !isinf(c)) {
          const float sc = sizes[k];
          const float num = __fsub_rn(
              __fadd_rn(__fmul_rn(__fadd_rn(si, sc), a),
                        __fmul_rn(__fadd_rn(sj, sc), c)),
              __fmul_rn(sc, dij));
          const float den = fmaxf(__fadd_rn(__fadd_rn(si, sj), sc), 1e-9f);
          nr = __fdiv_rn(num, den);
        }
        tri[ik] = nr;
        tri[jk] = INFINITY;
        if (k < i) {                      // row k: (k, i) = nr, (k, j) = +inf
          const float L = lb[k];
          const int C = col[k];
          if (nr < L) {                   // a strict new minimum
            lb[k] = nr;
            col[k] = i;
          } else if (nr == L) {
            if (C >= 0) col[k] = min(C, i);
          } else if (C == i || C == j) {
            col[k] = -1;                  // its minimum rose: stale
          }
        } else {
          if (k < j && col[k] == j) col[k] = -1;   // row k: (k, j) = +inf
          if (nr < ri) {                  // row i, increasing k
            ri = nr;
            rc = k;
          }
        }
      } else {                            // row j is all +inf now; row i
        lb[k] = INFINITY;                 // is set at the next selection
        col[k] = INT_MAX;
      }
      if (assign[k] == j) assign[k] = i;
    }
    const Best m = warp_first_min(ri, rc);
    if (lane == 0) {
      slot_v[warp] = m.v;
      slot_c[warp] = m.at;
    }
    lmin_of_warp(lb, lmin_v, lmin_r, warp, N, lane);
    if (tid == 0) {
      tri[at(i, j, N)] = INFINITY;
      sizes[i] = __fadd_rn(si, sj);
      sizes[j] = 0.f;
    }
    __syncthreads();
    prev = i;
  }

  for (int k = tid; k < N; k += THREADS)
    assign_out[(size_t)b * N + k] = assign[k];
}

size_t smem_bytes(int N, bool device) {
  const size_t tri = device ? 0 : (size_t)N * (N - 1) / 2;
  return sizeof(float) * (STAGE + tri + 4 * (size_t)N + 4 * NWARPS + 5);
}

bool in_shared(int N) { return smem_bytes(N, false) <= SMEM_LIMIT; }

}  // namespace

// Floats of device-memory scratch a launch at N needs per document: 0 when
// the distance triangle fits in shared memory (N <= 330), else N(N-1)/2.
extern "C" size_t ward_pool_scratch_floats(int N) {
  return in_shared(N) ? 0 : (size_t)N * (N - 1) / 2;
}

// x [B, N, d] f32 unit rows (masked rows zero); mask [B, N] u8; factor >= 1;
// scratch [B, ward_pool_scratch_floats(N)] f32 (null when that is 0) ->
// assign [B, N] i32. N * N < 2^31, d >= 1. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int ward_pool_launch(const float* x, const uint8_t* mask,
                                int factor, float* scratch, int32_t* assign,
                                int B, int N, int d, void* stream) {
  if (B < 0 || N < 0 || (long long)N * N >= (1LL << 31) || factor < 1 ||
      d < 1)
    return (int)cudaErrorInvalidValue;
  const bool shared = in_shared(N);
  const size_t smem = smem_bytes(N, !shared);
  if (smem > SMEM_LIMIT || (!shared && B > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(shared ? ward_pool_kernel<false> : ward_pool_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (B > 0 && N > 0) {
    if (shared)
      ward_pool_kernel<false><<<B, THREADS, smem, (cudaStream_t)stream>>>(
          x, mask, factor, scratch, assign, N, d);
    else
      ward_pool_kernel<true><<<B, THREADS, smem, (cudaStream_t)stream>>>(
          x, mask, factor, scratch, assign, N, d);
  }
  return (int)cudaGetLastError();
}
