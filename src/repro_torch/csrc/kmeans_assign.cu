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
// What bounds it on this card: bytes. The products run on the tensor cores
// as 3xTF32 (tf32.cuh: f32's accuracy, three TF32 passes): at the pooling
// shapes (B = 128, N = 256, K = 129, dim = 128) they take ~7 us at the TF32
// peak, while x and the centroids (~25 MB) take ~7.6 us to read at
// 3.35 TB/s.
//
// Design: one block per (document, ROWS = 256 rows), 8 warps.
// - The document's centroids are staged once a block (for K above the
//   pass width, once a pass of that many columns) by 16-byte cp.async,
//   then split in place into TF32 hi and lo planes, rows padded to dim + 4
//   (the B-fragment reads of 8 rows x 4 columns hit 32 distinct banks). K
//   is padded only to the mma's n-tile of 8: 136 columns for 129.
// - Each warp owns two row tiles of 16 rows. Its A fragments are read
//   from device memory straight into registers, PF = 8 k-steps ahead of
//   their use (across tiles and passes), and split there.
// - Products: per k-step of 8, every n-tile of the pass takes three
//   `mma.sync.m16n8k8` TF32 (lo.hi + hi.lo + hi.hi) into f32 accumulators,
//   NG = 6 n-tiles at a time, each pass over all six before the next (a
//   warp issues in order; the passes on one accumulator depend on each
//   other). At the model's width (128, compiled in) a pass always stages and
//   multiplies 17 n-tiles (zeros past K), so this loop has no branch: a
//   branch there cuts the warp's instructions into blocks the compiler
//   cannot interleave, and the tensor cores wait on each mma's latency.
// - The assignment comes from the accumulators: a column masked by k_mask
//   is -inf, a padding column is skipped; each thread keeps (value, index)
//   for its two rows, the larger value winning and, among equal values,
//   the smaller index (`better`); the four lanes of a row reduce with
//   shuffles. A row belongs to one warp, so no reduction crosses warps.
#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "tf32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int TILES = 2;                         // row tiles of 16 a warp
constexpr int ROWS = 16 * TILES * NWARPS;        // 256 rows a block
constexpr int KCH = 128;                         // dims a work item covers
constexpr int KSTEPS = KCH / 8;                  // its k-steps of 8
constexpr int NT_PASS = 17;                      // n-tiles a pass: 136 cols
constexpr int PF = 8;                            // k-steps of x in flight
constexpr int NG = 6;                            // n-tiles a product group
constexpr int MAX_SMEM = 232448;                 // dynamic shared memory
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ bool better(float s, int k, float best, int idx) {
  return s > best || (s == best && k < idx);
}

__host__ __device__ constexpr size_t col_bytes(int dim) {
  return 2 * sizeof(uint32_t) * (size_t)(dim + 4) + sizeof(int);
}

// Columns staged a pass at this dim: at most NT_PASS n-tiles, and as many
// n-tiles as shared memory holds.
__host__ __device__ constexpr int pass_cols(int dim) {
  return (int)(MAX_SMEM / col_bytes(dim) / 8 * 8) < 8 * NT_PASS
             ? (int)(MAX_SMEM / col_bytes(dim) / 8 * 8)
             : 8 * NT_PASS;
}

// x [B, N, dim], dim a multiple of 8 with 16-byte aligned rows; pcols the
// staged columns a pass (a multiple of 8). DIM: the token width when known
// at compile time (the model's 128: every pass stages NT_PASS n-tiles,
// zero past K, and the product loop has no branch); 0 takes it at run time.
template <int DIM>
__global__ void __launch_bounds__(THREADS, 1) kmeans_assign_kernel(
    const float* __restrict__ x, const float* __restrict__ centroids,
    const uint8_t* __restrict__ kmask, int32_t* __restrict__ assign,
    float* __restrict__ best_out, int N, int K, int width, int pcols,
    int b0) {
  const int dim = DIM > 0 ? DIM : width;
  extern __shared__ int4 smem4[];
  const int DS = dim + 4;
  uint32_t* chi = reinterpret_cast<uint32_t*>(smem4);     // [pcols][DS]
  uint32_t* clo = chi + (size_t)pcols * DS;               // [pcols][DS]
  int* km = reinterpret_cast<int*>(clo + (size_t)pcols * DS);   // [pcols]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = b0 + blockIdx.y;
  const int wrow = blockIdx.x * ROWS + warp * 16 * TILES;  // warp's first row
  const float* xb = x + (size_t)b * N * dim;
  const float* cb = centroids + (size_t)b * K * dim;
  const uint8_t* kb = kmask + (size_t)b * K;

  // The warp's work is a stream of k-steps: for each item (row tile,
  // chunk of KCH dims; the same items in every pass) KSTEPS steps of 8
  // dims. x's values of step z sit in ring slot z % PF, loaded PF steps
  // ahead, so a tile's loads fly while the previous steps multiply.
  const int ntile = min(TILES, max(0, (N - wrow + 15) / 16));
  const int nch = (dim + KCH - 1) / KCH;
  const int items = ntile * nch;
  const int npass = (K + pcols - 1) / pcols;
  const int nsteps = npass * items * KSTEPS;  // the whole stream
  float a[PF][4];
  auto load = [&](int z, int slot) {          // stream step z -> a[slot]
    if (z >= nsteps) return;
    const int it = (z / KSTEPS) % items, s = z % KSTEPS;
    const int r = wrow + 16 * (it / nch) + g;
    const int k = (it % nch) * KCH + 8 * s + t;
    const bool in = k < dim;
    a[slot][0] = in && r < N ? __ldg(xb + (size_t)r * dim + k) : 0.f;
    a[slot][1] = in && r + 8 < N ? __ldg(xb + (size_t)(r + 8) * dim + k)
                                 : 0.f;
    a[slot][2] = in && r < N ? __ldg(xb + (size_t)r * dim + k + 4) : 0.f;
    a[slot][3] = in && r + 8 < N ? __ldg(xb + (size_t)(r + 8) * dim + k + 4)
                                 : 0.f;
  };
#pragma unroll
  for (int z = 0; z < PF; ++z) load(z, z);

  float best[TILES][2];
  int idx[TILES][2];
#pragma unroll
  for (int i = 0; i < TILES; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[i][h] = -INFINITY;
      idx[i][h] = K;                         // sentinel above every index
    }

  const int dim4 = dim >> 2;
  int z0 = 0;                                // the stream's next step
  for (int p = 0; p < npass; ++p) {
    const int c0 = p * pcols;
    const int nc = min(pcols, K - c0);
    // n-tiles staged and multiplied: all NT_PASS at the compiled width
    const int ntiles = DIM > 0 ? NT_PASS : (nc + 7) / 8;
    __syncthreads();                         // the last pass is read
    // 1. the pass's centroids: 16-byte copies, then each thread splits the
    // chunks it copied in place (hi plane) and into the lo plane; columns
    // past K are zero
    for (int i = tid; i < ntiles * 8 * dim4; i += THREADS) {
      const int r = i / dim4, e = 4 * (i % dim4);
      uint32_t* dst = chi + r * DS + e;
      if (r < nc)
        cp_async16(dst, cb + (size_t)(c0 + r) * dim + e);
      else
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
    cp_async_commit();
    cp_async_wait_all();
    for (int i = tid; i < ntiles * 8 * dim4; i += THREADS) {
      const int r = i / dim4, e = 4 * (i % dim4);
      uint32_t* hi = chi + r * DS + e;
      uint32_t* lo = clo + r * DS + e;
#pragma unroll
      for (int j = 0; j < 4; ++j) tf32_split(__uint_as_float(hi[j]), hi[j],
                                             lo[j]);
    }
    if (tid < ntiles * 8) km[tid] = tid < nc && kb[c0 + tid];
    __syncthreads();

    // 2. the warp's items against the pass's columns; a tile's sums run
    // on over its chunks
    float acc[NT_PASS][4];
    for (int it = 0; it < items; ++it, z0 += KSTEPS) {
      const int tile = it / nch, ch = it % nch;
      if (ch == 0) {
#pragma unroll
        for (int n = 0; n < NT_PASS; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        const int k0 = ch * KCH + 8 * s;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          tf32_split(a[s % PF][r], ah[r], al[r]);
        load(z0 + s + PF, s % PF);
        if (DIM == 0 && k0 >= dim) continue;   // warp-uniform
        const uint32_t* hp = chi + g * DS + k0 + t;
        const uint32_t* lp = clo + g * DS + k0 + t;
        // NG n-tiles at a time, each of the three passes over all of them
        // before the next (the passes on one accumulator depend on each
        // other; a warp issues in order)
#pragma unroll
        for (int n0 = 0; n0 < NT_PASS; n0 += NG) {
          uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            const int o = 8 * (n0 + j) * DS;
            if (n0 + j < NT_PASS && (DIM > 0 || n0 + j < ntiles)) {
              bh[j][0] = hp[o];
              bh[j][1] = hp[o + 4];
              bl[j][0] = lp[o];
              bl[j][1] = lp[o + 4];
            }
          }
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int j = 0; j < NG; ++j)
              if (n0 + j < NT_PASS && (DIM > 0 || n0 + j < ntiles)) {
                float (&c)[4] = acc[n0 + j];
                if (pass == 0) mma_tf32(c, al, bh[j][0], bh[j][1]);
                if (pass == 1) mma_tf32(c, ah, bl[j][0], bl[j][1]);
                if (pass == 2) mma_tf32(c, ah, bh[j][0], bh[j][1]);
              }
        }
      }
      // 3. a tile's last chunk: fold its columns into (best, index)
      if (ch == nch - 1) {
#pragma unroll
        for (int i = 0; i < TILES; ++i) {
          if (i != tile) continue;
#pragma unroll
          for (int n = 0; n < NT_PASS; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = 8 * n + 2 * t + h;
              if (col < nc) {
                const bool on = km[col] != 0;
                const int k = c0 + col;
#pragma unroll
                for (int u = 0; u < 2; ++u) {  // rows g, g + 8
                  const float v = on ? acc[n][2 * u + h] : -INFINITY;
                  if (better(v, k, best[i][u], idx[i][u])) {
                    best[i][u] = v;
                    idx[i][u] = k;
                  }
                }
              }
            }
        }
      }
    }
  }

  // 4. the four lanes of a row (t = 0..3) reduce; lane t = 0 writes
#pragma unroll
  for (int i = 0; i < TILES; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float bv = best[i][u];
      int bi = idx[i][u];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      const int r = wrow + 16 * i + 8 * u + g;
      if (t == 0 && i < ntile && r < N) {
        const size_t o = (size_t)b * N + r;
        assign[o] = (bi >= K) ? 0 : bi;      // K == 0: nothing to pick
        best_out[o] = bv;
      }
    }
}

template <int DIM>
int launch(const float* x, const float* centroids, const uint8_t* kmask,
           int32_t* assign, float* best, int B, int N, int K, int dim,
           cudaStream_t stream) {
  // the columns a pass stages: the full pass at the compiled width, else
  // the pass width or K rounded up to 8
  const int full = pass_cols(dim);
  const int pc = DIM > 0 ? full : max(8, min(full, (K + 7) / 8 * 8));
  const size_t smem = col_bytes(dim) * pc;
  cudaFuncSetAttribute(kmeans_assign_kernel<DIM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int tiles = (N + ROWS - 1) / ROWS;
  for (int b0 = 0; b0 < B && tiles > 0; b0 += MAX_GRID_Y) {
    dim3 grid(tiles, min(MAX_GRID_Y, B - b0));
    kmeans_assign_kernel<DIM><<<grid, THREADS, smem, stream>>>(
        x, centroids, kmask, assign, best, N, K, dim, pc, b0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a launch takes at this dim, at most (at most
// MAX_SMEM up to dim ~3,600; the wrapper raises above it).
extern "C" size_t kmeans_assign_smem_bytes(int dim) {
  const int pc = pass_cols(dim);
  return pc < 8 ? (size_t)MAX_SMEM + 1 : col_bytes(dim) * pc;
}

// x [B, N, dim] f32; centroids [B, K, dim] f32; kmask [B, K] u8 ->
// assign [B, N] i32, best [B, N] f32. dim a multiple of 8, x and centroids
// 16-byte aligned. Returns cudaGetLastError() (cudaErrorInvalidValue for
// another dim).
extern "C" int kmeans_assign_launch(const float* x, const float* centroids,
                                    const uint8_t* kmask, int32_t* assign,
                                    float* best, int B, int N, int K,
                                    int dim, void* stream) {
  if (dim <= 0 || dim % 8 != 0 || pass_cols(dim) < 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dim == KCH ? launch<KCH>(x, centroids, kmask, assign, best, B, N,
                                  K, dim, s)
                    : launch<0>(x, centroids, kmask, assign, best, B, N, K,
                                dim, s);
}
